"""Fill-reducing orderings for block-arrowhead matrices (paper §III-A).

Implements the three families the paper analyses — RCM, AMD, and Nested
Dissection — plus the paper's two structure-aware twists:

  * **partial** orderings that permute only the banded diagonal part and
    leave the dense arrowhead region untouched (Fig. 3: excluding the orange
    region cut fill-in by ~32.7% on their Matrix B);
  * the **adaptive ND** of §III-A: separator size = bandwidth (+ arrow
    columns), separator moved to the *end* of the matrix, preserving the
    arrowhead shape while exposing independent partitions (Fig. 4).

All orderings are evaluated with the paper's acceptance rule: "the number of
fill-ins is evaluated before and after the ordering; if there is no
improvement, the method is not used."
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import scipy.sparse as sp
from scipy.sparse import csgraph

from .structure import ArrowheadStructure, TileGrid, measure_arrowhead, tile_pattern_from_coo

__all__ = [
    "OrderingResult",
    "PartitionPlan",
    "rcm_ordering",
    "amd_ordering",
    "adaptive_nd_ordering",
    "metis_like_nd_ordering",
    "best_ordering",
    "apply_permutation",
    "tile_fill_in",
    "detect_partition_plan",
    "partition_plan_from_ordering",
]


@dataclasses.dataclass
class OrderingResult:
    name: str
    perm: np.ndarray            # new_index -> old_index
    fill_before: int
    fill_after: int
    accepted: bool
    partitions: Optional[np.ndarray] = None  # ND only: partition id per new index

    @property
    def improvement(self) -> float:
        if self.fill_before == 0:
            return 0.0
        return 1.0 - self.fill_after / max(1, self.fill_before)


@dataclasses.dataclass(frozen=True)
class PartitionPlan:
    """Tile-level partition layout of a block-separable band.

    Under the adaptive-ND ordering the band's independent partitions are
    contiguous runs of diagonal tiles with *no* band tile crossing a
    partition boundary (the separator's couplings moved to the trailing
    arrow/corner block).  The plan records those runs:

      boundaries: strictly increasing tile indices ``(0, c_1, ..., ndt)``
        — partition ``p`` owns diagonal tiles ``[boundaries[p],
        boundaries[p+1])``.
      sep_tiles: how many trailing arrow tiles are the moved separator
        (informational — the separator factorizes with the corner either
        way; benches fold it into the critical-path accounting).

    Frozen and hashable: a plan is a *static* compile-time argument — the
    partitioned sweep's grid shape is ``(n_partitions, max_tiles)`` — and
    rides :class:`~repro.core.options.SolverOptions` into the batching
    compile-cache keys.
    """

    boundaries: Tuple[int, ...]
    sep_tiles: int = 0

    def __post_init__(self):
        b = tuple(int(x) for x in self.boundaries)
        object.__setattr__(self, "boundaries", b)
        if len(b) < 2:
            raise ValueError(
                f"PartitionPlan needs >= 2 boundaries (got {b!r})")
        if b[0] != 0:
            raise ValueError(f"boundaries must start at 0, got {b!r}")
        if any(b[i + 1] <= b[i] for i in range(len(b) - 1)):
            raise ValueError(
                f"boundaries must be strictly increasing, got {b!r}")
        if self.sep_tiles < 0:
            raise ValueError(f"sep_tiles must be >= 0, got {self.sep_tiles}")

    @property
    def n_partitions(self) -> int:
        return len(self.boundaries) - 1

    @property
    def n_tiles(self) -> int:
        """Total diagonal tiles covered (= the grid's ``n_diag_tiles``)."""
        return self.boundaries[-1]

    @property
    def sizes(self) -> Tuple[int, ...]:
        return tuple(self.boundaries[i + 1] - self.boundaries[i]
                     for i in range(self.n_partitions))

    @property
    def max_tiles(self) -> int:
        """The partitioned sweep's sequential-grid depth: the critical
        path drops from O(ndt) to O(max partition tiles)."""
        return max(self.sizes)

    @classmethod
    def trivial(cls, n_tiles: int) -> "PartitionPlan":
        """The single-partition plan covering ``n_tiles`` diagonal tiles —
        semantically 'no partitioning'; dispatch keeps the plain fused
        sweep for it, bit-for-bit."""
        return cls(boundaries=(0, max(int(n_tiles), 1)))

    def shifted(self, pad: int) -> "PartitionPlan":
        """The plan after a canonical-grid embedding prepends ``pad``
        identity tiles (``core/gridpolicy.py``): the identity prefix is
        decoupled from everything, so it joins partition 0.  ``pad`` is
        static — one compilation per (canonical rung, pad depth) when a
        plan rides the policy path, vs one per rung without a plan."""
        pad = int(pad)
        if pad < 0:
            raise ValueError(f"pad must be >= 0, got {pad}")
        if pad == 0:
            return self
        return PartitionPlan(
            boundaries=(0,) + tuple(b + pad for b in self.boundaries[1:]),
            sep_tiles=self.sep_tiles)


# ---------------------------------------------------------------------------
# Fill-in evaluation (tile level — what sTiles actually allocates)
# ---------------------------------------------------------------------------

def _symbolic_elimination_tiles(tile_lower: np.ndarray) -> np.ndarray:
    """Tile-level symbolic Cholesky: returns the L tile pattern.

    Classic column elimination on the (small) tile graph: eliminating column
    k joins all its below-diagonal neighbours into a clique — restricted to
    the standard quotient-graph shortcut of only linking to the first
    neighbour's column (etree-based transitive reduction would be cheaper;
    tile counts are small so direct set propagation is fine).
    """
    nt = tile_lower.shape[0]
    patt = [set(np.nonzero(tile_lower[:, k])[0][np.nonzero(tile_lower[:, k])[0] > k])
            for k in range(nt)]
    for k in range(nt):
        nbrs = sorted(patt[k])
        if not nbrs:
            continue
        p = nbrs[0]  # etree parent: fill propagates to parent column
        patt[p].update(x for x in nbrs if x > p)
    L = np.zeros_like(tile_lower)
    for k in range(nt):
        L[k, k] = True
        for r in patt[k]:
            L[r, k] = True
    return L


def tile_fill_in(pattern: sp.spmatrix, structure: ArrowheadStructure, t: int,
                 total: bool = False) -> int:
    """Fill tiles created by factorization (|L_tiles| - |A_tiles|), or with
    ``total=True`` the factor's allocated tile count |L_tiles| — the quantity
    that decides storage and FLOPs (a scrambled matrix has *few* fill tiles
    because every tile is already dirty; |L| exposes that)."""
    grid = TileGrid(structure, t)
    a_tiles = tile_pattern_from_coo(pattern, grid)
    l_tiles = _symbolic_elimination_tiles(a_tiles)
    if total:
        return int(l_tiles.sum())
    return int(l_tiles.sum() - a_tiles.sum())


# ---------------------------------------------------------------------------
# Orderings
# ---------------------------------------------------------------------------

def _partial_wrap(perm_diag: np.ndarray, n: int, nd: int) -> np.ndarray:
    """Extend a permutation of the diagonal part with identity on the arrow."""
    perm = np.empty(n, dtype=np.int64)
    perm[:nd] = perm_diag
    perm[nd:] = np.arange(nd, n)
    return perm


def rcm_ordering(pattern: sp.spmatrix, structure: ArrowheadStructure,
                 partial: bool = True) -> np.ndarray:
    """(Partial) Reverse Cuthill-McKee.

    ``partial=True`` is the paper's recommended variant: RCM runs on the
    banded diagonal part only, the arrowhead block keeps its position.
    """
    n, nd = structure.n, structure.n_diag
    csr = sp.csr_matrix(pattern)
    if partial and structure.arrow > 0:
        sub = csr[:nd, :nd]
        perm_diag = np.asarray(csgraph.reverse_cuthill_mckee(sub, symmetric_mode=True),
                               dtype=np.int64)
        return _partial_wrap(perm_diag, n, nd)
    return np.asarray(csgraph.reverse_cuthill_mckee(csr, symmetric_mode=True), dtype=np.int64)


def amd_ordering(pattern: sp.spmatrix, structure: ArrowheadStructure,
                 partial: bool = True) -> np.ndarray:
    """Approximate minimum degree (simplified quotient-graph AMD).

    Selects the node of (approximate) least external degree, eliminates it,
    and represents the resulting clique implicitly through element lists —
    the same mechanism AMD [Amestoy/Davis/Duff] uses, without supervariable
    detection (adequate for the moderate graph sizes sTiles preprocesses).
    """
    n, nd = structure.n, structure.n_diag
    csr = sp.csr_matrix(pattern)
    target = csr[:nd, :nd] if (partial and structure.arrow > 0) else csr
    m = target.shape[0]

    adj: list = [set(target.indices[target.indptr[i]:target.indptr[i + 1]]) - {i}
                 for i in range(m)]
    elements: list = [set() for _ in range(m)]  # elements adjacent to each var
    elem_members: Dict[int, set] = {}
    alive = np.ones(m, dtype=bool)
    degree = np.array([len(a) for a in adj], dtype=np.int64)
    order = np.empty(m, dtype=np.int64)

    import heapq
    heap = [(int(degree[i]), i) for i in range(m)]
    heapq.heapify(heap)
    stamp = 0
    for pos in range(m):
        while True:
            d, v = heapq.heappop(heap)
            if alive[v] and d == degree[v]:
                break
        order[pos] = v
        alive[v] = False
        # Build the new element (clique) = adj(v) U members of v's elements.
        clique = set(x for x in adj[v] if alive[x])
        for e in elements[v]:
            clique.update(x for x in elem_members[e] if alive[x])
        clique.discard(v)
        eid = stamp
        stamp += 1
        elem_members[eid] = clique
        for u in clique:
            adj[u].discard(v)
            elements[u] -= elements[v]
            elements[u].add(eid)
            # approximate degree: |adj| + sum of element sizes (upper bound)
            degree[u] = len([x for x in adj[u] if alive[x]]) + sum(
                len(elem_members[e]) for e in elements[u])
            heapq.heappush(heap, (int(degree[u]), u))
        for e in elements[v]:
            elem_members[e].discard(v)

    if partial and structure.arrow > 0:
        return _partial_wrap(order, n, nd)
    return order


def adaptive_nd_ordering(pattern: sp.spmatrix, structure: ArrowheadStructure,
                         n_parts: int = 2) -> OrderingResult:
    """The paper's adaptive nested dissection (§III-A, Fig. 4).

    1. The separator size equals the bandwidth (arrow columns are already at
       the end and act as a global separator).
    2. The separator — the ``bandwidth`` columns straddling each partition
       boundary — is moved towards the end of the matrix, preserving the
       arrowhead shape and leaving ``n_parts`` independent diagonal
       partitions.
    """
    n, nd, bw = structure.n, structure.n_diag, structure.bandwidth
    if n_parts < 2 or nd <= n_parts * (bw + 1):
        ident = np.arange(n, dtype=np.int64)
        return OrderingResult("adaptive_nd", ident, 0, 0, accepted=False)

    cuts = [round(nd * p / n_parts) for p in range(1, n_parts)]
    sep_mask = np.zeros(nd, dtype=bool)
    for c in cuts:
        lo, hi = max(0, c - (bw + 1) // 2), min(nd, c + (bw + 1) // 2)
        sep_mask[lo:hi] = True

    part_idx = np.nonzero(~sep_mask)[0]
    sep_idx = np.nonzero(sep_mask)[0]
    perm = np.concatenate([part_idx, sep_idx, np.arange(nd, n)]).astype(np.int64)

    # partition ids in the *new* ordering (for distributed factorization)
    parts = np.full(n, -1, dtype=np.int64)
    bounds = [0] + cuts + [nd]
    pid_of_old = np.zeros(nd, dtype=np.int64)
    for p in range(n_parts):
        pid_of_old[bounds[p]:bounds[p + 1]] = p
    parts[:len(part_idx)] = pid_of_old[part_idx]
    return OrderingResult("adaptive_nd", perm, 0, 0, accepted=True, partitions=parts)


def metis_like_nd_ordering(pattern: sp.spmatrix, structure: ArrowheadStructure,
                           levels: int = 2) -> np.ndarray:
    """Generic (METIS-style) recursive nested dissection via spectral-free
    BFS bisection, used as the baseline ND the paper compares against.

    Recursively: pick a pseudo-peripheral node, BFS-level the graph, take the
    median level as separator, recurse on the two halves, emit
    [left, right, separator].
    """
    csr = sp.csr_matrix(pattern)
    n = csr.shape[0]

    def dissect(nodes: np.ndarray, depth: int) -> np.ndarray:
        if depth == 0 or len(nodes) < 32:
            return nodes
        sub = csr[nodes][:, nodes]
        order = np.asarray(csgraph.reverse_cuthill_mckee(sub, symmetric_mode=True))
        # BFS-levelled order: separator = middle slice of width ~ sqrt degree
        mid = len(nodes) // 2
        width = max(1, int(np.sqrt(sub.nnz / max(1, len(nodes)))) * 4)
        lo, hi = max(0, mid - width), min(len(nodes), mid + width)
        left, sep, right = order[:lo], order[lo:hi], order[hi:]
        return np.concatenate([
            dissect(nodes[left], depth - 1),
            dissect(nodes[right], depth - 1),
            nodes[sep],
        ])

    return dissect(np.arange(n, dtype=np.int64), levels)


def apply_permutation(mat: sp.spmatrix, perm: np.ndarray) -> sp.csc_matrix:
    """Symmetric permutation P A P^T with perm[new] = old."""
    csr = sp.csc_matrix(mat)
    return sp.csc_matrix(csr[perm][:, perm])


# ---------------------------------------------------------------------------
# Ordering selection (paper's acceptance rule + per-structure guidance)
# ---------------------------------------------------------------------------

_CANDIDATES: Dict[str, Callable] = {
    "partial_rcm": lambda A, s: rcm_ordering(A, s, partial=True),
    "rcm": lambda A, s: rcm_ordering(A, s, partial=False),
    "partial_amd": lambda A, s: amd_ordering(A, s, partial=True),
}


def best_ordering(pattern: sp.spmatrix, structure: ArrowheadStructure, t: int,
                  candidates=None) -> OrderingResult:
    """Try candidate orderings; keep the best; reject if no fill improvement.

    Implements the paper's guidance table: partial RCM preferred for
    band-narrowing, AMD for irregular patterns, adaptive ND handled
    separately (it optimizes parallelism, not fill).
    """
    base_fill = tile_fill_in(pattern, structure, t, total=True)
    best_name, best_perm, best_fill = "identity", np.arange(structure.n, dtype=np.int64), base_fill
    for name in (candidates or _CANDIDATES):
        perm = _CANDIDATES[name](pattern, structure)
        permuted = apply_permutation(pattern, perm)
        new_struct = measure_arrowhead(permuted, arrow_hint=structure.arrow)
        fill = tile_fill_in(permuted, new_struct, t, total=True)
        if fill < best_fill:
            best_name, best_perm, best_fill = name, perm, fill
    return OrderingResult(best_name, best_perm, base_fill, best_fill,
                          accepted=best_name != "identity")


# ---------------------------------------------------------------------------
# Partition-plan extraction (the partitioned fused sweep's static input)
# ---------------------------------------------------------------------------

def detect_partition_plan(pattern: sp.spmatrix, structure: ArrowheadStructure,
                          t: int, min_tiles: int = 1,
                          sep_tiles: Optional[int] = None) -> PartitionPlan:
    """Find the independent band partitions of an (already ordered) matrix.

    A cut between diagonal tiles ``c-1`` and ``c`` is valid iff every band
    tile crossing it is structurally zero — then columns left and right of
    the cut never exchange data through the band (the arrow/corner, where
    an adaptive-ND separator lives, couples them only *after* the band
    sweep).  Scans the tile pattern for all valid cuts, keeps those
    leaving at least ``min_tiles`` tiles per partition, and returns the
    resulting :class:`PartitionPlan` (trivial when no cut exists — e.g. a
    plain arrowhead matrix, which dispatch then factorizes exactly as
    before).

    ``sep_tiles`` defaults to the structure's arrow tile count — under the
    paper's adaptive ND the moved separator *is* the trailing block.
    """
    grid = TileGrid(structure, t)
    tiles = tile_pattern_from_coo(pattern, grid)
    ndt, bt = grid.n_diag_tiles, grid.band_tiles
    if sep_tiles is None:
        sep_tiles = grid.n_arrow_tiles
    if ndt < 2:
        return PartitionPlan.trivial(ndt)
    band = np.asarray(tiles)[:ndt, :ndt]
    cuts = [0]
    for c in range(1, ndt):
        lo = max(0, c - bt)
        if not band[c:min(ndt, c + bt), lo:c].any() and c - cuts[-1] >= min_tiles:
            cuts.append(c)
    if ndt - cuts[-1] < min_tiles and len(cuts) > 1:
        cuts.pop()
    return PartitionPlan(boundaries=tuple(cuts) + (ndt,),
                         sep_tiles=int(sep_tiles))


def partition_plan_from_ordering(result: OrderingResult,
                                 structure: ArrowheadStructure,
                                 t: int) -> PartitionPlan:
    """Build the tile-level :class:`PartitionPlan` an accepted
    :func:`adaptive_nd_ordering` result induces.

    The ordering's ``partitions`` array labels each *element* of the new
    ordering with its partition id (-1 for separator/arrow rows moved to
    the end).  The partition runs are contiguous by construction; their
    element boundaries must land on tile boundaries for the kernel-level
    plan (pick ``n_parts`` so ``nd / n_parts`` is a multiple of ``t``, or
    fall back to :func:`detect_partition_plan` on the permuted pattern,
    which simply finds no cut at a misaligned boundary).  The separator +
    arrow tail maps to ``sep_tiles``.
    """
    if result.partitions is None or not result.accepted:
        grid = TileGrid(structure, t)
        return PartitionPlan.trivial(grid.n_diag_tiles)
    parts = np.asarray(result.partitions)
    body = parts[parts >= 0]
    n_body = len(body)
    if n_body % t:
        raise ValueError(
            f"partition body size {n_body} is not tile-aligned (t={t}); "
            "choose n_parts so partition boundaries land on tile edges, "
            "or run detect_partition_plan on the permuted pattern")
    ids, counts = np.unique(body, return_counts=True)
    order = np.argsort(ids)
    counts = counts[order]
    if (counts % t).any():
        raise ValueError(
            f"partition sizes {counts.tolist()} are not tile-aligned "
            f"(t={t}); choose n_parts so each partition is a whole number "
            "of tiles, or run detect_partition_plan instead")
    bounds = np.concatenate([[0], np.cumsum(counts // t)])
    n_tail = structure.n - n_body            # separator + arrow elements
    return PartitionPlan(boundaries=tuple(int(b) for b in bounds),
                         sep_tiles=int(np.ceil(n_tail / t)))
