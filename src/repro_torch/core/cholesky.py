"""Sparse tile Cholesky factorization (the paper's Algorithms 1-3).

Two backends, the second also batched:

* :func:`factorize_tasklist` — the paper's own algorithm: the static task
  list of symbolic factorization (Algorithm 1's left-looking order) over
  the general CTSF (:class:`~repro_torch.core.ctsf.TileMatrix`), one tile
  kernel launch per POTRF / SYRK / TRSM / GEMM task, touching only nonzero
  and fill tiles.  With ``tree_reduction=True`` each long accumulation
  chain is summed by Algorithm 3 (chunked partials and the GEADD tree).
  On the card the launches are captured once per sparsity pattern into a
  CUDA graph and replayed, the counterpart of the reference's ``jax.jit``
  keyed on its static task list.
* :func:`factorize_window` — the regular banded-arrowhead layout
  (:class:`~repro_torch.core.ctsf.BandedCTSF`) in two phases: the band +
  arrow rows in one sweep, which also returns the corner-Schur complement
  as partial sums (the leaves of the Alg. 3 tree), then the dense corner,
  ``C - sum(leaves)``, column by column with the ``potrf`` and ``trsm``
  tile kernels.  On the card the sweep is one CUDA kernel launch: the
  fused sweep walks every band column on one thread-block cluster; with a
  partition plan of more than one partition, the partitioned sweep walks
  each independent partition on a cluster of its own, and its leaves (one a
  partition) are
  combined by the GEADD tree.  The plain version is a column loop.
  ``SolverOptions(sweep="window")`` takes the legacy window sweep instead:
  a ``band_update``, ``potrf`` and ``trsm`` launch per panel, and the
  corner's Schur sum through the chunked GEADD tree.
* :func:`factorize_window_batched` — the same on a batch of matrices of one
  grid (the INLA θ-sweep), every route one dispatch for the whole batch.

Port of the JAX package's ``core/cholesky.py`` (``factorize_tasklist``,
``_factorize_window_impl`` with its five sweep modes,
``_band_arrow_sweep``, ``_corner_schur``, ``_corner_dense_cholesky``,
``factorize_window_batched`` and ``CholeskyFactor``), with the
reference's ``regularize=`` breakdown recovery (``core/robustness.py``)
and canonical-grid bucketing (``SolverOptions(policy=)``,
``core/gridpolicy.py``): the matrix is embedded on its canonical grid,
every route skips the identity prefix through ``start_tile``, and the
factor carries ``source_grid``.  The batched factorization keeps what it
builds a key in the LRU cache ``batched_window`` (``core/batching.py``).
"""
from __future__ import annotations

import dataclasses
import hashlib
from collections import Counter
from typing import Any, Callable, Dict, List, Optional

import torch

from repro_torch.kernels import _build, ops, ref
from repro_torch.kernels.band_cholesky import MAX_PLAN_TILES, sweep_plan
from repro_torch.kernels.potrf import TILE_SIZES
from repro_torch.kernels.ring import band_col_to_row, band_row_to_col
from repro_torch.runtime import telemetry
from .batching import LRUCache, cut_batch, pad_batch
from .ctsf import BandedCTSF, TileMatrix
from .options import SolverOptions
from .robustness import FactorInfo, RegularizePolicy, fold_corner_status, run_ladder
from .structure import TileGrid
from .symbolic import Task, TaskType
from .tree_reduction import chunked_tree_sum, should_use_tree, tree_combine

__all__ = ["CholeskyFactor", "factorize_window", "factorize_window_batched",
           "factorize_tasklist"]


# ---------------------------------------------------------------------------
# Task-list backend (the paper's algorithm)
# ---------------------------------------------------------------------------

def _group_tasks_by_column(tasks: List[Task]) -> Dict[int, dict]:
    """Regroup Alg. 1's flat task list into per-column phases:
    ``{k: {"syrk": [n, ...], "panel": {m: {"gemm": [n, ...], "trsm": bool}}}}``."""
    cols: Dict[int, dict] = {}
    for t in tasks:
        c = cols.setdefault(t.k, {"syrk": [], "panel": {}})
        if t.type == TaskType.SYRK:
            c["syrk"].append(t.n)
        elif t.type == TaskType.GEMM:
            c["panel"].setdefault(t.m, {"gemm": [], "trsm": False})
            c["panel"][t.m]["gemm"].append(t.n)
        elif t.type == TaskType.TRSM:
            c["panel"].setdefault(t.m, {"gemm": [], "trsm": False})
            c["panel"][t.m]["trsm"] = True
    return cols


def _chain(pairs, workers: int, device):
    """One accumulation chain of ``(a_slot, b_slot)`` products: the slot
    pairs themselves, to be applied one task at a time, or, where Alg. 3's
    tree applies, the slots as index tensors on ``device`` for one gather."""
    if not should_use_tree(len(pairs), workers):
        return ("tasks", pairs)
    a, b = zip(*pairs)
    return ("tree", torch.tensor(a, device=device), torch.tensor(b, device=device))


def _schedule(tm: TileMatrix, workers: int):
    """The task list in execution order, per column ``k``: ``(kk, syrk chain,
    [(mk, gemm chain, trsm), ...])`` in slots; built once per matrix,
    device and worker count, so a factorization makes no host-to-device
    copy (and can be captured in a CUDA graph)."""
    key = (str(tm.device), workers)
    if key not in tm.schedules:
        slot, cols = tm.slot, _group_tasks_by_column(tm.symbolic.tasks)
        steps = []
        for k in sorted(cols):
            col = cols[k]
            syrk = _chain([(slot[(k, n)],) * 2 for n in col["syrk"]], workers, tm.device)
            panel = [(slot[(m, k)],
                      _chain([(slot[(m, n)], slot[(k, n)]) for n in col["panel"][m]["gemm"]],
                             workers, tm.device),
                      col["panel"][m]["trsm"])
                     for m in sorted(col["panel"])]
            steps.append((slot[(k, k)], syrk, panel))
        tm.schedules[key] = steps
    return tm.schedules[key]


def _tree_update(tiles: torch.Tensor, dst: int, chain, workers: int, impl) -> None:
    """``tiles[dst] -= sum_q A_q B_q^T`` by Algorithm 3: the products in one
    batched product (full float32, no TF32, as the reference's HIGHEST
    precision einsum), the chunk partials summed, the GEADD tree on top."""
    _, a, b = chain
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        terms = torch.einsum("nab,ncb->nac", tiles[a], tiles[b])
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    tiles[dst] -= chunked_tree_sum(terms, workers, impl=impl)


def _run_tasklist(tiles: torch.Tensor, steps, workers: int, impl) -> torch.Tensor:
    """Every task of the schedule ``steps`` on ``tiles``, in place: one
    kernel launch a task, or a tree update a long chain."""
    for kk, syrk, panel in steps:
        if syrk[0] == "tree":
            _tree_update(tiles, kk, syrk, workers, impl)
        else:
            for s, _ in syrk[1]:
                ops.syrk(tiles[kk], tiles[s], impl=impl, out=tiles[kk])
        ops.potrf(tiles[kk], impl=impl, out=tiles[kk])
        for mk, gemm, trsm in panel:
            if gemm[0] == "tree":
                _tree_update(tiles, mk, gemm, workers, impl)
            else:
                for sa, sb in gemm[1]:
                    ops.gemm(tiles[mk], tiles[sa], tiles[sb], impl=impl, out=tiles[mk])
            if trsm:
                ops.trsm(tiles[kk], tiles[mk], impl=impl, out=tiles[mk])
    return tiles


# captured factorizations kept at once; each holds its own input and output
# tile buffers (23 MB each on Table II matrix 5) and its memory pool
TASKLIST_GRAPH_CACHE = 4


def tasklist_graph_key(tm: TileMatrix, workers: int) -> tuple:
    """What a captured factorization of ``tm`` is cached on: the digest of
    its sparsity pattern (slot map and column-grouped task list, as the
    reference's ``_StaticSpec``, computed once a TileMatrix), ``t``,
    ``n_alloc``, the device and the tree workers (0: no tree); not the
    values, so a new TileMatrix of the same pattern replays the graph."""
    if tm.pattern_key is None:
        cols = _group_tasks_by_column(tm.symbolic.tasks)
        spec = (sorted(tm.slot.items()),
                [(k, c["syrk"], [(m, e["gemm"], e["trsm"])
                                 for m, e in sorted(c["panel"].items())])
                 for k, c in sorted(cols.items())])
        tm.pattern_key = hashlib.sha256(repr(spec).encode()).hexdigest()
    return (tm.pattern_key, tm.grid.t, tm.n_alloc, str(tm.device), workers)


@dataclasses.dataclass
class _TasklistGraph:
    graph: "torch.cuda.CUDAGraph"
    tiles_in: torch.Tensor          # copied from each call's tiles before a replay
    tiles_out: torch.Tensor         # the factor, written by a replay
    steps: list                     # the schedule whose index tensors the graph reads
    launches: Counter               # the graph's launches by kernel wrapper name
    labelled: Counter = dataclasses.field(default_factory=Counter)  # _build.recording's


class GraphCache(LRUCache):
    """Captured CUDA graphs by key: an :class:`~repro_torch.core.batching.
    LRUCache` of at most ``max_entries``, least recently used first out,
    whose ``stats()`` count hits, misses and evictions; an entry has the
    ``graph``, the ``launches`` its capture recorded, by kernel wrapper
    name, and the same launches ``labelled`` as ``kernels/_build.py::
    recording`` keeps them.  ``captures`` counts the captures made;
    ``recorded`` counts the launches the captures recorded into their graphs
    (the wrappers count these calls as their own), and ``replayed`` those
    that the replays made on the card.  The graph caches are the port's own
    (the reference's ``jax.jit`` caches report nothing): their lookups
    report to no telemetry, and a replay counts its launches in
    ``kernel.launches`` while telemetry is on, as the wrappers count the
    launches they make."""

    def __init__(self, max_entries: int, name: Optional[str] = None):
        super().__init__(max_entries, name)
        self.captures = 0
        self.recorded: Counter = Counter()
        self.replayed: Counter = Counter()

    def _emit(self, record, metric: str, value: float = 1.0) -> None:
        pass

    @property
    def max_entries(self) -> int:
        return self.maxsize

    def find(self, key):
        """The entry kept under ``key``, now the most recently used, or None."""
        return LRUCache.get(self, key)

    def add(self, key, entry):
        """Keep a new capture's ``entry`` under ``key``; the least recently
        used entries go past ``max_entries``."""
        self.captures += 1
        self.recorded.update(entry.launches)
        LRUCache.put(self, key, entry)
        return entry

    def replay(self, entry) -> None:
        entry.graph.replay()
        self.replayed.update(entry.launches)
        if telemetry.enabled():
            for (_, labels), n in entry.labelled.items():
                telemetry.inc("kernel.launches", n, **dict(labels))


class TasklistGraphs(GraphCache):
    """The captured factorizations, keyed by :func:`tasklist_graph_key`."""

    def get(self, tm: TileMatrix, workers: int) -> _TasklistGraph:
        """The graph of ``tm``'s pattern, captured now if it is not kept."""
        key = tasklist_graph_key(tm, workers)
        entry = self.find(key)
        return entry if entry is not None else self.add(key, _capture_tasklist(tm, workers))


tasklist_graphs = TasklistGraphs(TASKLIST_GRAPH_CACHE, name="tasklist_graphs")


def _warm_up(tiles: torch.Tensor, steps, workers: int) -> None:
    """What a capture of ``steps`` needs done first, on scratch tiles: one
    launch of each tile kernel (the kernels are loaded) and, where a chain
    is summed by Alg. 3, one tree update (cuBLAS makes its handle)."""
    w = torch.eye(tiles.shape[-1], dtype=tiles.dtype, device=tiles.device).repeat(3, 1, 1)
    ops.syrk(w[0], w[1], impl="cuda", out=w[0])
    ops.gemm(w[0], w[1], w[2], impl="cuda", out=w[0])
    ops.potrf(w[2], impl="cuda", out=w[2])
    ops.trsm(w[2], w[0], impl="cuda", out=w[0])
    tree = next((c for _, syrk, panel in steps for c in (syrk, *(g for _, g, _ in panel))
                 if c[0] == "tree"), None)
    if tree is not None:
        _tree_update(tiles.clone(), 0, tree, workers, "cuda")


def capture(graph: "torch.cuda.CUDAGraph"):
    """``torch.cuda.graph(graph)`` with the capture's errors confined to the
    capturing thread (``capture_error_mode="thread_local"``), the context of
    both capture sites (the task list's and the solves' corner).  Under the
    default global mode, a call that is unsafe during a capture (a
    ``cudaMalloc`` of the caching allocator, a copy from pageable memory)
    made by *another* thread fails there and invalidates this capture: a
    client building its matrices on the card while the rung server's pump
    thread captures a new corner key.  Another thread's work reaches the
    captured computation only through an event the capturing stream waits
    on (``launch/rung_server.py``), and an unsafe call of the capturing
    thread's own still fails the capture."""
    return torch.cuda.graph(graph, capture_error_mode="thread_local")


def _capture_tasklist(tm: TileMatrix, workers: int) -> _TasklistGraph:
    """Capture the factorization of ``tm``'s pattern: the warm-up on a side
    stream, then the whole schedule into a CUDA graph that clones its
    static input buffer and factors the clone in place.  The wrappers'
    counts grow by the warm-up's launches and by those the capture records;
    the latter are the graph's.  A failed capture raises."""
    steps = _schedule(tm, workers)
    tiles_in = tm.tiles.clone()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        _warm_up(tiles_in, steps, workers)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with capture(graph), _build.recording() as log:
        tiles_out = _run_tasklist(tiles_in.clone(), steps, workers, "cuda")
    return _TasklistGraph(graph, tiles_in, tiles_out, steps, _build.by_wrapper(log), log)


def factorize_tasklist(tm: TileMatrix, *, tree_reduction: bool = False, tree_workers: int = 8,
                       options: Optional[SolverOptions] = None) -> torch.Tensor:
    """Run Algorithm 1 over the general CTSF: returns the factor's tile
    buffer, ``(n_alloc, t, t)`` with ``tm``'s slot map (``tm.tiles`` is left
    as it is).

    Per column k in order: the SYRK chain into the diagonal tile, its
    ``potrf``, then per row m below it (sorted) the GEMM chain into tile
    (m, k) and its ``trsm``.  Every task is one kernel, writing into the
    tile's slot of the buffer (``out=``; a task's output tile is never one
    of its inputs).  With ``tree_reduction`` a chain of at least ``2 *
    tree_workers`` products is one batched product instead, summed by
    Algorithm 3 (``tree_workers`` chunk partials and ``ceil(log2
    tree_workers)`` ``geadd`` launches).  ``options.impl`` chooses the
    backend as everywhere else.

    On the CPU, and with ``impl="ref"``, the tasks run one after another
    from the host.  On the card the first call for a sparsity pattern (see
    :func:`tasklist_graph_key`) warms up one launch of each kernel and
    captures all of the pattern's kernels into a CUDA graph, kept in
    :data:`tasklist_graphs` (at most :data:`TASKLIST_GRAPH_CACHE`); every
    call copies ``tm.tiles`` into the graph's input buffer, replays it and
    returns a copy of its output, so no two calls share memory.  Inside a
    stream capture of the caller's own, the tasks are launched into that
    capture instead."""
    impl = (options or SolverOptions()).impl
    workers = tree_workers if tree_reduction else 0
    if (tm.device.type != "cuda" or ops.resolve_impl(impl, tm.tiles) != "cuda"
            or torch.cuda.is_current_stream_capturing()):
        return _run_tasklist(tm.tiles.clone(), _schedule(tm, workers), workers, impl)
    with torch.cuda.device(tm.device):
        entry = tasklist_graphs.get(tm, workers)
        entry.tiles_in.copy_(tm.tiles)
        tasklist_graphs.replay(entry)
        return entry.tiles_out.clone()


# ---------------------------------------------------------------------------
# Window backend
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class CholeskyFactor:
    """Factor L in the banded-arrowhead CTSF layout.

    ``status`` is the (3,) float32 breakdown word ``[min_pivot, nonfinite,
    first_bad]`` over band and corner, on the factor's device ((B, 3) for
    a batch):
    ``first_bad`` is the first band column whose tile broke down (``ndt``
    for the corner) and -1 when the factorization is clean.  A breakdown
    is reported here, not raised: the factor then holds NaN from that
    column on, as the reference's does.

    ``info`` is attached when the factorization ran with ``regularize=``:
    per-element status (OK / RECOVERED with diagonal jitter / FAILED),
    attempts, applied jitter and minimum pivot, as the reference's
    (:class:`~repro_torch.core.robustness.FactorInfo`).  Both read the
    same: ``info.min_pivot`` is ``status[..., 0]`` of the final factor and
    ``info.first_bad_tile`` is ``status[..., 2]`` of the clean attempt, as
    int32.  A FAILED element's factor is unusable but never touches its
    batch siblings.

    ``source_grid`` is set when the factor lives on a canonical grid
    (``SolverOptions(policy=)``, ``core/gridpolicy.py``) but stands for a
    problem on ``source_grid``: the arrays then hold ``blockdiag(I_prefix,
    L)``, and the solve and selected-inverse entry points lift right-hand
    sides in and restrict results back on their own.  :meth:`restrict`
    strips the embedding; ``status``'s ``first_bad`` counts canonical
    columns.

    ``mesh``, ``axis`` and ``offset`` are set on a rank's share of a batch
    factorized with ``concurrent_factorize(mesh=)``: ``ctsf`` holds the
    batch's elements ``offset`` onward that fall to this rank along the
    mesh's ``axis``, while ``status`` and ``info`` hold the whole batch's
    per-element values, the same on every rank (``info.matrix``, where it
    is kept, holds the rank's elements).
    """

    ctsf: BandedCTSF
    status: Optional[torch.Tensor] = None
    info: Optional[FactorInfo] = None
    source_grid: Optional[TileGrid] = None
    mesh: Optional[Any] = None
    axis: Optional[str] = None
    offset: int = 0

    def restrict(self) -> "CholeskyFactor":
        """The factor sliced back onto its source grid (the factor itself
        when it was never embedded)."""
        if self.source_grid is None:
            return self
        from .gridpolicy import restrict_factor
        return restrict_factor(self, self.source_grid)

    @classmethod
    def from_arrays(cls, grid, Dr, R, C, device=None) -> "CholeskyFactor":
        """Carry a factor over from the JAX package: its ``Dr``, ``R`` and
        ``C`` as numpy arrays and its grid, as
        :meth:`BandedCTSF.from_arrays` takes them; no status word."""
        return cls(BandedCTSF.from_arrays(grid, Dr, R, C, device=device))

    def logdet(self) -> torch.Tensor:
        """log det A = 2 * sum log diag(L); padded diagonal entries are 1,
        the identity prefix of a canonical-grid embedding too, so an
        embedded factor gives its source problem's.  A batched factor gives
        one value per element."""
        with telemetry.span("factorize.logdet", device=True):
            g = self.ctsf.grid
            db = torch.diagonal(self.ctsf.Dr[..., 0, :, :], dim1=-2, dim2=-1)
            total = torch.log(torch.abs(db)).sum(dim=(-2, -1))
            nat = g.n_arrow_tiles
            if nat > 0:
                ar = torch.arange(nat, device=self.ctsf.C.device)
                dc = torch.diagonal(self.ctsf.C[..., ar, ar, :, :], dim1=-2, dim2=-1)
                total = total + torch.log(torch.abs(dc)).sum(dim=(-2, -1))
            return 2.0 * total


def _corner_dense_cholesky(c: torch.Tensor, impl: Optional[str]) -> torch.Tensor:
    """Blocked left-looking dense Cholesky of the (..., nat, nat, t, t)
    corner: per column one SYRK/GEMM contraction over the finalized
    columns, one ``potrf`` of the diagonal tile and one batched ``trsm`` of
    the column (all ``nat`` rows, as the reference does: nat launches of
    each, whatever the leading batch dims)."""
    nat = c.shape[-4]
    c = c.clone()
    for k in range(nat):
        rk = c[..., k, :k, :, :]                        # L[k, :k]
        syrk_acc = torch.einsum("...jab,...jcb->...ac", rk, rk)
        lkk = ops.potrf(c[..., k, k, :, :] - syrk_acc, impl=impl)
        gemm_acc = torch.einsum("...mjab,...jcb->...mac", c[..., :, :k, :, :], rk)
        panel = ops.trsm(lkk.unsqueeze(-3), (c[..., :, k, :, :] - gemm_acc).contiguous(),
                         impl=impl)
        c[..., k + 1:, k, :, :] = panel[..., k + 1:, :, :]
        c[..., k, k, :, :] = lkk
    return c


def _band_arrow_sweep(Dr: torch.Tensor, R: torch.Tensor, grid: TileGrid,
                      impl: Optional[str], start_tile: int = 0):
    """The legacy window sweep: the band and arrow rows panel by panel,
    the corner left as it is; returns ``(Dr_L, R_L)`` in the input's
    layout, leading batch dims included.

    Per panel k: one ``band_update`` over the (b+1, b+1) window of the
    padded band rows (read in place), one ``potrf`` of the diagonal tile,
    one ``trsm`` of the ``bt`` tiles below it and, with an arrow, the
    arrow update ``V`` by one contraction and one ``trsm`` of the arrow
    row.  Rows ``k < start_tile`` keep their input values, which is right
    exactly when they are an identity-embedding prefix."""
    t, ndt, nat, bt = grid.t, grid.n_diag_tiles, grid.n_arrow_tiles, grid.band_tiles
    b1 = bt + 1
    lead = tuple(Dr.shape[:-4])
    # pad: bt trailing zero rows on Dr (the last windows' slack), bt leading on R
    Drp = torch.cat([Dr, Dr.new_zeros(lead + (bt, b1, t, t))], dim=-4)
    Rp = torch.cat([R.new_zeros(lead + (bt, nat, t, t)), R], dim=-4)
    diag = torch.arange(1, b1, device=Dr.device)
    for k in range(start_tile, ndt):
        w = Drp[..., k:k + b1, :, :, :]                 # w[e, d] = L[k+e, k+e-d]
        u = ops.band_update(w, impl=impl)
        lkk = ops.potrf(w[..., 0, 0, :, :] - u[..., 0, :, :], impl=impl)
        # the sub-diagonal panel tiles A[k+e, k] sit on the window's diagonal
        lmk = ops.trsm(lkk.unsqueeze(-3), w[..., diag, diag, :, :] - u[..., 1:, :, :],
                       impl=impl)
        if nat:
            # V[i] = sum_{j=1..bt} R[k-j, i] L[k, k-j]^T, with Rp[k+bt-j] = R[k-j]
            v = torch.einsum("...jiab,...jcb->...iac", Rp[..., k:k + bt, :, :, :],
                             w[..., 0, 1:, :, :].flip(-3))
            Rp[..., k + bt, :, :, :] = ops.trsm(lkk.unsqueeze(-3),
                                                Rp[..., k + bt, :, :, :] - v, impl=impl)
        Drp[..., k, 0, :, :] = lkk
        Drp[..., k + diag, diag, :, :] = lmk
    return Drp[..., :ndt, :, :, :].contiguous(), Rp[..., bt:, :, :, :].contiguous()


def _corner_schur(R_L: torch.Tensor, tree_chunks: int, impl: Optional[str]) -> torch.Tensor:
    """``sum_n R[n] R[n]^T`` over every band column, the paper's flagship
    accumulation chain, summed by Alg. 3's chunked tree (``ceil(log2
    tree_chunks)`` geadd launches) where ``should_use_tree`` holds."""
    ndt = R_L.shape[-4]
    terms = torch.einsum("...niab,...njcb->...nijac", R_L, R_L).movedim(-5, 0)
    chunks = tree_chunks or 1
    if should_use_tree(ndt, chunks):
        return chunked_tree_sum(terms, chunks, impl=impl)
    return terms.sum(dim=0)




def _factorize_window_impl(Dr, R, C, grid: TileGrid, impl: Optional[str],
                           tree_chunks: int, sweep: str = "auto", plan=None,
                           start_tile: int = 0):
    """Window factorization: the band sweep, then the dense corner, on
    arrays with or without a leading batch axis.

    ``sweep`` (see :class:`~repro_torch.core.options.SolverOptions`):
    ``"auto"`` is ``"partitioned"`` when ``plan`` (a
    :class:`~repro_torch.core.ordering.PartitionPlan`) has more than one
    partition, else ``"fused"`` on the CUDA backend (``impl``, or the
    device when it is None) and ``"ring"`` on the plain one, so a trivial
    plan gives the plan-less factor bit for bit.  ``"fused"`` is the
    one-launch sweep kernel and ``"ring"`` its plain column loop, each
    leaving chunked Schur sums that are summed before the corner;
    ``"partitioned"`` runs the plan's independent partitions in one launch
    and combines their Schur leaves by the GEADD tree; ``"window"`` is the
    panel loop of :func:`_band_arrow_sweep`, with the corner Schur
    complement summed by :func:`_corner_schur`.

    ``start_tile`` declares the first band columns an identity-embedding
    prefix (``core/gridpolicy.py``): every route leaves them an identity
    panel and a zero arrow row and does no work there.

    Returns ``(Dr_L, R_L, C_L, status)``, ``status`` the (..., 3) float32
    word ``[min_pivot, nonfinite, first_bad]`` over band and corner (a
    corner breakdown reports ``first_bad = ndt``).  The device spans
    ``factorize.sweep`` (the layout conversions and the sweep) and
    ``factorize.corner`` (the Schur sum, the corner's Cholesky and the
    status fold) split the time."""
    nat = grid.n_arrow_tiles
    start_tile = int(start_tile)
    with telemetry.span("factorize.sweep", device=True):
        if plan is not None and plan.n_tiles != grid.n_diag_tiles:
            raise ValueError(
                f"partition plan covers {plan.n_tiles} diagonal tiles but the grid has "
                f"{grid.n_diag_tiles}; rebuild the plan for this grid (PartitionPlan.shifted "
                "embeds a plan into a canonical grid)")
        mode = sweep
        if mode == "auto":
            if plan is not None and plan.n_partitions > 1:
                mode = "partitioned"
            else:
                mode = "fused" if ops.resolve_impl(impl, Dr) == "cuda" else "ring"
        if mode == "window":
            Dr_out, R_out = _band_arrow_sweep(Dr, R, grid, impl, start_tile)
            # the window sweep carries no status: fold the same word from the
            # emitted factor (the row layout keeps the diagonal at [:, 0], all
            # that sweep_status reads of it besides finiteness), as the
            # reference does
            status = ref.sweep_status(Dr_out, R_out)
            schur = lambda: _corner_schur(R_out, tree_chunks, impl)
        elif mode == "partitioned":
            panels, R_out, leaves, status = ops.band_cholesky_partitioned_sweep(
                band_row_to_col(Dr), R, plan.boundaries, start_tile=start_tile, impl=impl)
            Dr_out = band_col_to_row(panels)
            # one Schur leaf per partition: the Alg. 3 binary tree combines
            # them before the shared corner
            schur = lambda: tree_combine(leaves.movedim(-5, 0).contiguous(), impl=impl)
        else:
            nchunks = max(1, min(tree_chunks or 1, grid.n_diag_tiles or 1))
            panels, R_out, leaves, status = ops.band_cholesky_sweep(
                band_row_to_col(Dr), R, nchunks=nchunks, start_tile=start_tile,
                impl="cuda" if mode == "fused" else "ref")
            Dr_out = band_col_to_row(panels)
            # the chunks are the tree-reduction leaves; summing them is the
            # root combine of the paper's Alg. 3 chain
            schur = lambda: leaves.sum(dim=-5)
    with telemetry.span("factorize.corner", device=True):
        C_out = _corner_dense_cholesky(C - schur(), impl) if nat else C
        return Dr_out, R_out, C_out, fold_corner_status(
            status, C_out, grid.n_diag_tiles, nat)


def _embed_matrix(m: BandedCTSF, policy):
    """The canonical-grid embedding of a matrix (or a batch of them) for
    the factorizations, the matrix-side twin of ``solve._resolve_embedding``:
    ``(embedded, source_grid, start_tile)``, ``start_tile`` the identity
    prefix's depth."""
    from .gridpolicy import embed_ctsf
    cgrid = policy.canonicalize(m.grid)
    return embed_ctsf(m, cgrid), m.grid, cgrid.n_diag_tiles - m.grid.n_diag_tiles


def _shift_plan(opts: SolverOptions, pad: int) -> SolverOptions:
    """``opts`` with its partition plan shifted past an identity prefix of
    ``pad`` tiles, which joins partition 0."""
    if opts.partition_plan is None or not pad:
        return opts
    return opts.replace(partition_plan=opts.partition_plan.shifted(pad))


def _window_call(grid: TileGrid, opts: SolverOptions, tree_chunks: int,
                 start_tile: int = 0) -> Callable:
    """``(Dr, R, C) -> (Dr_L, R_L, C_L, status)`` on ``grid`` with the
    options' backend, sweep and plan."""
    return lambda dr, r, c: _factorize_window_impl(
        dr, r, c, grid, opts.impl, tree_chunks, opts.sweep, opts.partition_plan, start_tile)


def _factorize(Dr, R, C, grid: TileGrid, call: Callable, regularize,
               gather: Optional[Callable] = None) -> CholeskyFactor:
    """``call`` on arrays with or without a batch axis, through the jitter
    ladder when ``regularize`` asks for it: the factor, its status word
    and, with the ladder, its ``FactorInfo``.  With the ladder, an
    element's ``[min_pivot, nonfinite]`` are those of the attempt its factor
    came from (attempt ``info.attempts``: a retried element is retried
    until it is healthy or the ladder ends) and its ``first_bad`` the clean
    attempt's, so ``status`` and ``info`` read the same.  ``gather`` is the
    ladder's (a sharded batch's all-gather, ``run_ladder``)."""
    policy = RegularizePolicy.resolve(regularize)
    if policy is None:
        Dr_L, R_L, C_L, status = call(Dr, R, C)
        return CholeskyFactor(BandedCTSF(grid, Dr_L, R_L, C_L), status)
    words = []

    def kept(dr, r, c):
        out = call(dr, r, c)
        words.append(out[3])
        return out

    Dr_L, R_L, C_L, info = run_ladder(Dr, R, C, grid, kept, policy, gather)
    if len(words) == 1:                 # the clean path: its one attempt's word
        return CholeskyFactor(BandedCTSF(grid, Dr_L, R_L, C_L), words[0], info)
    final = words[0]
    for n, word in enumerate(words[1:], start=2):
        final = torch.where((info.attempts == n)[..., None], word, final)
    status = torch.cat([final[..., :2], words[0][..., 2:]], dim=-1)
    return CholeskyFactor(BandedCTSF(grid, Dr_L, R_L, C_L), status, info)


def factorize_window(m: BandedCTSF, *, tree_chunks: int = 8,
                     options: Optional[SolverOptions] = None) -> CholeskyFactor:
    """Banded-arrowhead factorization on the device of ``m``.

    On the card the whole band + arrow block factorizes in one CUDA kernel
    launch and the corner with ``nat`` ``potrf`` and ``nat`` ``trsm``
    launches.  ``options`` (:class:`~repro_torch.core.options.SolverOptions`)
    can force the plain versions (``impl="ref"``), pass a partition plan
    (``partition_plan``: with more than one partition the sweep is the
    partitioned kernel, one cluster a partition, and the corner adds
    ``ceil(log2 P)`` ``geadd`` launches) and choose the sweep (``sweep``:
    ``"window"`` is the legacy panel loop, a ``band_update``, a ``potrf``
    and one or two ``trsm`` launches a column, and a corner Schur sum
    through the geadd tree).  A breakdown does not raise: the factor's
    ``status`` word reports it.

    ``options.policy`` (a :class:`~repro_torch.core.gridpolicy.
    GridBucketPolicy`) embeds the matrix on its canonical grid first; the
    sweep skips the identity prefix through ``start_tile`` (the same
    launches as the source grid's), a partition plan is shifted past it,
    and the factor lives on the canonical grid with ``source_grid`` set:
    the solve and selected-inverse entry points take it as it is, and
    :meth:`CholeskyFactor.restrict` strips the embedding.

    ``options.regularize`` (True or a
    :class:`~repro_torch.core.robustness.RegularizePolicy`) runs the
    escalating-jitter ladder on breakdown and attaches a ``FactorInfo``
    (``factor.info``); an SPD input factorizes on the first attempt and
    its factor is bit-identical to the call without it."""
    opts = options if options is not None else SolverOptions()
    source, start = None, 0
    with telemetry.span("factorize.window", grid=telemetry.rung_tag(m.grid)) as sp:
        if opts.policy is not None:
            m, source, start = _embed_matrix(m, opts.policy)
            sp.tag(rung=telemetry.rung_tag(m.grid))
            opts = _shift_plan(opts, start)
        f = _factorize(m.Dr, m.R, m.C, m.grid, _window_call(m.grid, opts, tree_chunks, start),
                       opts.regularize)
    f.source_grid = source
    return f


# ---------------------------------------------------------------------------
# Batched window factorization (the INLA θ-sweep)
# ---------------------------------------------------------------------------

# what the batched entry points build once a key; bounded so a process
# cycling through many distinct grids cannot grow them without limit
BATCHED_CACHE = 64
_BATCHED_WINDOW_CACHE = LRUCache(maxsize=BATCHED_CACHE, name="batched_window")


@dataclasses.dataclass
class BatchedEntry:
    """What a batched entry point builds once a cache key: the bound
    callable of the key's grid and options, and the launch plans of its
    kernels (the band-Cholesky sweep's ``sweep_plan`` and the selinv
    recurrence's ``selinv_plan``, made when the entry is built; the
    band-solve sweeps' ``solve_plan``, which depends on the panel width and
    the card, once a width on the card's first call of it)."""

    call: Callable
    plans: dict


def _plannable(grid: TileGrid) -> bool:
    """Whether the sweep kernels take ``grid``'s tiles (else only the plain
    versions can run it, and there is no launch plan to make)."""
    return (grid.t in TILE_SIZES and grid.band_tiles <= MAX_PLAN_TILES
            and grid.n_arrow_tiles <= MAX_PLAN_TILES)


def _batched_window_fn(grid: TileGrid, opts: SolverOptions, tree_chunks: int,
                       use_start: bool = False) -> BatchedEntry:
    """The batched factorization's entry for ``grid``, kept in the cache
    ``batched_window`` under ``(grid, opts.compile_key(), tree_chunks,
    use_start)``, the reference's key: every source grid embedding into
    ``grid``, whatever its prefix depth, shares one entry.  Its ``call``
    takes ``(Dr, R, C, start_tile)``."""
    key = (grid, opts.compile_key(), tree_chunks, use_start)

    def build() -> BatchedEntry:
        plans = ({"sweep": sweep_plan(grid.t, grid.band_tiles, grid.n_arrow_tiles)}
                 if _plannable(grid) else {})
        return BatchedEntry(call=lambda dr, r, c, s: _window_call(grid, opts, tree_chunks, s)(
            dr, r, c), plans=plans)

    return _BATCHED_WINDOW_CACHE.get_or_create(key, build)


def _info_arrays(info: Optional[FactorInfo]) -> tuple:
    return () if info is None else (info.status, info.attempts, info.tau, info.min_pivot,
                                    info.first_bad_tile)


def factorize_window_batched(batch, *, tree_chunks: int = 8, bucket: bool = True,
                             start_tile: Optional[int] = None,
                             options: Optional[SolverOptions] = None) -> CholeskyFactor:
    """Factorize a batch of same-grid matrices in one dispatch: the INLA
    θ-sweep primitive, B hyperparameter candidates of one sparsity pattern.

    ``batch`` is a list of :class:`BandedCTSF` on one grid, or one whose
    arrays carry a leading batch axis (``Dr (B, ndt, bt+1, t, t)``, ``R (B,
    ndt, nat, t, t)``, ``C (B, nat, nat, t, t)``).  Every route of
    :func:`factorize_window` (``options`` as there) takes the whole batch
    at once: on the card the fused or partitioned sweep is one launch for
    all B (a row of blocks each, element i bit for bit what an unbatched
    launch gives it), the window route one ``band_update`` launch a column,
    and the corner one ``potrf`` and one ``trsm`` launch a column.  Returns
    one :class:`CholeskyFactor` with ``(B, ...)`` arrays and a ``(B, 3)``
    status word; its ``logdet`` is ``(B,)``.

    ``bucket`` (the reference's) pads the batch to the next power of two
    by repeating its last matrix, factorizes the padded batch and strips
    the padding's results, so a batch of 5 runs as 8; the elements' results
    are those of the unpadded call.  The callable and launch plans are kept
    a ``(grid, options.compile_key(), tree_chunks, use_start)`` in the LRU
    cache ``batched_window``.

    ``options.policy`` embeds the batch on its canonical grid, keys the
    cache on that grid (a stream of grids on one rung shares one entry)
    and skips the identity prefix; the factor carries ``source_grid``.
    ``start_tile`` is for a batch the caller embedded itself
    (``gridpolicy.assemble_rung_batch``): the shared prefix depth, skipped
    as under a policy; the factor's ``source_grid`` stays None.  The two
    are exclusive.

    ``options.regularize`` runs the jitter ladder on every element at once
    (the padding included, then stripped): a retry refactorizes the whole
    batch with only the failed elements' diagonals jittered, healthy
    elements keep their first attempt's factor bit for bit, and
    ``factor.info`` carries ``(B,)`` status, attempts and tau, so one
    poisoned θ-candidate is a flagged element, not a failed sweep."""
    opts = options if options is not None else SolverOptions()
    with telemetry.span("factorize.window_batched") as sp:
        with telemetry.span("factorize.prepare"):
            if start_tile is not None and opts.policy is not None:
                raise ValueError("start_tile= is for pre-embedded batches and the bucketing "
                                 "policy embeds itself; pass one or the other")
            if isinstance(batch, (list, tuple)):
                if not batch:
                    raise ValueError("batched factorization needs at least one matrix")
                grid = batch[0].grid
                if any(m.grid != grid for m in batch):
                    raise ValueError("batched factorization needs equal structure: every "
                                     "matrix of the batch on one grid; use concurrent."
                                     "stack_ctsf(policy=...) to embed mixed grids onto a "
                                     "shared canonical rung first")
                Dr, R, C = (torch.stack(x) for x in zip(*(m.arrays() for m in batch)))
            else:
                grid = batch.grid
                Dr, R, C = batch.arrays()
                if Dr.dim() != 5:
                    raise ValueError(f"batched CTSF needs a leading batch axis, got "
                                     f"Dr.dim()={Dr.dim()}")
            sp.tag(b=Dr.shape[0], grid=telemetry.rung_tag(grid))
            source, start = None, int(start_tile or 0)
            if opts.policy is not None:
                emb, source, start = _embed_matrix(BandedCTSF(grid, Dr, R, C), opts.policy)
                Dr, R, C, grid = emb.Dr, emb.R, emb.C, emb.grid
                sp.tag(rung=telemetry.rung_tag(grid))
                opts = _shift_plan(opts, start)
            entry = _batched_window_fn(grid, opts, tree_chunks,
                                       use_start=source is not None or start_tile is not None)
            padded, nb = pad_batch((Dr, R, C), bucket)
        f = _factorize(*padded, grid, lambda dr, r, c: entry.call(dr, r, c, start),
                       opts.regularize)
        out = cut_batch(f.ctsf.arrays() + (f.status,) + _info_arrays(f.info), nb)
    info = None
    if f.info is not None:
        # the unpadded batch is the original kept for the refinement
        info = FactorInfo(*out[4:], matrix=None if f.info.matrix is None
                          else BandedCTSF(grid, Dr, R, C))
    return CholeskyFactor(BandedCTSF(grid, *out[:3]), out[3], info, source_grid=source)
