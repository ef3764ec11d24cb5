"""CUDA kernels: the whole banded-arrowhead Cholesky in one launch, and
its partition-parallel form, ``csrc/band_cholesky.cu``.

:func:`band_cholesky_sweep_cuda` ports the TPU kernel
``repro/kernels/band_cholesky.py::band_cholesky_sweep_pallas``.  One
thread-block cluster walks the band columns in order on the plan of
:func:`sweep_plan`, three cluster barriers a column: the column's target
sub-tiles (the diagonal update, the band tiles and arrow rows below it)
spread over the ranks; ``L_kk`` factored by rank 0 while the others add the
previous column's corner-Schur products; the substitution of the rows below
``L_kk``, each rank its own run.  The last ``band_tiles`` finalized panels
are read back from the outputs (they stay in L2) instead of a VMEM ring.
Outputs and semantics match ``ref.band_cholesky_sweep_ref``: column panels,
factored arrow rows, per-chunk corner-Schur sums and the status word
``[min_pivot, nonfinite, first_bad]`` folded in the kernel.

:func:`band_cholesky_partitioned_sweep_cuda` ports
``band_cholesky_partitioned_sweep_pallas``: the same kernel on one cluster
per independent partition of a block-separable band, each with its own
Schur leaf and status word (folded by ``ref.combine_sweep_status``), as
``ref.band_cholesky_partitioned_sweep_ref`` defines it.

Both take a leading batch axis in the same launch, a row of clusters per
element (the grid's second dimension): what ``factorize_window_batched``
runs for B hyperparameter candidates of one sparsity pattern.  Element i
is written bit for bit as an unbatched launch on its inputs writes it: the
plan depends on ``(t, bt, nat, max_cluster)`` alone, and no sum is split
across ranks, so not even the cluster size changes a bit.
"""
from __future__ import annotations

import ctypes
import functools
import math
from dataclasses import dataclass
from typing import Dict, Tuple

import torch

from . import _build
from .potrf import TILE_SIZES, check_tiles
from .ref import check_boundaries, combine_sweep_status, empty_sweep_status
from .ring import chunk_layout
from .tile_sum import SUB

__all__ = ["band_cholesky_sweep_cuda", "band_cholesky_partitioned_sweep_cuda",
           "sweep_phase_cycles", "sweep_max_active_clusters", "SweepUnit", "SweepPlan",
           "sweep_plan", "PHASES", "MAX_PARTITIONS", "MAX_BATCH", "SWEEP_CLUSTER",
           "MAX_SWEEP_CLUSTER", "MAX_PLAN_TILES"]

MAX_PARTITIONS = 512   # csrc/band_cholesky.cu::kMaxParts
MAX_BATCH = 65535      # the grid's height: one row of clusters a batch element
SWEEP_CLUSTER = 16     # the sweep's cluster: the largest the card allows
MAX_SWEEP_CLUSTER = 16  # (non-portable; 8 is the portable size)
MAX_PLAN_TILES = 255   # bt and nat each fit a byte of a unit's code

# rank r's cycles in each phase of sweep_phase_cycles, in the kernel's order
PHASES = ("diagonal products", "potrf", "target and Schur products", "L_kk staging",
          "substitution", "cluster barriers", "column start")

_KIND_CODES = {"band": 0, "arrow": 1, "schur": 2}
# what a target's sub-tile costs beside its pairs (its input read and its
# output written), and what rank 0's factorization of L_kk costs, in pairs
# (32 x 32 x 64 products), for the plan's balance: about 1.2k, 2.4k and 14k
# SM cycles on the H100 (PERF.md section 5, the sweep's phase split)
_UNIT_OVERHEAD = 0.5
_POTRF_COST = 6.0


@dataclass(frozen=True)
class SweepUnit:
    """One sub-tile of a column's work.  ``kind`` is ``"band"`` (the band
    tile ``e = a`` of the column; ``e = 0`` the diagonal update ``U[0]``,
    its lower sub-tiles only), ``"arrow"`` (the arrow row ``i = a``) or
    ``"schur"`` (the corner-Schur tile ``(i, j) = (a, b)``, ``j <= i``, of
    the column before, mirrored into ``(j, i)``; on the diagonal tile its
    lower sub-tiles only).  ``(row, col)`` is the sub-tile."""
    kind: str
    a: int
    b: int
    row: int
    col: int


@dataclass(frozen=True)
class SweepPlan:
    """How the sweep spreads a column over a cluster of ``cluster``
    blocks: rank r computes the diagonal update's sub-tiles of
    ``targets[r]``, then (rank 0 factoring ``L_kk`` first) its other
    target sub-tiles and ``schur[r]`` of the column before, each unit whole
    with its pairs in order, then substitutes rows ``rows[r]`` of the ``(bt
    + nat) t`` rows below ``L_kk`` (the band tiles', then the arrow
    rows')."""
    t: int
    bt: int
    nat: int
    sub: int
    cluster: int
    targets: Tuple[Tuple[SweepUnit, ...], ...]
    schur: Tuple[Tuple[SweepUnit, ...], ...]
    rows: Tuple[Tuple[int, int], ...]

    @property
    def ns(self) -> int:
        """Sub-tiles per edge."""
        return self.t // self.sub

    def pairs(self, unit: SweepUnit, kl: int) -> range:
        """The pairs of ``unit`` in a column with ``kl`` columns before it
        in its partition, in order: pair q is column ``j = q + 1`` back."""
        if unit.kind == "schur":
            return range(1)
        return range(min(self.bt - unit.a if unit.kind == "band" else self.bt, kl))

    def table(self) -> Tuple[int, ...]:
        """The plan as ``csrc/band_cholesky.cu`` reads it: for ranks 0..cl-1
        the offsets of their target units, then of their Schur units, then
        their first substitution row (each list closed by its end), then
        the units, each ``kind | a << 8 | b << 16 | (row * ns + col) << 24``."""
        cl = self.cluster
        head = 3 * (cl + 1)
        code = lambda u: (_KIND_CODES[u.kind] | u.a << 8 | u.b << 16
                          | (u.row * self.ns + u.col) << 24)
        entries, offsets = [], []
        for lists in (self.targets, self.schur):
            for units in lists:
                offsets.append(head + len(entries))
                entries += [code(u) for u in units]
            offsets.append(head + len(entries))
        bounds = [lo for lo, _ in self.rows] + [self.rows[-1][1]]
        return tuple(offsets + bounds + entries)


def _lpt(units, costs, load):
    """Each unit, costliest first, onto the least loaded rank (ties to the
    lowest), adding to ``load``; returns the per-rank lists in that
    order."""
    out = [[] for _ in load]
    for i in sorted(range(len(units)), key=lambda i: (-costs[i], i)):
        r = min(range(len(load)), key=lambda r: (load[r], r))
        load[r] += costs[i]
        out[r].append(units[i])
    return out


@functools.lru_cache(maxsize=None)
def sweep_plan(t: int, bt: int, nat: int, max_cluster: int = SWEEP_CLUSTER) -> SweepPlan:
    """The sweep's plan for ``t x t`` tiles, ``bt`` band tiles and ``nat``
    arrow tiles: a cluster of ``min(max_cluster, target units)`` blocks;
    the target units (the diagonal update's lower ``sub x sub`` sub-tiles,
    every sub-tile of the band tiles and arrow rows, ``sub = min(t, 32)``)
    and the Schur units balanced over the ranks by their pairs, the
    diagonal update's first, with rank 0 counted busy until the diagonal
    update's last pair is in and while it factors ``L_kk``; the
    substitution's rows in equal contiguous runs.  It depends on these four
    numbers only, never on the batch, the partitions or ndt."""
    if not 1 <= max_cluster <= MAX_SWEEP_CLUSTER:
        raise ValueError(f"sweep_plan: want 1 <= max_cluster <= {MAX_SWEEP_CLUSTER}, "
                         f"got {max_cluster}")
    if t not in TILE_SIZES or not (0 <= bt <= MAX_PLAN_TILES and 0 <= nat <= MAX_PLAN_TILES):
        raise ValueError(f"sweep_plan: want t in {TILE_SIZES} and 0 <= bt, nat <= "
                         f"{MAX_PLAN_TILES}, got {t}, {bt}, {nat}")
    sub = min(t, SUB)
    ns = t // sub
    every = [(r, c) for r in range(ns) for c in range(ns)]
    lower = [(r, c) for r, c in every if c <= r]
    targets = ([SweepUnit("band", 0, 0, r, c) for r, c in lower]
               + [SweepUnit("band", e, 0, r, c) for e in range(1, bt + 1) for r, c in every]
               + [SweepUnit("arrow", i, 0, r, c) for i in range(nat) for r, c in every])
    schur = [SweepUnit("schur", i, j, r, c) for i in range(nat) for j in range(i + 1)
             for r, c in (every if j < i else lower)]
    cluster = min(max_cluster, len(targets))
    cost = lambda u: (1.0 if u.kind == "schur" else bt - u.a if u.kind == "band"
                      else bt) + _UNIT_OVERHEAD
    diag = [u for u in targets if u.kind == "band" and u.a == 0]
    # rank 0 factors L_kk once the diagonal update's last pair is in
    load = [1.0 + _UNIT_OVERHEAD + _POTRF_COST] + [0.0] * (cluster - 1)
    rest = [u for u in targets + schur if u not in diag]
    first = _lpt(diag, [cost(u) for u in diag], load)
    then = _lpt(rest, [cost(u) for u in rest], load)
    plan_targets = tuple(tuple(a + [u for u in b if u.kind != "schur"])
                         for a, b in zip(first, then))
    plan_schur = tuple(tuple(u for u in b if u.kind == "schur") for b in then)
    nrows = (bt + nat) * t
    per = -(-nrows // cluster)
    rows = tuple((min(r * per, nrows), min((r + 1) * per, nrows)) for r in range(cluster))
    return SweepPlan(t=t, bt=bt, nat=nat, sub=sub, cluster=cluster, targets=plan_targets,
                     schur=plan_schur, rows=rows)


_tables: Dict[Tuple[SweepPlan, torch.device], torch.Tensor] = {}


def _plan_table(plan: SweepPlan, device: torch.device) -> torch.Tensor:
    """The plan's table on ``device``, made once: a launch captured in a
    CUDA graph reads the same tensor on every replay."""
    key = (plan, torch.device(device))
    table = _tables.get(key)
    if table is None:
        table = torch.tensor(plan.table(), dtype=torch.int32, device=device)
        _tables[key] = table
    return table


def _check_sweep_inputs(name: str, Ac: torch.Tensor, R: torch.Tensor) -> int:
    """``Ac (..., ndt, bt+1, t, t)`` and ``R (..., ndt, nat, t, t)`` with at
    most one leading batch dim, the card's grid height at most; returns t."""
    t = check_tiles(name, Ac, R)
    if Ac.dim() not in (4, 5) or R.dim() != Ac.dim() or R.shape[:-3] != Ac.shape[:-3]:
        raise ValueError(f"{name}: want Ac ([B,] ndt, bt+1, t, t) and R ([B,] ndt, nat, t, t), "
                         f"got {tuple(Ac.shape)} and {tuple(R.shape)}")
    if Ac.dim() == 5 and not 1 <= Ac.shape[0] <= MAX_BATCH:
        raise ValueError(f"{name}: a batch of {Ac.shape[0]}, the kernel takes 1 to {MAX_BATCH}")
    return t


@_build.counted(lambda Ac, *a, **kw: _build.batch(Ac, 4))
def band_cholesky_sweep_cuda(Ac: torch.Tensor, R: torch.Tensor,
                             nchunks: int = 1, start_tile: int = 0, *,
                             max_cluster: int = SWEEP_CLUSTER):
    """``Ac (ndt, bt+1, t, t)`` column-band tiles and ``R (ndt, nat, t, t)``
    arrow rows -> ``(panels, R_out, schur, status)`` on the card, with
    ``schur (nch, nat, nat, t, t)``, ``nch = chunk_layout(ndt, nchunks)[1]``.
    Columns ``k < start_tile`` are an identity-embedding prefix.  One launch
    of a cluster on the plan ``sweep_plan(t, bt, nat, max_cluster)``; a
    cluster the card refuses raises.  A leading batch axis ``(B, ...)`` on
    both inputs is one launch of B clusters, and every output gains it
    (``status (B, 3)``)."""
    t = _check_sweep_inputs("band_cholesky_sweep", Ac, R)
    lead = tuple(Ac.shape[:-4])
    ndt, b1 = Ac.shape[-4:-2]
    nat = R.shape[-3]
    plan = sweep_plan(t, b1 - 1, nat, max_cluster)
    csz, nch = chunk_layout(ndt, nchunks)
    if ndt == 0:
        return (torch.empty_like(Ac), torch.empty_like(R),
                torch.zeros(lead + (nch, nat, nat, t, t), dtype=Ac.dtype, device=Ac.device),
                empty_sweep_status(Ac.device).expand(lead + (3,)).clone())
    # the kernel writes every output element, so nothing is zeroed here
    panels = torch.empty_like(Ac)
    R_out = torch.empty_like(R)
    schur = torch.empty(lead + (nch, nat, nat, t, t), dtype=Ac.dtype, device=Ac.device)
    status = torch.empty(lead + (3,), dtype=torch.float32, device=Ac.device)
    table = _plan_table(plan, Ac.device)
    lib = _build.load("band_cholesky")
    stream = torch.cuda.current_stream(Ac.device).cuda_stream
    code = lib.stiles_band_cholesky_sweep_f32(
        Ac.data_ptr(), R.data_ptr(), panels.data_ptr(), R_out.data_ptr(),
        schur.data_ptr(), status.data_ptr(), table.data_ptr(), plan.cluster, ndt, b1 - 1, nat,
        t, csz, int(start_tile), int(math.prod(lead)), stream)
    _build.check(lib, code, "band_cholesky_sweep")
    return panels, R_out, schur, status


@_build.counted(lambda Ac, *a, **kw: _build.batch(Ac, 4))
def band_cholesky_partitioned_sweep_cuda(Ac: torch.Tensor, R: torch.Tensor, boundaries,
                                         start_tile: int = 0, *,
                                         max_cluster: int = SWEEP_CLUSTER):
    """The sweep of :func:`band_cholesky_sweep_cuda` over the partitions
    ``[boundaries[p], boundaries[p+1])`` of a block-separable band, one
    cluster each on the same plan, in one launch -> ``(panels, R_out,
    schur, status)`` with ``schur (P, nat, nat, t, t)``, one corner-Schur
    leaf per partition, and the (3,) status word folded over the partitions
    (``first_bad`` global).  Columns ``k < start_tile`` (global) are an
    identity-embedding prefix.  A leading batch axis is taken as
    :func:`band_cholesky_sweep_cuda` takes it: B x P clusters in the one
    launch."""
    t = _check_sweep_inputs("band_cholesky_partitioned_sweep", Ac, R)
    lead = tuple(Ac.shape[:-4])
    ndt, b1 = Ac.shape[-4:-2]
    nat = R.shape[-3]
    plan = sweep_plan(t, b1 - 1, nat, max_cluster)
    bounds = check_boundaries(boundaries, ndt)
    nparts = len(bounds) - 1
    if nparts > MAX_PARTITIONS:
        raise ValueError(f"band_cholesky_partitioned_sweep: {nparts} partitions, the "
                         f"kernel takes at most {MAX_PARTITIONS}")
    # the kernel writes every output element, so nothing is zeroed here
    panels = torch.empty_like(Ac)
    R_out = torch.empty_like(R)
    schur = torch.empty(lead + (nparts, nat, nat, t, t), dtype=Ac.dtype, device=Ac.device)
    words = torch.empty(lead + (nparts, 3), dtype=torch.float32, device=Ac.device)
    host_bounds = (ctypes.c_int * (nparts + 1))(*bounds)
    table = _plan_table(plan, Ac.device)
    lib = _build.load("band_cholesky")
    stream = torch.cuda.current_stream(Ac.device).cuda_stream
    code = lib.stiles_band_cholesky_partitioned_sweep_f32(
        Ac.data_ptr(), R.data_ptr(), panels.data_ptr(), R_out.data_ptr(), schur.data_ptr(),
        words.data_ptr(), table.data_ptr(), plan.cluster, ctypes.addressof(host_bounds),
        nparts, b1 - 1, nat, t, int(start_tile), int(math.prod(lead)), stream)
    _build.check(lib, code, "band_cholesky_partitioned_sweep")
    return panels, R_out, schur, combine_sweep_status(words)


def sweep_max_active_clusters(t: int, cluster: int) -> int:
    """How many clusters of ``cluster`` blocks of the sweep at tile size
    ``t`` the card holds at once (``cudaOccupancyMaxActiveClusters``): a
    launch of more clusters than this runs them in waves."""
    lib = _build.load("band_cholesky")
    out = ctypes.c_int(0)
    _build.check(lib, lib.stiles_sweep_max_active_clusters(t, cluster, ctypes.addressof(out)),
                 "sweep_max_active_clusters")
    return out.value


def sweep_phase_cycles(Ac: torch.Tensor, R: torch.Tensor, nchunks: int = 1, *,
                       max_cluster: int = SWEEP_CLUSTER, rank: int = 0):
    """Where one sweep's time goes: the SM cycles rank ``rank`` of its
    cluster spent in each of :data:`PHASES`, summed over the columns, from a
    separate build of the kernel with a clock mark (and a block barrier)
    between phases; the waits at the cluster barriers are a phase of their
    own.  For measurement only: the main path never loads that build, and
    this call does not count as a launch of the kernel."""
    t = check_tiles("sweep_phase_cycles", Ac, R)
    ndt, b1 = Ac.shape[:2]
    nat = R.shape[1]
    plan = sweep_plan(t, b1 - 1, nat, max_cluster)
    if not 0 <= rank < plan.cluster:
        raise ValueError(f"sweep_phase_cycles: rank {rank} of a cluster of {plan.cluster}")
    csz, nch = chunk_layout(ndt, nchunks)
    lib = _build.load("band_cholesky", ("STILES_SWEEP_PHASES",))
    lib.stiles_sweep_phase_cycles.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.stiles_sweep_phase_cycles.restype = ctypes.c_int
    cycles = (ctypes.c_ulonglong * (MAX_SWEEP_CLUSTER * len(PHASES)))()
    _build.check(lib, lib.stiles_sweep_phase_cycles(None, 1), "sweep_phase_cycles")
    outs = (torch.empty_like(Ac), torch.empty_like(R),
            torch.empty((nch, nat, nat, t, t), dtype=Ac.dtype, device=Ac.device),
            torch.empty(3, dtype=torch.float32, device=Ac.device))
    code = lib.stiles_band_cholesky_sweep_f32(
        Ac.data_ptr(), R.data_ptr(), *(x.data_ptr() for x in outs),
        _plan_table(plan, Ac.device).data_ptr(), plan.cluster, ndt, b1 - 1, nat, t, csz, 0, 1,
        torch.cuda.current_stream(Ac.device).cuda_stream)
    _build.check(lib, code, "sweep_phase_cycles")
    torch.cuda.synchronize(Ac.device)
    _build.check(lib, lib.stiles_sweep_phase_cycles(ctypes.addressof(cycles), 0),
                 "sweep_phase_cycles")
    mine = cycles[rank * len(PHASES):(rank + 1) * len(PHASES)]
    return dict(zip(PHASES, (int(c) for c in mine)))
