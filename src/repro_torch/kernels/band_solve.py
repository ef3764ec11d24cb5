"""CUDA kernels: the multi-RHS band sweeps, ``csrc/band_solve.cu``.

Ports of the TPU kernels ``repro/kernels/band_solve.py::
band_forward_sweep_pallas`` and ``band_backward_sweep_pallas``: each sweep
over every band row of the factor in one launch, one thread-block cluster
for each chunk of right-hand-side columns, on the plan of
:func:`solve_plan`.  Rank 0 of a cluster walks the rows: for each it adds
the one product with the row it has just solved to the partial sum the
other ranks have added up ahead of it, and substitutes.  The other ranks
compute every other product, each whole on one rank, as soon as its
operand row is published.  Outputs and semantics match
``ref.band_forward_sweep_ref`` and ``ref.band_backward_sweep_ref``,
``start_tile`` included.  No sum is split across ranks, so the cluster
size changes no bit.

A leading batch axis (``Dr (B, ndt, bt+1, t, t)`` and every other input
alike: the θ-batch's factors, each with its own right-hand sides) is one
launch, the batch a second grid dimension whose only effect on a cluster
is its element's pointer offsets: element i is bit for bit its unbatched
launch on the same plan.  The chunk width does change bits: a product's
contraction is split over ``256 / (t / 4 * width)`` lanes (at most ``t /
4``), summed by shuffles, so two widths add in two orders.  The width rule
counts the batch's clusters, so an element of a batch may run at a
narrower width than it would alone (rtol = atol = 2e-4 then; ``width=``
forces one plan for both).
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
import math
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import torch

from . import _build
from .band_cholesky import (MAX_BATCH, MAX_PLAN_TILES, MAX_SWEEP_CLUSTER as MAX_SOLVE_CLUSTER,
                            _plan_table)
from .potrf import TILE_SIZES, check_cuda, check_tiles

__all__ = ["band_forward_sweep_cuda", "band_backward_sweep_cuda", "solve_max_active_clusters",
           "SolveUnit", "SolvePlan", "solve_plan", "card_solve_plan", "SOLVE_CLUSTER",
           "MAX_SOLVE_CLUSTER", "WIDTHS"]

SOLVE_CLUSTER = 16       # the default cap on a cluster's blocks
WIDTHS = (1, 2, 4, 8)    # the chunk widths the kernel is built for
_SMEM_MAX = 232448       # the card's shared memory a block
_UNIT_BUFS = 2           # csrc/band_solve.cu::kUnitBufs
_KIND_CODES = {"band": 0, "arrow": 1}


@dataclass(frozen=True)
class SolveUnit:
    """A product a rank computes in every phase of the sweep, with the row
    rank 0 published in the phase before (or, for the backward sweep's
    arrow term, with ``Xa_i``): ``"band"`` is the look-ahead product with
    band tile ``j = index`` (forward ``L[s+j, s] Y_s`` into row ``s + j``'s
    partial sum, backward ``L[s, s-j]^T X_s`` into row ``s - j``'s),
    ``"arrow"`` arrow tile ``i = index`` (forward ``R[s, i] Y_s`` into
    ``acc_a[i]``, backward ``R[m, i]^T Xa_i`` into row ``m``'s partial
    sum)."""
    kind: str
    index: int


@dataclass(frozen=True)
class SolvePlan:
    """How a sweep spreads over the card: ``chunks`` clusters, each owning
    ``width`` right-hand-side columns (the last one fewer), each of
    ``cluster`` blocks; rank r computes the units ``units[r]`` in every
    phase (rank 0 none unless the cluster is one block).  Rank 0 adds a
    row's terms in a fixed order, ``(B - partial) - chain``, and each
    partial sum is added up in phase order.  Which row a unit's product
    reads and writes in each phase is not in the plan:
    ``csrc/band_solve.cu`` works it out from the phase (its ``job``,
    ``has_chain`` and ``has_partial``), and ``tests/test_torch_solve_plan.py``
    holds a model of that rule."""
    t: int
    bt: int
    nat: int
    k: int
    width: int
    chunks: int
    cluster: int
    units: Tuple[Tuple[SolveUnit, ...], ...]

    def lead(self, backward: bool) -> int:
        """How many phases before a row's own the first term of its
        partial sum is computed: forward the product with band tile bt;
        backward the arrow term's first product (``nat - 1 - i`` phases
        before the band product with tile ``bt``, or with the row after
        it where bt = 1 or 0).  The partial sums are a ring of ``lead +
        1`` slots."""
        if backward and self.nat:
            return max(self.bt, 1) + self.nat - 1
        return max(self.bt - 1, 0)

    def smem_bytes(self, backward: bool) -> int:
        """Shared memory a block of the kernel needs
        (``csrc/band_solve.cu::SolveShape``)."""
        t, w = self.t, self.width
        tile, panel = t * (t + 4), w * (t + 4)
        fixed = 4 * tile + 4 * panel + _UNIT_BUFS * (tile + panel) + panel + t
        return 4 * (fixed + (self.lead(backward) + 1) * panel)

    def table(self) -> Tuple[int, ...]:
        """The plan as ``csrc/band_solve.cu`` reads it: for ranks 0..cl-1
        the offsets of their units (closed by the end), then the units,
        each ``kind | index << 8``."""
        head = self.cluster + 1
        offsets, codes = [], []
        for units in self.units:
            offsets.append(head + len(codes))
            codes += [_KIND_CODES[u.kind] | u.index << 8 for u in units]
        return tuple(offsets + [head + len(codes)] + codes)


@functools.lru_cache(maxsize=None)
def solve_plan(t: int, bt: int, nat: int, k: int, max_cluster: int = SOLVE_CLUSTER, *,
               at_once: int, batch: int = 1) -> SolvePlan:
    """The band sweeps' plan for ``t x t`` tiles, ``bt`` band tiles, ``nat``
    arrow tiles and ``k`` right-hand sides, for each of ``batch`` problems
    in one launch.  The units, the look-ahead products with band tiles
    2..bt and then the arrow tiles, go one per rank to ranks 1, 2, .. in
    turn, so the cluster is ``min(max_cluster, 1 + units)`` blocks and rank
    0 keeps only the chain (all of it at one block).  The columns go in
    chunks of ``width``, a power of two up to 8, the narrowest whose
    ``batch x chunks`` clusters all run at once: ``at_once`` is how many
    clusters of the uncapped size (``1 + units`` blocks, at most 16) the
    card holds with one block an SM (:func:`solve_max_active_clusters`),
    since rank 0's chain slows down on an SM it shares; 8 when none does.
    A narrower chunk is a shorter product and substitution on the chain.
    The plan depends on its arguments only, and the width not on the cap;
    the cap changes which rank computes a product, never how, so not a bit
    of the result.  ``batch = 1`` is the unbatched plan."""
    if not 1 <= max_cluster <= MAX_SOLVE_CLUSTER:
        raise ValueError(f"solve_plan: want 1 <= max_cluster <= {MAX_SOLVE_CLUSTER}, "
                         f"got {max_cluster}")
    if t not in TILE_SIZES or not (0 <= bt <= MAX_PLAN_TILES and 0 <= nat <= MAX_PLAN_TILES) \
            or k < 1 or at_once < 1 or batch < 1:
        raise ValueError(f"solve_plan: want t in {TILE_SIZES}, 0 <= bt, nat <= "
                         f"{MAX_PLAN_TILES}, k >= 1, at_once >= 1 and batch >= 1, got {t}, {bt}, "
                         f"{nat}, {k}, {at_once}, {batch}")
    units = ([SolveUnit("band", j) for j in range(2, bt + 1)]
             + [SolveUnit("arrow", i) for i in range(nat)])
    width = next((w for w in WIDTHS if batch * -(-k // w) <= at_once), WIDTHS[-1])
    cluster = min(max_cluster, 1 + len(units))
    per_rank: List[List[SolveUnit]] = [[] for _ in range(cluster)]
    for n, u in enumerate(units):
        per_rank[0 if cluster == 1 else 1 + n % (cluster - 1)].append(u)
    plan = SolvePlan(t=t, bt=bt, nat=nat, k=k, width=width, chunks=-(-k // width),
                     cluster=cluster, units=tuple(tuple(u) for u in per_rank))
    need = max(plan.smem_bytes(False), plan.smem_bytes(True))
    if need > _SMEM_MAX:
        raise ValueError(f"solve_plan: bt = {bt} and nat = {nat} need {need} bytes of shared "
                         f"memory a block at t = {t}, k = {k}; the card has {_SMEM_MAX}")
    return plan


_at_once: Dict[Tuple[int, int, int], int] = {}


def solve_max_active_clusters(t: int, cluster: int, device=None) -> int:
    """How many clusters of ``cluster`` blocks of the band sweeps at tile
    size ``t`` the card ``device`` holds at once with one block an SM
    (``cudaOccupancyMaxActiveClusters`` for a launch that asks for all the
    shared memory a block may have), asked once a card."""
    index = torch.device("cuda" if device is None else device).index
    index = torch.cuda.current_device() if index is None else index
    key = (t, cluster, index)
    if key not in _at_once:
        lib = _build.load("band_solve")
        out = ctypes.c_int(0)
        with torch.cuda.device(index):
            code = lib.stiles_solve_max_active_clusters(t, cluster, ctypes.addressof(out))
        _build.check(lib, code, "solve_max_active_clusters")
        _at_once[key] = out.value
    return _at_once[key]


def card_solve_plan(t: int, bt: int, nat: int, k: int, max_cluster: int = SOLVE_CLUSTER,
                    device=None, batch: int = 1) -> SolvePlan:
    """The plan the wrappers launch on ``device`` for ``batch`` problems:
    :func:`solve_plan` with ``at_once`` asked of that card for the uncapped
    cluster."""
    uncapped = min(MAX_SOLVE_CLUSTER, 1 + max(bt - 1, 0) + nat)
    return solve_plan(t, bt, nat, k, max_cluster,
                      at_once=max(1, solve_max_active_clusters(t, uncapped, device)),
                      batch=batch)


def _check_band(name: str, Dr: torch.Tensor, R: torch.Tensor, *panels: torch.Tensor) -> int:
    """``Dr ([B,] ndt, bt+1, t, t)``, ``R ([B,] ndt, nat, t, t)`` and
    ``([B,] rows, t, k)`` panels, one batch for all; returns t."""
    t = check_tiles(name, Dr, R)
    check_cuda(name, *panels, aligned=False)
    lead = Dr.shape[:-4]
    if Dr.dim() not in (4, 5) or R.dim() != Dr.dim() or R.shape[:-3] != Dr.shape[:-3]:
        raise ValueError(f"{name}: want Dr ([B,] ndt, bt+1, t, t) and R ([B,] ndt, nat, t, t), "
                         f"got {tuple(Dr.shape)} and {tuple(R.shape)}")
    if lead and not 1 <= lead[0] <= MAX_BATCH:
        raise ValueError(f"{name}: a batch of {lead[0]}, the kernel takes 1 to {MAX_BATCH}")
    k = panels[0].shape[-1]
    for p in panels:
        if p.dim() != 3 + len(lead) or p.shape[:-3] != lead or p.shape[-2:] != (t, k):
            raise ValueError(f"{name}: want ({'B, ' if lead else ''}rows, {t}, {k}) panels, "
                             f"got {tuple(p.shape)}")
    return t


def _plan(Dr, nat: int, k: int, max_cluster: int, width: Optional[int]) -> SolvePlan:
    """The card's plan for the inputs, at chunks of ``width`` columns where
    one is forced."""
    t, b1 = Dr.shape[-1], Dr.shape[-3]
    plan = card_solve_plan(t, b1 - 1, nat, k, max_cluster, Dr.device,
                           batch=math.prod(Dr.shape[:-4]))
    if width is None or width == plan.width:
        return plan
    if width not in WIDTHS:
        raise ValueError(f"band sweeps: width {width} not built (want one of {WIDTHS})")
    return dataclasses.replace(plan, width=width, chunks=-(-k // width))


def _launch(name: str, plan: SolvePlan, backward: bool, Dr, R, rhs, xa, out, acca,
            start_tile: int) -> None:
    lib = _build.load("band_solve")
    fn = lib.stiles_band_backward_sweep_f32 if backward else lib.stiles_band_forward_sweep_f32
    ptr = lambda x: None if x is None else x.data_ptr()
    ndt, b1, t = Dr.shape[-4:-1]
    code = fn(Dr.data_ptr(), R.data_ptr(), rhs.data_ptr(),
              *((ptr(xa), out.data_ptr()) if backward else (out.data_ptr(), ptr(acca))),
              _plan_table(plan, Dr.device).data_ptr(), plan.cluster, plan.width,
              math.prod(Dr.shape[:-4]), ndt, b1 - 1, R.shape[-3], t, plan.k, int(start_tile),
              plan.lead(backward), torch.cuda.current_stream(Dr.device).cuda_stream)
    _build.check(lib, code, name)


@_build.counted(lambda Dr, R, bd, *a, **kw: _build.batch(Dr, 4, k=bd.shape[-1]))
def band_forward_sweep_cuda(Dr: torch.Tensor, R: torch.Tensor, bd: torch.Tensor,
                            start_tile: int = 0, *, max_cluster: int = SOLVE_CLUSTER,
                            width: Optional[int] = None):
    """``L Y = B`` over the band on the card: ``Dr (ndt, bt+1, t, t)``,
    ``R (ndt, nat, t, t)``, ``bd (ndt, t, k)`` -> ``(yd (ndt, t, k),
    acc_a (nat, t, k))`` with ``acc_a[i] = sum_m R[m, i] @ Y_m``.  Rows
    ``m < start_tile`` come out zero.  One launch on the plan
    ``card_solve_plan(t, bt, nat, k, max_cluster, batch=B)``; a cluster the
    card refuses raises.  A leading batch axis ``(B, ...)`` on every input
    is one launch for the batch, and both outputs gain it.  ``width``
    forces the chunk width (for comparing a batch with its unbatched
    launches on one plan)."""
    t = _check_band("band_forward_sweep", Dr, R, bd)
    lead = tuple(Dr.shape[:-4])
    ndt, nat, k = Dr.shape[-4], R.shape[-3], bd.shape[-1]
    if bd.shape[-3] != ndt:
        raise ValueError(f"band_forward_sweep: bd has {bd.shape[-3]} rows, Dr {ndt}")
    if ndt == 0 or k == 0:
        return torch.zeros_like(bd), bd.new_zeros(lead + (nat, t, k))
    plan = _plan(Dr, nat, k, max_cluster, width)
    # the kernel writes every output element, so nothing is zeroed here
    yd = torch.empty_like(bd)
    acca = bd.new_empty(lead + (nat, t, k))
    _launch("band_forward_sweep", plan, False, Dr, R, bd, None, yd, acca, start_tile)
    return yd, acca


@_build.counted(lambda Dr, R, yd, *a, **kw: _build.batch(Dr, 4, k=yd.shape[-1]))
def band_backward_sweep_cuda(Dr: torch.Tensor, R: torch.Tensor, yd: torch.Tensor,
                             xa: torch.Tensor, start_tile: int = 0, *,
                             max_cluster: int = SOLVE_CLUSTER,
                             width: Optional[int] = None) -> torch.Tensor:
    """``L^T X = Y - R^T Xa`` over the band on the card, rows in reverse:
    ``Dr``, ``R`` as in the forward sweep, ``yd (ndt, t, k)`` and the
    solved arrow panel ``xa (nat, t, k)`` -> ``xd (ndt, t, k)``.  Rows
    ``m < start_tile`` come out zero.  The kernel reads ``L[m+j, m]`` in
    place as ``Dr[m+j, j]``; the plan is the forward sweep's, and so are
    the batch axis and ``width``."""
    t = _check_band("band_backward_sweep", Dr, R, yd, xa)
    ndt, nat, k = Dr.shape[-4], R.shape[-3], yd.shape[-1]
    if yd.shape[-3] != ndt or xa.shape[-3] != nat:
        raise ValueError(f"band_backward_sweep: yd has {yd.shape[-3]} rows and xa "
                         f"{xa.shape[-3]}, want {ndt} and {nat}")
    if ndt == 0 or k == 0:
        return torch.zeros_like(yd)
    plan = _plan(Dr, nat, k, max_cluster, width)
    xd = torch.empty_like(yd)
    _launch("band_backward_sweep", plan, True, Dr, R, yd, xa, xd, None, start_tile)
    return xd
