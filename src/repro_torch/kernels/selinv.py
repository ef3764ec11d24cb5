"""CUDA kernels of the selected inversion: the whole backward Takahashi
recurrence, ``csrc/selinv.cu``, and its one-column tile step,
``csrc/selinv_step.cu``.

:func:`selinv_sweep_cuda` ports the TPU kernel
``repro/kernels/selinv.py::selinv_sweep_pallas`` as two launches:

- the pre-pass, :func:`selinv_prepass_cuda`, a block a column on the whole
  card, computes what a column needs of the factor and the corner seed
  alone (``ref.selinv_prepass_ref``: ``W = L_jj^{-1}``, the normalized
  column ``G``/``Ga``, ``W^T W`` and the corner part of the arrow targets);
- the recurrence, one thread-block cluster walking the columns j =
  ndt-1..0 on the plan of :func:`selinv_plan`, two or three cluster
  barriers a column: the column's band and arrow targets (independent of
  one another given G) spread over the ranks, then its diagonal.

Outputs and semantics match ``ref.selinv_sweep_ref``, the ``start_tile``
identity prefix included: the pre-pass fills a prefix column's work tiles
without computing, and the recurrence writes its identity panel and zero
arrow row and walks only the columns from ``start_tile`` on.  A leading batch axis (the θ-batch's factors) is
the same two launches: the pre-pass a block for each column of each
element, the recurrence a cluster for each element on the same plan, the
element's pointer offsets the only change, so element i is bit for bit its
unbatched launch.

:func:`selinv_step_cuda` ports ``selinv_step_pallas``, the standalone tile
primitive ``ops.selinv_step``: ``u[e] = sum_j s_row[e, j] g_col[j]``, as
``ref.selinv_step_ref`` defines it, a cluster launch of the tile sum
``csrc/tile_sum.cuh`` on the plan of :func:`.tile_sum.tile_sum_plan`.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import math

import torch

from . import _build
from .band_cholesky import MAX_BATCH
from .potrf import check_tiles
from .tile_sum import SUB, tile_sum_plan

__all__ = ["selinv_sweep_cuda", "selinv_prepass_cuda", "selinv_step_cuda", "SelinvPlan",
           "selinv_plan", "SELINV_CLUSTER", "MAX_SELINV_CLUSTER"]

SELINV_CLUSTER = 16         # the recurrence's cluster: the largest the card allows
MAX_SELINV_CLUSTER = 16     # (non-portable; 8 is the portable size)


@dataclass(frozen=True)
class SelinvPlan:
    """How the recurrence spreads one column over a cluster of ``cluster``
    blocks.  Every target tile (``bt`` band tiles, then ``nat`` arrow
    tiles) is split into ``sub x sub`` sub-tiles, the *units*; rank r
    computes units r, r + cluster, ... whole, each over its pairs in order.
    The diagonal is summed over its lower sub-tiles (the upper ones are
    their transposes): sub-tile s goes to ranks ``s * diag_split ..
    (s + 1) * diag_split - 1``, which take contiguous, ordered runs of its
    pairs; the first of them adds the others' partials in rank order."""
    t: int
    bt: int
    nat: int
    sub: int
    cluster: int
    diag_split: int

    @property
    def ns(self) -> int:
        """Sub-tiles per edge."""
        return self.t // self.sub

    @property
    def units(self) -> int:
        """Target sub-tiles of a column."""
        return (self.bt + self.nat) * self.ns ** 2

    @property
    def diag_subtiles(self) -> int:
        """Lower sub-tiles of the diagonal tile (row-major: (0, 0), (1, 0),
        (1, 1), ...)."""
        return self.ns * (self.ns + 1) // 2

    def target_units(self, rank: int) -> range:
        """The units rank ``rank`` computes, in order."""
        return range(rank, self.units, self.cluster)

    def target_pairs(self, dmax: int, target: int) -> range:
        """The pairs of one target of a column with ``dmax`` band tiles below
        it, in order: a band target ``e = target + 1 <= dmax`` sums ``dmax``
        band pairs and ``nat`` arrow pairs, an arrow target ``dmax`` band
        pairs after its corner part, a band target past the matrix none."""
        if target < self.bt:
            return range(dmax + self.nat) if target + 1 <= dmax else range(0)
        return range(dmax)

    def diag_share(self, rank: int, dmax: int) -> Tuple[Optional[int], range]:
        """``(lower sub-tile, run of its pairs)`` rank ``rank`` sums for the
        diagonal of a column with ``dmax`` band tiles below it: the pairs
        are ``dmax`` band then ``nat`` arrow pairs, cut into runs of
        ``ceil(n / diag_split)``.  ``(None, range(0))`` for a rank with no
        share."""
        s, k = divmod(rank, self.diag_split)
        if s >= self.diag_subtiles:
            return None, range(0)
        n = dmax + self.nat
        per = -(-n // self.diag_split)
        lo = min(k * per, n)
        return s, range(lo, min(lo + per, n))


def selinv_plan(t: int, bt: int, nat: int, max_cluster: int = SELINV_CLUSTER) -> SelinvPlan:
    """The recurrence's plan: a cluster of ``min(max_cluster, units)``
    blocks, but at least one a lower sub-tile of the diagonal, and the
    diagonal's pairs split ``cluster // diag_subtiles`` ways."""
    if not 1 <= max_cluster <= MAX_SELINV_CLUSTER or bt < 0 or nat < 0:
        raise ValueError(f"selinv_plan: want 1 <= max_cluster <= {MAX_SELINV_CLUSTER} and "
                         f"bt, nat >= 0, got {max_cluster}, {bt}, {nat}")
    sub = min(t, SUB)
    ns = t // sub
    diag = ns * (ns + 1) // 2
    cluster = max(diag, min(max_cluster, (bt + nat) * ns * ns))
    return SelinvPlan(t=t, bt=bt, nat=nat, sub=sub, cluster=cluster,
                      diag_split=cluster // diag)


def _check_sweep_inputs(name: str, lcol: torch.Tensor, R: torch.Tensor,
                        sc_full: torch.Tensor) -> int:
    """``lcol ([B,] ndt, bt+1, t, t)``, ``R ([B,] ndt, nat, t, t)`` and
    ``sc_full ([B,] nat, nat, t, t)``, one batch for all; returns t."""
    t = check_tiles(name, lcol, R, sc_full)
    lead = lcol.shape[:-4]
    if (lcol.dim() not in (4, 5) or R.dim() != lcol.dim() or sc_full.dim() != lcol.dim()
            or R.shape[:-3] != lcol.shape[:-3]
            or sc_full.shape[:-2] != lead + (R.shape[-3], R.shape[-3])):
        raise ValueError(f"{name}: want lcol ([B,] ndt, bt+1, t, t), R ([B,] ndt, nat, t, t) "
                         f"and sc_full ([B,] nat, nat, t, t), got {tuple(lcol.shape)}, "
                         f"{tuple(R.shape)} and {tuple(sc_full.shape)}")
    if lead and not 1 <= lead[0] <= MAX_BATCH:
        raise ValueError(f"{name}: a batch of {lead[0]}, the kernel takes 1 to {MAX_BATCH}")
    return t


@_build.counted(lambda lcol, *a, **kw: _build.batch(lcol, 4))
def selinv_prepass_cuda(lcol: torch.Tensor, R: torch.Tensor, sc_full: torch.Tensor,
                        start_tile: int = 0) -> torch.Tensor:
    """The sweep's pre-pass on the card: ``work (ndt, bt + 2 nat + 2, t,
    t)`` as ``ref.selinv_prepass_ref`` defines it, one launch of a block a
    column (``ndt >= 1``); with a leading batch axis, of a block for each
    column of each element."""
    t = _check_sweep_inputs("selinv_prepass", lcol, R, sc_full)
    lead = tuple(lcol.shape[:-4])
    ndt, b1 = lcol.shape[-4:-2]
    nat = R.shape[-3]
    if ndt == 0:
        raise ValueError("selinv_prepass: want ndt >= 1")
    work = lcol.new_empty(lead + (ndt, b1 + 2 * nat + 1, t, t))
    lib = _build.load("selinv")
    stream = torch.cuda.current_stream(lcol.device).cuda_stream
    _build.check(lib, lib.stiles_selinv_prepass_f32(
        lcol.data_ptr(), R.data_ptr(), sc_full.data_ptr(), work.data_ptr(), math.prod(lead),
        ndt, b1 - 1, nat, t, int(start_tile), stream), "selinv_prepass")
    return work


@_build.counted(lambda lcol, *a, **kw: _build.batch(lcol, 4))
def selinv_sweep_cuda(lcol: torch.Tensor, R: torch.Tensor, sc_full: torch.Tensor,
                      start_tile: int = 0, *, max_cluster: int = SELINV_CLUSTER,
                      work: Optional[torch.Tensor] = None):
    """``lcol (ndt, bt+1, t, t)`` column view of the factor, ``R (ndt, nat,
    t, t)`` arrow rows and ``sc_full (nat, nat, t, t)`` the full corner Σ
    -> ``(panels (ndt, bt+1, t, t), acols (ndt, nat, t, t))`` on the card,
    ``panels[j, e] = Σ[j+e, j]`` and ``acols[j, i] = Σ[ndt+i, j]``.

    Two launches: :func:`selinv_prepass_cuda`, then the recurrence, one
    cluster on the plan ``selinv_plan(t, bt, nat, max_cluster)``; a
    cluster the card refuses raises.  ``work`` is a pre-pass result to
    start from (the recurrence alone, one launch).  A leading batch axis
    ``(B, ...)`` on the inputs is the same two launches, a cluster an
    element, and the outputs gain it."""
    t = _check_sweep_inputs("selinv_sweep", lcol, R, sc_full)
    lead = tuple(lcol.shape[:-4])
    ndt, b1 = lcol.shape[-4:-2]
    nat = R.shape[-3]
    panels = torch.empty_like(lcol)
    acols = torch.empty_like(R)
    if ndt == 0:
        return panels, acols
    if work is None:
        work = selinv_prepass_cuda(lcol, R, sc_full, start_tile)
    elif work.shape != lead + (ndt, b1 + 2 * nat + 1, t, t):
        raise ValueError(f"selinv_sweep: work {tuple(work.shape)} is not the pre-pass of "
                         f"these inputs")
    check_tiles("selinv_sweep", work)
    plan = selinv_plan(t, b1 - 1, nat, max_cluster)
    lib = _build.load("selinv")
    stream = torch.cuda.current_stream(lcol.device).cuda_stream
    _build.check(lib, lib.stiles_selinv_sweep_f32(
        work.data_ptr(), panels.data_ptr(), acols.data_ptr(), math.prod(lead), ndt, b1 - 1,
        nat, t, plan.cluster, plan.diag_split, int(start_tile), stream), "selinv_sweep")
    return panels, acols


@_build.counted(lambda s_row, g_col: _build.batch(s_row, 3))
def selinv_step_cuda(s_row: torch.Tensor, g_col: torch.Tensor) -> torch.Tensor:
    """``s_row (e_n, j_n, t, t)`` Σ tiles and ``g_col (j_n, t, t)`` the
    normalized factor column -> ``u (e_n, t, t)``, ``u[e] = sum_j s_row[e,
    j] @ g_col[j]``, on the card; zeros without a launch when ``e_n`` or
    ``j_n`` is 0, as the reference's kernel returns them.

    One launch: grid ``(CL * (t / S)^2, e_n)`` in clusters of ``CL =
    min(j_n, 4)`` blocks, ``S = min(t, 32)``.  Block ``(x, e)`` sums sub-tile
    ``x // CL`` of ``u[e]`` over rank ``x % CL``'s contiguous run of
    ``ceil(j_n / CL)`` pairs, and rank 0 adds the ranks' partials in rank
    order (distributed shared memory), so two launches give the same bits.
    At Table II #5's ``(8, 8, 64, 64)``: 128 blocks of 32 x 32 x 128; the
    bound is operations, 33.6 Mflop, 0.50 us at the fp32 rate."""
    t = check_tiles("selinv_step", s_row, g_col)
    if s_row.dim() != 4 or g_col.dim() != 3 or s_row.shape[1] != g_col.shape[0]:
        raise ValueError(f"selinv_step: want s_row (e_n, j_n, t, t) and g_col (j_n, t, t), "
                         f"got {tuple(s_row.shape)} and {tuple(g_col.shape)}")
    e_n, j_n = s_row.shape[:2]
    if e_n == 0 or j_n == 0:
        return s_row.new_zeros((e_n, t, t))
    if e_n > 65535:
        raise ValueError(f"selinv_step: at most 65535 rows, got {e_n}")
    u = s_row.new_empty((e_n, t, t))
    plan = tile_sum_plan(t, [j_n] * e_n)
    lib = _build.load("selinv_step")
    stream = torch.cuda.current_stream(s_row.device).cuda_stream
    _build.check(lib, lib.stiles_selinv_step_f32(
        s_row.data_ptr(), g_col.data_ptr(), u.data_ptr(), e_n, j_n, t, plan.sub,
        plan.cluster, plan.per_rank, stream), "selinv_step")
    return u
