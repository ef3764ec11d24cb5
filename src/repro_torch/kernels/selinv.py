"""CUDA kernels of the selected inversion: the whole backward Takahashi
recurrence in one launch, ``csrc/selinv.cu``, and its one-column tile step,
``csrc/selinv_step.cu``.

:func:`selinv_sweep_cuda` ports the TPU kernel
``repro/kernels/selinv.py::selinv_sweep_pallas``.
One block walks the columns j = ndt-1..0, seeds ``L_jj^{-1}`` in the kernel
(``csrc/tile.cuh::substitute_panel`` against the identity) and reads the
last ``band_tiles`` Σ columns back from its own outputs (they stay in L2)
instead of a VMEM ring.  Outputs and semantics match
``ref.selinv_sweep_ref``, the ``start_tile`` identity prefix included.

:func:`selinv_step_cuda` ports ``selinv_step_pallas``, the standalone tile
primitive ``ops.selinv_step``: ``u[e] = sum_j s_row[e, j] g_col[j]``, as
``ref.selinv_step_ref`` defines it, a cluster launch of the tile sum
``csrc/tile_sum.cuh`` on the plan of :func:`.tile_sum.tile_sum_plan`.
"""
from __future__ import annotations

import torch

from . import _build
from .potrf import check_tiles
from .tile_sum import tile_sum_plan

__all__ = ["selinv_sweep_cuda", "selinv_step_cuda"]


def selinv_sweep_cuda(lcol: torch.Tensor, R: torch.Tensor, sc_full: torch.Tensor,
                      start_tile: int = 0):
    """``lcol (ndt, bt+1, t, t)`` column view of the factor, ``R (ndt, nat,
    t, t)`` arrow rows and ``sc_full (nat, nat, t, t)`` the full corner Σ
    -> ``(panels (ndt, bt+1, t, t), acols (ndt, nat, t, t))`` on the card,
    ``panels[j, e] = Σ[j+e, j]`` and ``acols[j, i] = Σ[ndt+i, j]``."""
    t = check_tiles("selinv_sweep", lcol, R, sc_full)
    if (lcol.dim() != 4 or R.dim() != 4 or sc_full.dim() != 4
            or R.shape[0] != lcol.shape[0] or sc_full.shape[:2] != (R.shape[1], R.shape[1])):
        raise ValueError(f"selinv_sweep: want lcol (ndt, bt+1, t, t), R (ndt, nat, t, t) "
                         f"and sc_full (nat, nat, t, t), got {tuple(lcol.shape)}, "
                         f"{tuple(R.shape)} and {tuple(sc_full.shape)}")
    ndt, b1 = lcol.shape[:2]
    nat = R.shape[1]
    panels = torch.empty_like(lcol)
    acols = torch.empty_like(R)
    if ndt == 0:
        return panels, acols
    # scratch: L_jj^{-1}, then G_1..G_bt, then Ga_0..Ga_{nat-1}
    work = lcol.new_empty((b1 + nat, t, t))
    lib = _build.load("selinv")
    stream = torch.cuda.current_stream(lcol.device).cuda_stream
    _build.check(lib, lib.stiles_selinv_sweep_f32(
        lcol.data_ptr(), R.data_ptr(), sc_full.data_ptr(), work.data_ptr(),
        panels.data_ptr(), acols.data_ptr(), ndt, b1 - 1, nat, t, int(start_tile),
        stream), "selinv_sweep")
    selinv_sweep_cuda.launches += 1
    return panels, acols


selinv_sweep_cuda.launches = 0


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
    selinv_step_cuda.launches += 1
    return u


selinv_step_cuda.launches = 0
