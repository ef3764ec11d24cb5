"""CUDA kernel: the whole backward Takahashi recurrence in one launch,
``csrc/selinv.cu``.

Port of the TPU kernel ``repro/kernels/selinv.py::selinv_sweep_pallas``.
One block walks the columns j = ndt-1..0, seeds ``L_jj^{-1}`` in the kernel
(``csrc/tile.cuh::substitute_panel`` against the identity) and reads the
last ``band_tiles`` Σ columns back from its own outputs (they stay in L2)
instead of a VMEM ring.  Outputs and semantics match
``ref.selinv_sweep_ref``, the ``start_tile`` identity prefix included.
``selinv_step_pallas`` is not ported yet: only its plain version is, as
the plain sweep's step.
"""
from __future__ import annotations

import torch

from . import _build
from .potrf import check_tiles

__all__ = ["selinv_sweep_cuda"]


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
