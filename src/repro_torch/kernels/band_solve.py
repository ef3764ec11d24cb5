"""CUDA kernels: the multi-RHS band sweeps, ``csrc/band_solve.cu``.

Ports of the TPU kernels ``repro/kernels/band_solve.py::
band_forward_sweep_pallas`` and ``band_backward_sweep_pallas``: each sweep
over every band row of the factor in one launch, one block per 32
right-hand-side columns walking the rows in order.  The solved panels the
next rows read are the block's own outputs (they stay in L2) instead of a
VMEM ring.  Outputs and semantics match ``ref.band_forward_sweep_ref`` and
``ref.band_backward_sweep_ref``, ``start_tile`` included.
"""
from __future__ import annotations

import torch

from . import _build
from .potrf import check_cuda, check_tiles
from .ring import band_row_to_col

__all__ = ["band_forward_sweep_cuda", "band_backward_sweep_cuda"]


def _check_band(name: str, Dr: torch.Tensor, R: torch.Tensor, *panels: torch.Tensor) -> int:
    t = check_tiles(name, Dr, R)
    check_cuda(name, *panels, aligned=False)
    if Dr.dim() != 4 or R.dim() != 4 or R.shape[0] != Dr.shape[0]:
        raise ValueError(f"{name}: want Dr (ndt, bt+1, t, t) and R (ndt, nat, t, t), "
                         f"got {tuple(Dr.shape)} and {tuple(R.shape)}")
    k = panels[0].shape[-1]
    for p in panels:
        if p.dim() != 3 or p.shape[1] != t or p.shape[2] != k:
            raise ValueError(f"{name}: want (rows, {t}, {k}) panels, got {tuple(p.shape)}")
    return t


def band_forward_sweep_cuda(Dr: torch.Tensor, R: torch.Tensor, bd: torch.Tensor,
                            start_tile: int = 0):
    """``L Y = B`` over the band on the card: ``Dr (ndt, bt+1, t, t)``,
    ``R (ndt, nat, t, t)``, ``bd (ndt, t, k)`` -> ``(yd (ndt, t, k),
    acc_a (nat, t, k))`` with ``acc_a[i] = sum_m R[m, i] @ Y_m``.  Rows
    ``m < start_tile`` come out zero."""
    t = _check_band("band_forward_sweep", Dr, R, bd)
    ndt, b1 = Dr.shape[:2]
    nat = R.shape[1]
    k = bd.shape[-1]
    if bd.shape[0] != ndt:
        raise ValueError(f"band_forward_sweep: bd has {bd.shape[0]} rows, Dr {ndt}")
    if ndt == 0 or k == 0:
        return torch.zeros_like(bd), bd.new_zeros((nat, t, k))
    # the kernel writes every output element, so nothing is zeroed here
    yd = torch.empty_like(bd)
    acca = bd.new_empty((nat, t, k))
    lib = _build.load("band_solve")
    stream = torch.cuda.current_stream(bd.device).cuda_stream
    _build.check(lib, lib.stiles_band_forward_sweep_f32(
        Dr.data_ptr(), R.data_ptr(), bd.data_ptr(), yd.data_ptr(), acca.data_ptr(),
        ndt, b1 - 1, nat, t, k, int(start_tile), stream), "band_forward_sweep")
    band_forward_sweep_cuda.launches += 1
    return yd, acca


def band_backward_sweep_cuda(Dr: torch.Tensor, R: torch.Tensor, yd: torch.Tensor,
                             xa: torch.Tensor, start_tile: int = 0) -> torch.Tensor:
    """``L^T X = Y - R^T Xa`` over the band on the card, rows in reverse:
    ``Dr``, ``R`` as in the forward sweep, ``yd (ndt, t, k)`` and the
    solved arrow panel ``xa (nat, t, k)`` -> ``xd (ndt, t, k)``.  Rows
    ``m < start_tile`` come out zero.  The kernel reads ``L[m+j, m]``
    through the column view (``ring.band_row_to_col``), built here."""
    t = _check_band("band_backward_sweep", Dr, R, yd, xa)
    ndt, b1 = Dr.shape[:2]
    nat = R.shape[1]
    k = yd.shape[-1]
    if yd.shape[0] != ndt or xa.shape[0] != nat:
        raise ValueError(f"band_backward_sweep: yd has {yd.shape[0]} rows and xa "
                         f"{xa.shape[0]}, want {ndt} and {nat}")
    if ndt == 0 or k == 0:
        return torch.zeros_like(yd)
    lcol = band_row_to_col(Dr)
    xd = torch.empty_like(yd)
    lib = _build.load("band_solve")
    stream = torch.cuda.current_stream(yd.device).cuda_stream
    _build.check(lib, lib.stiles_band_backward_sweep_f32(
        lcol.data_ptr(), R.data_ptr(), yd.data_ptr(), xa.data_ptr(), xd.data_ptr(),
        ndt, b1 - 1, nat, t, k, int(start_tile), stream), "band_backward_sweep")
    band_backward_sweep_cuda.launches += 1
    return xd


band_forward_sweep_cuda.launches = 0
band_backward_sweep_cuda.launches = 0
