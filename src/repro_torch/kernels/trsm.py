"""CUDA kernel: off-diagonal tile solve (TRSM), ``csrc/trsm.cu``.

Port of the TPU kernel ``repro/kernels/trsm.py::trsm_pallas``: ``X = A
L^{-T}`` for a batch of tiles, one L for all of them or one per tile.
Each warp solves eight rows of ``X L^T = A`` together, its lanes owning
the columns and each solved entry broadcast by shuffle
(``csrc/tile.cuh::substitute_right_rows``, shared with the band-Cholesky
sweep).  The plain version is ``ref.trsm_ref``; ``ops.trsm`` chooses
between them by device.  ``solve_panel_pallas`` is not ported yet.
"""
from __future__ import annotations

import torch

from . import _build
from .potrf import check_tiles

__all__ = ["trsm_cuda"]


def trsm_cuda(l_kk: torch.Tensor, a_mk: torch.Tensor) -> torch.Tensor:
    """``X = A L^{-T}`` on the card.  ``l_kk`` is one (t, t) tile for the
    whole (..., t, t) batch ``a_mk``, or has the batch's shape."""
    t = check_tiles("trsm", l_kk, a_mk)
    batched = l_kk.dim() > 2
    if batched and l_kk.shape != a_mk.shape:
        raise ValueError(f"trsm: L {tuple(l_kk.shape)} is neither one tile "
                         f"nor the shape of A {tuple(a_mk.shape)}")
    out = torch.empty_like(a_mk)
    nb = a_mk.numel() // (t * t)
    if nb == 0:
        return out
    lib = _build.load("trsm")
    stream = torch.cuda.current_stream(a_mk.device).cuda_stream
    _build.check(lib, lib.stiles_trsm_f32(l_kk.data_ptr(), a_mk.data_ptr(),
                                          out.data_ptr(), nb, t, int(batched),
                                          stream), "trsm")
    trsm_cuda.launches += 1
    return out


trsm_cuda.launches = 0
