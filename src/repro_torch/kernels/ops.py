"""Tile-kernel entry points, dispatched by device.

``impl=None`` takes the plain version (``ref.py``) for a tensor on the CPU
and the CUDA kernel for a tensor on the card; there is no fallback from
one to the other.  ``impl="ref"`` forces the plain version on any device
(``chip_smoke.py`` uses it to check the kernels); ``impl="cuda"`` forces
the kernel, and raises for a CPU tensor.
"""
from __future__ import annotations

from typing import Optional

import torch

from . import ref
from .band_cholesky import band_cholesky_sweep_cuda
from .potrf import potrf_cuda
from .trsm import trsm_cuda

__all__ = ["potrf", "trsm", "band_cholesky_sweep", "resolve_impl", "IMPLS"]

IMPLS = ("ref", "cuda")


def resolve_impl(impl: Optional[str], x: torch.Tensor) -> str:
    """The backend a call on ``x`` runs: ``impl`` if given, else by device."""
    if impl is None:
        if x.device.type == "cuda":
            return "cuda"
        if x.device.type == "cpu":
            return "ref"
        raise ValueError(f"no kernel backend for device {x.device}")
    if impl not in IMPLS:
        raise ValueError(f"unknown impl {impl!r} (want one of {IMPLS} or None)")
    return impl


def potrf(a: torch.Tensor, impl: Optional[str] = None) -> torch.Tensor:
    """Cholesky of a (..., t, t) batch of SPD tiles."""
    if resolve_impl(impl, a) == "cuda":
        return potrf_cuda(a)
    return ref.potrf_ref(a)


def trsm(l_kk: torch.Tensor, a_mk: torch.Tensor,
         impl: Optional[str] = None) -> torch.Tensor:
    """``X = A L^{-T}`` for a (..., t, t) batch of A against one L."""
    if resolve_impl(impl, a_mk) == "cuda":
        return trsm_cuda(l_kk, a_mk)
    return ref.trsm_ref(l_kk, a_mk)


def band_cholesky_sweep(Ac: torch.Tensor, R: torch.Tensor, nchunks: int = 1,
                        start_tile: int = 0, impl: Optional[str] = None):
    """Whole band+arrow Cholesky factorization as one sweep: ``Ac (ndt,
    bt+1, t, t)`` column-band tiles and ``R (ndt, nat, t, t)`` arrow rows
    -> ``(panels, R_out, schur, status)``: column panels of L, factored
    arrow rows, per-chunk corner-Schur partial sums and the (3,) float32
    status word ``[min_pivot, nonfinite, first_bad]``.  ``"cuda"`` is one
    kernel launch; ``"ref"`` the column loop of ``ref.py``."""
    if resolve_impl(impl, Ac) == "cuda":
        return band_cholesky_sweep_cuda(Ac, R, nchunks=nchunks,
                                        start_tile=start_tile)
    return ref.band_cholesky_sweep_ref(Ac, R, nchunks=nchunks,
                                       start_tile=start_tile)
