"""CUDA kernel: Cholesky of SPD tiles (POTRF), ``csrc/potrf.cu``.

Port of the TPU kernel ``repro/kernels/potrf.py::potrf_pallas``.  The tile
sits in shared memory and is factored in panels of 16 columns
(``csrc/tile.cuh::factorize_smem``, shared with the band-Cholesky sweep);
one block per tile of the batch.  The plain version is
``ref.potrf_ref``; ``ops.potrf`` chooses between them by device.
"""
from __future__ import annotations

import functools
from typing import Optional

import torch

from . import _build

__all__ = ["potrf_cuda", "check_cuda", "check_tiles", "check_out", "sm_count", "TILE_SIZES"]

TILE_SIZES = (8, 16, 32, 64)


def check_cuda(name: str, *tensors: torch.Tensor, aligned: bool = True,
               contiguous: bool = True) -> None:
    """Validate float32 CUDA tensors, contiguous unless ``contiguous`` is
    False (the caller checks their strides) and 16-byte aligned unless
    ``aligned`` is False (what a kernel reads a word at a time)."""
    for x in tensors:
        if x.device.type != "cuda":
            raise ValueError(f"{name}: the CUDA kernel needs CUDA tensors, "
                             f"got {x.device}")
        if x.dtype != torch.float32:
            raise ValueError(f"{name}: float32 only, got {x.dtype}")
        if contiguous and not x.is_contiguous():
            raise ValueError(f"{name}: inputs must be contiguous")
        if aligned and x.data_ptr() % 16:
            raise ValueError(f"{name}: inputs must be 16-byte aligned")


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def sm_count(device: torch.device) -> int:
    """The SM count of the card ``device``, asked once a card."""
    index = device.index if device.index is not None else torch.cuda.current_device()
    return _sm_count(index)


def check_tiles(name: str, *tensors: torch.Tensor) -> int:
    """:func:`check_cuda` for tensors of (..., t, t) tiles with t in
    :data:`TILE_SIZES`; returns t."""
    check_cuda(name, *tensors)
    t = tensors[0].shape[-1]
    for x in tensors:
        if x.dim() < 2 or x.shape[-1] != t or x.shape[-2] != t:
            raise ValueError(f"{name}: want (..., {t}, {t}) tiles, got "
                             f"{tuple(x.shape)}")
    if t not in TILE_SIZES:
        raise ValueError(f"{name}: tile size {t} not supported "
                         f"(want one of {TILE_SIZES})")
    return t


def check_out(name: str, like: torch.Tensor, out) -> torch.Tensor:
    """``out`` checked to take a result shaped like ``like``, or a new
    tensor when it is None."""
    if out is None:
        return torch.empty_like(like)
    check_cuda(name, out)
    if out.shape != like.shape:
        raise ValueError(f"{name}: out {tuple(out.shape)} is not the result's shape "
                         f"{tuple(like.shape)}")
    return out


@_build.counted(lambda a, *args, **kw: _build.tiles(a))
def potrf_cuda(a: torch.Tensor, out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Cholesky of a (..., t, t) batch of SPD tiles on the card: L lower
    (zeros above the diagonal); a non-positive pivot gives NaN from that
    column on.  ``out`` takes the result in place of a new tensor and may be
    ``a`` itself: each element is read and then written by one thread."""
    t = check_tiles("potrf", a)
    out = check_out("potrf", a, out)
    nb = a.numel() // (t * t)
    if nb == 0:
        return out
    lib = _build.load("potrf")
    stream = torch.cuda.current_stream(a.device).cuda_stream
    _build.check(lib, lib.stiles_potrf_f32(a.data_ptr(), out.data_ptr(), nb, t,
                                           stream), "potrf")
    return out
