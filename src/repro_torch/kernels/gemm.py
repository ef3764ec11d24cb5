"""CUDA kernels: the task list's tile updates, ``csrc/gemm.cu``.

Ports of the TPU kernels ``repro/kernels/gemm.py``: :func:`gemm_cuda`
(``gemm_pallas``, ``C - A B^T``), :func:`syrk_cuda` (``syrk_pallas``,
``C - A A^T`` over the full tile) and :func:`geadd_cuda` (``geadd_pallas``,
``A + B``, the Alg. 3 tree-reduction combine).  GEMM and SYRK spread each
output tile over several blocks, a ``sub x sub`` piece each (see
:func:`gemm_split`), the product in plain FP32 FMAs; GEADD is a vectorised
elementwise add on at most one block an SM, launched as a programmatic
dependent launch, so that its launch overlaps the tail of the kernel
before it (the tree's levels are a chain of geadd).  The
plain versions are ``ref.gemm_ref``, ``ref.syrk_ref`` and
``ref.geadd_ref``; ``ops`` chooses by device.
"""
from __future__ import annotations

import ctypes
import math
from typing import Dict, Optional, Tuple

import torch

from . import _build
from .potrf import TILE_SIZES, check_cuda, check_out, check_tiles, sm_count

__all__ = ["gemm_cuda", "syrk_cuda", "geadd_cuda", "geadd_floor_cuda", "gemm_split",
           "GEMM_SPLITS", "cuda_versions"]

# blocks a tile: pieces of sub x sub, sub = t / sqrt(split) >= 8
GEMM_SPLITS: Dict[int, Tuple[int, ...]] = {t: tuple(4 ** i for i in range(4) if t >> i >= 8)
                                           for t in TILE_SIZES}


def gemm_split(t: int, split: Optional[int] = None) -> Tuple[int, int]:
    """``(split, sub)`` of ``csrc/gemm.cu``'s product on tiles of ``t x t``:
    ``split`` blocks a tile (one of ``GEMM_SPLITS[t]``), each the ``sub x
    sub`` piece of blockIdx.y in row-major order.  The default is the
    largest split, pieces of 8 x 8, whatever the batch: it was the fastest
    on the task list's one tile and on a batch of five (PERF.md).  Every
    split gives the same bits."""
    if t not in GEMM_SPLITS:
        raise ValueError(f"gemm: tile size {t} not supported (want one of {TILE_SIZES})")
    if split is None:
        split = GEMM_SPLITS[t][-1]
    elif split not in GEMM_SPLITS[t]:
        raise ValueError(f"gemm: split {split} not supported at t = {t} "
                         f"(want one of {GEMM_SPLITS[t]})")
    return split, t // math.isqrt(split)


def _tile_batch(x: torch.Tensor, batch_shape, t: int) -> Tuple[torch.Tensor, int]:
    """``x`` (contiguous, broadcasting against ``batch_shape`` tiles) as a
    base tensor and a uniform tile stride in floats: 0 for one tile against
    the whole batch, ``t * t`` for a batch of the same shape; any other
    broadcast is materialised."""
    nb = 1
    for d in batch_shape:
        nb *= d
    if x.numel() == t * t:
        return x, 0
    if x.numel() == nb * t * t:
        return x, t * t
    return x.expand(tuple(batch_shape) + (t, t)).contiguous(), t * t


def _broadcasts(x: torch.Tensor, c: torch.Tensor) -> bool:
    try:
        return torch.broadcast_shapes(x.shape, c.shape) == c.shape
    except RuntimeError:
        return False


def _launch(name: str, c, a, b, out, split) -> torch.Tensor:
    if not (_broadcasts(a, c) and _broadcasts(b, c)):
        raise ValueError(f"{name}: A {tuple(a.shape)} and B {tuple(b.shape)} must "
                         f"broadcast against C {tuple(c.shape)}")
    t = check_tiles(name, c, a, b)
    out = check_out(name, c, out)
    batch = tuple(c.shape[:-2])
    nb = c.numel() // (t * t)
    if nb == 0:
        return out
    _, sub = gemm_split(t, split)
    if nb > 2 ** 31 - 1:
        raise ValueError(f"{name}: at most 2^31 - 1 tiles, got {nb}")
    (a, sa), (b, sb) = _tile_batch(a, batch, t), _tile_batch(b, batch, t)
    lib = _build.load("gemm")
    stream = torch.cuda.current_stream(c.device).cuda_stream
    _build.check(lib, lib.stiles_gemm_f32(c.data_ptr(), a.data_ptr(), b.data_ptr(),
                                          out.data_ptr(), nb, sa, sb, t, sub, stream), name)
    return out


@_build.counted(lambda c, *a, **kw: _build.tiles(c))
def gemm_cuda(c: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
              out: Optional[torch.Tensor] = None, *, split: Optional[int] = None) -> torch.Tensor:
    """``C - A B^T`` on the card for a (..., t, t) batch C, with A and B
    each one tile or a batch broadcast against C.  ``out`` (C's shape) takes
    the result in place of a new tensor and may be C itself; it must not
    overlap A or B.  One launch; ``split`` (blocks a tile, see
    :func:`gemm_split`) is for measurement: every split gives the same
    bits."""
    return _launch("gemm", c, a, b, out, split)


@_build.counted(lambda c, *a, **kw: _build.tiles(c))
def syrk_cuda(c: torch.Tensor, a: torch.Tensor,
              out: Optional[torch.Tensor] = None, *, split: Optional[int] = None) -> torch.Tensor:
    """``C - A A^T`` on the card over the full tile, as ``syrk_pallas``
    computes it: the kernel of :func:`gemm_cuda` with B = A; ``out`` and
    ``split`` as there."""
    return _launch("syrk", c, a, a, out, split)


def _operands(x: torch.Tensor) -> Tuple[torch.Tensor, int, int, int]:
    """``x`` as ``outer`` operands of ``inner`` contiguous floats at a uniform
    stride along its first dim: ``(base, stride, outer, inner)``; copied
    first where ``x[i]`` is not contiguous or the stride is not a multiple
    of 4 (a float4)."""
    inner, dense = 1, True
    for size, stride in zip(reversed(x.shape[1:]), reversed(x.stride()[1:])):
        dense &= size == 1 or stride == inner
        inner *= size
    if not dense or x.stride(0) % 4:
        x = x.contiguous()
    return x, x.stride(0), x.shape[0], inner


def _geadd_operands(a: torch.Tensor, b: torch.Tensor):
    if a.shape != b.shape:
        raise ValueError(f"geadd: shapes {tuple(a.shape)} and {tuple(b.shape)} differ")
    if a.dim() < 2 or a.shape[-1] != a.shape[-2] or a.shape[-1] not in TILE_SIZES:
        raise ValueError(f"geadd: want (..., t, t) tiles with t in {TILE_SIZES}, got "
                         f"{tuple(a.shape)}")
    (a, sa, outer, inner), (b, sb, _, _) = _operands(a), _operands(b)
    check_cuda("geadd", a, b, contiguous=False)
    if sa == sb == inner:      # both contiguous: one operand of every float
        outer, inner, sa, sb = 1, outer * inner, outer * inner, outer * inner
    return a, b, sa, sb, outer, inner


@_build.counted(lambda a, *args, **kw: _build.tiles(a))
def geadd_cuda(a: torch.Tensor, b: torch.Tensor, *, pdl: bool = True) -> torch.Tensor:
    """``A + B`` on the card for two (..., t, t) batches of one shape; each
    may be a strided view along its first dim (the tree's even and odd
    partials).  ``pdl`` makes the launch a programmatic dependent one; it
    is for measurement, and both give the same bits.  On by default: the
    tree's three levels over 8 partials in one CUDA graph took 4.12-4.16 us
    with it and 5.28-5.36 without (PERF.md, H100)."""
    a, b, sa, sb, outer, inner = _geadd_operands(a, b)
    out = torch.empty(a.shape, dtype=a.dtype, device=a.device)
    if out.numel() == 0:
        return out
    lib = _build.load("gemm")
    stream = torch.cuda.current_stream(a.device).cuda_stream
    _build.check(lib, lib.stiles_geadd_f32(a.data_ptr(), b.data_ptr(), out.data_ptr(), outer,
                                           inner, sa, sb, sm_count(a.device), int(pdl),
                                           stream),
                 "geadd")
    return out


def geadd_floor_cuda(a: torch.Tensor, b: torch.Tensor, *, pdl: bool = True) -> None:
    """A kernel that does nothing, launched on the grid :func:`geadd_cuda`
    takes for ``a`` and ``b``: the floor of a one-tile launch, for
    measurement only (nothing calls it)."""
    a, _, _, _, outer, inner = _geadd_operands(a, b)
    if outer * inner == 0:
        return
    lib = _build.load("gemm")
    stream = torch.cuda.current_stream(a.device).cuda_stream
    _build.check(lib, lib.stiles_geadd_empty_f32(outer, inner, sm_count(a.device), int(pdl),
                                                 stream), "geadd_floor")


def cuda_versions() -> Tuple[int, int]:
    """``(runtime, driver)``: the CUDA runtime the kernels were built with
    and the card's driver, as CUDA numbers them (12030 is 12.3); a stream
    capture of a programmatic dependent launch needs both at 12.3 or
    later."""
    lib = _build.load("gemm")
    runtime, driver = ctypes.c_int(0), ctypes.c_int(0)
    _build.check(lib, lib.stiles_cuda_versions(ctypes.addressof(runtime),
                                               ctypes.addressof(driver)), "cuda_versions")
    return runtime.value, driver.value
