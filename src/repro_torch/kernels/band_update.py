"""CUDA kernel: the band-panel update of the legacy window sweep,
``csrc/band_update.cu``.

:func:`band_update_cuda` ports the TPU kernel
``repro/kernels/band_update.py::band_update_pallas``: for a band window
``w (b+1, b+1, t, t)``, ``w[e, d] = L[k+e, k+e-d]``, the tiles
``u[e] = sum_{j=1..b-e} w[e, e+j] w[0, j]^T`` over only the structurally
nonzero pairs, a cluster launch of the tile sum ``csrc/tile_sum.cuh`` on
the plan of :func:`.tile_sum.tile_sum_plan`.  A leading batch axis runs in
the same launch, and the window is read where it lies: a slice of a
batch's padded band rows is strided along the batch, and the kernel takes
that stride instead of a copy.  The plain versions are
``ref.band_update_unrolled_ref`` and ``ref.band_update_ref``;
``ops.band_update`` chooses by device.
"""
from __future__ import annotations

import torch

from . import _build
from .potrf import TILE_SIZES, check_cuda
from .tile_sum import tile_sum_plan

__all__ = ["band_update_cuda"]


@_build.counted(lambda w: _build.batch(w, 4))
def band_update_cuda(w: torch.Tensor) -> torch.Tensor:
    """``w (b+1, b+1, t, t)`` or a batch ``(B, b+1, b+1, t, t)`` -> ``u
    (..., b+1, t, t)`` on the card.  Each window's tiles must be contiguous;
    the windows of a batch may lie at any stride (a multiple of 4 floats).

    One launch: grid ``(CL * (t / S)^2, b+1, B)`` in clusters of ``CL =
    min(b, 4)`` blocks (1 when ``b = 0``), ``S = min(t, 32)``.  Block ``(x,
    e, i)`` sums sub-tile ``x // CL`` of element ``i``'s ``u[e]`` over rank
    ``x % CL``'s contiguous run of ``ceil(b / CL)`` of the pairs ``j =
    1..b-e``; rank 0 adds the ranks' partials in rank order (distributed
    shared memory), so two launches give the same bits and each batch
    element those of its unbatched launch.  At Table II #5's ``(5, 5, 64,
    64)``: 80 blocks, 40 with one pair each; the bound is bytes, 246 KB,
    0.073 us at the memory rate."""
    check_cuda("band_update", w, contiguous=False)
    if (w.dim() not in (4, 5) or w.shape[-4] != w.shape[-3] or w.shape[-4] < 1
            or w.shape[-1] != w.shape[-2] or w.shape[-1] not in TILE_SIZES):
        raise ValueError(f"band_update: want (..., b+1, b+1, t, t) windows with t in "
                         f"{TILE_SIZES}, got {tuple(w.shape)}")
    wb = w if w.dim() == 5 else w[None]
    batch, b1, t = wb.shape[0], wb.shape[1], wb.shape[-1]
    u = torch.empty((batch, b1, t, t), dtype=w.dtype, device=w.device)
    if batch:
        if not wb[0].is_contiguous() or wb.stride(0) % 4:
            raise ValueError("band_update: each window's tiles must be contiguous, and "
                             "the batch stride a multiple of 4 floats")
        if batch > 65535:
            raise ValueError(f"band_update: at most 65535 windows, got {batch}")
        plan = tile_sum_plan(t, [b1 - 1 - e for e in range(b1)], batch)
        lib = _build.load("band_update")
        stream = torch.cuda.current_stream(w.device).cuda_stream
        _build.check(lib, lib.stiles_band_update_f32(
            wb.data_ptr(), u.data_ptr(), batch, b1, t, wb.stride(0), plan.sub, plan.cluster,
            plan.per_rank, stream), "band_update")
    return u if w.dim() == 5 else u[0]
