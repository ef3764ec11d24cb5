"""CUDA kernels: the triangular tile solves, ``csrc/trsm.cu`` and
``csrc/solve_panel.cu``.

:func:`trsm_cuda` ports the TPU kernel ``repro/kernels/trsm.py::
trsm_pallas``: ``X = A L^{-T}`` for a batch of tiles, one L for all of them,
one per tile or one per group of tiles.  Each block solves one tile of
``X L^T = A`` in panels of 16 columns, a thread a row with ``L`` read as
broadcasts, then one trailing update over the block
(``csrc/tile.cuh::substitute_right``, shared with the band-Cholesky
sweep).

:func:`solve_panel_cuda` ports ``solve_panel_pallas``: ``L X = B`` or
``L^T X = B`` for (..., t, k) panels of any width k, against one L or
one L a panel (the batched solves' corner), a block for each panel and
each chunk of columns (:func:`solve_panel_chunk`), the chunk transposed in
shared memory and solved by the blocked substitution the band-solve sweeps
use (``csrc/tile.cuh::solve_few_rows``).

The plain versions are ``ref.trsm_ref`` and ``ref.solve_panel_ref``;
``ops.trsm`` and ``ops.solve_panel`` choose between them by device.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from . import _build
from .potrf import check_cuda, check_out, check_tiles, sm_count

__all__ = ["trsm_cuda", "solve_panel_cuda", "solve_panel_chunk", "PANEL_CHUNKS"]

PANEL_CHUNKS = (1, 2, 4, 8)   # the chunk widths csrc/solve_panel.cu is built for


@_build.counted(lambda l_kk, a_mk, *a, **kw: _build.tiles(a_mk))
def trsm_cuda(l_kk: torch.Tensor, a_mk: torch.Tensor,
              out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``X = A L^{-T}`` on the card.  ``l_kk`` is one (t, t) tile for the
    whole (..., t, t) batch ``a_mk``, has the batch's shape, or is
    (..., 1, t, t) against a (..., n, t, t) batch: one L for each group of n
    tiles, as a batch of factorizations solves each panel against its own
    diagonal tile.  ``out`` takes the result in place of a new tensor and
    may be ``a_mk`` itself (the tile is read whole into shared memory
    before any of it is written); it must not overlap L."""
    t = check_tiles("trsm", l_kk, a_mk)
    if l_kk.numel() == t * t:
        group = 0
    elif l_kk.shape == a_mk.shape:
        group = 1
    elif (l_kk.dim() == a_mk.dim() >= 3 and l_kk.shape[-3] == 1
          and l_kk.shape[:-3] == a_mk.shape[:-3]):
        group = a_mk.shape[-3]
    else:
        raise ValueError(f"trsm: L {tuple(l_kk.shape)} is neither one tile, the shape "
                         f"of A {tuple(a_mk.shape)}, nor one tile per group of A's tiles")
    out = check_out("trsm", a_mk, out)
    nb = a_mk.numel() // (t * t)
    if nb == 0:
        return out
    lib = _build.load("trsm")
    stream = torch.cuda.current_stream(a_mk.device).cuda_stream
    _build.check(lib, lib.stiles_trsm_f32(l_kk.data_ptr(), a_mk.data_ptr(),
                                          out.data_ptr(), nb, t, group, stream), "trsm")
    return out


def solve_panel_chunk(nb: int, k: int, at_once: int,
                      chunk: Optional[int] = None) -> Tuple[int, int]:
    """``(chunk, chunks)``: how ``csrc/solve_panel.cu`` splits ``nb`` panels
    of ``k`` columns, a block for each panel and each ``chunk`` columns
    (``chunks`` a panel, the last one padded with zero columns).  By
    default one column a block while the ``nb * k`` blocks all fit on the
    card at once (``at_once``: its SMs, one block each), and past that the
    widest chunk: on the H100 one panel took 3.6-4.1 us at k = 32 at every
    width, and past one wave fewer blocks win (k = 256: 4.35 us at 8
    columns, 5.04 at 2, 6.24 at 1; k = 1024: 5.19 at 8, 13.54 at 1;
    PERF.md).  Every chunk gives the same bits."""
    if chunk is None:
        chunk = 1 if nb * k <= at_once else PANEL_CHUNKS[-1]
    elif chunk not in PANEL_CHUNKS:
        raise ValueError(f"solve_panel: chunk {chunk} not supported (want one of "
                         f"{PANEL_CHUNKS})")
    return chunk, -(-k // chunk)


@_build.counted(lambda l_kk, b_panel, *a, **kw: _build.batch(b_panel, 2, t=b_panel.shape[-2],
                                                              k=b_panel.shape[-1]))
def solve_panel_cuda(l_kk: torch.Tensor, b_panel: torch.Tensor, trans: bool = False, *,
                     chunk: Optional[int] = None) -> torch.Tensor:
    """``L X = B`` (or ``L^T X = B``) on the card for a (..., t, k) batch of
    panels; ``l_kk`` is one (t, t) tile for the whole batch, or (..., t,
    t), one L for each panel (panel i is then bit for bit its launch alone
    against its L).  One launch; ``chunk`` (columns a block, see
    :func:`solve_panel_chunk`) is for measurement: every chunk gives the
    same bits."""
    t = check_tiles("solve_panel", l_kk)
    check_cuda("solve_panel", b_panel, aligned=False)
    if b_panel.dim() < 2 or b_panel.shape[-2] != t:
        raise ValueError(f"solve_panel: want (..., {t}, k) panels, got "
                         f"{tuple(b_panel.shape)}")
    if l_kk.dim() != 2 and l_kk.shape[:-2] != b_panel.shape[:-2]:
        raise ValueError(f"solve_panel: want one ({t}, {t}) L or one a panel, got L "
                         f"{tuple(l_kk.shape)} for panels {tuple(b_panel.shape)}")
    k = b_panel.shape[-1]
    out = torch.empty_like(b_panel)
    nb = b_panel.numel() // (t * k) if k else 0
    chunk, chunks = solve_panel_chunk(nb, k, sm_count(b_panel.device), chunk)
    if nb == 0:
        return out
    if nb * chunks > 2 ** 31 - 1:
        raise ValueError(f"solve_panel: at most 2^31 - 1 blocks, got {nb * chunks}")
    vec = k % 4 == 0 and b_panel.data_ptr() % 16 == 0 and out.data_ptr() % 16 == 0
    per_l = nb if l_kk.dim() == 2 else 1
    lib = _build.load("solve_panel")
    stream = torch.cuda.current_stream(b_panel.device).cuda_stream
    _build.check(lib, lib.stiles_solve_panel_f32(l_kk.data_ptr(), b_panel.data_ptr(),
                                                 out.data_ptr(), nb, t, k, chunk, per_l,
                                                 int(trans), int(vec), stream), "solve_panel")
    return out
