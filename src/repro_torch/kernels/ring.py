"""Band-layout helpers shared by the sweep wrappers and the plain versions.

The JAX package's ``kernels/ring.py`` also holds the VMEM ring addressing
its TPU sweeps need (``ring_read`` / ``ring_write``).  On Hopper the last
``band_tiles`` finalized panels are simply the output rows already written
to device memory (they stay in L2), so only the host-side converters are
ported:

  :func:`band_row_to_col` / :func:`band_col_to_row` — the shifted gather
  between row-band storage (``Dr[m, d] = T[m, m-d]``, what ``BandedCTSF``
  stores) and column-band panels (``P[k, e] = T[k+e, k]``, what the
  column-walking sweep consumes and emits).
  :func:`chunk_layout` — the (chunk size, chunk count) split of the sweep's
  corner-Schur partial sums.
  :func:`eye_tile` / :func:`identity_prefix_panel` — the identity column an
  identity-embedding prefix contributes.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch

__all__ = ["band_row_to_col", "band_col_to_row", "chunk_layout", "eye_tile",
           "identity_prefix_panel"]


def eye_tile(t: int, dtype=torch.float32, device=None) -> torch.Tensor:
    """A (t, t) identity tile."""
    return torch.eye(t, dtype=dtype, device=device)


def identity_prefix_panel(bt: int, t: int, dtype=torch.float32,
                          device=None) -> torch.Tensor:
    """The (bt+1, t, t) column panel of an identity-embedding prefix
    column: the identity at offset 0, zeros below."""
    panel = torch.zeros((bt + 1, t, t), dtype=dtype, device=device)
    panel[0] = eye_tile(t, dtype, device)
    return panel


def band_row_to_col(Dr: torch.Tensor) -> torch.Tensor:
    """Row-band storage -> column-band panels.

    Input ``Dr (..., ndt, bt+1, t, t)`` with ``Dr[m, d] = T[m, m-d]``;
    output ``P (..., ndt, bt+1, t, t)`` with ``P[k, e] = T[k+e, k]`` (zero
    for ``k+e >= ndt``)."""
    ndt, b1 = Dr.shape[-4:-2]
    out = torch.zeros_like(Dr)
    for e in range(b1):
        if e < ndt:
            out[..., :ndt - e, e, :, :] = Dr[..., e:, e, :, :]
    return out


def band_col_to_row(panels: torch.Tensor) -> torch.Tensor:
    """Column-band panels -> row-band storage (inverse of
    :func:`band_row_to_col`): ``Dr[m, d] = P[m-d, d]``, zero where
    ``m - d < 0``; leading batch dims pass through."""
    ndt, b1 = panels.shape[-4:-2]
    out = torch.zeros_like(panels)
    for d in range(b1):
        if d < ndt:
            out[..., d:, d, :, :] = panels[..., :ndt - d, d, :, :]
    return out


def chunk_layout(n: int, nchunks: int) -> Tuple[int, int]:
    """Split ``n`` sweep steps into ``<= nchunks`` contiguous chunks:
    returns ``(chunk_size, actual_chunks)``."""
    if n <= 0:
        return 1, 1
    csz = math.ceil(n / max(nchunks, 1))
    return csz, math.ceil(n / csz)
