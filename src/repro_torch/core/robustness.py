"""Breakdown status of a factorization.

Only :func:`fold_corner_status` is ported so far: it folds the dense
corner's factor into the band sweep's status word ``[min_pivot,
nonfinite, first_bad]``.  The jitter ladder and ``FactorInfo`` come with a
later slice.
"""
from __future__ import annotations

import torch

__all__ = ["fold_corner_status"]


def fold_corner_status(status: torch.Tensor, C_out: torch.Tensor,
                       ndt: int, nat: int) -> torch.Tensor:
    """Fold the dense-corner factor into a band status word: the same
    per-tile fold as ``ref.sweep_status`` over the corner's diagonal tiles,
    with a corner breakdown reported as ``first_bad = ndt`` (one past the
    last band tile) when the band itself was clean."""
    if nat == 0:
        return status
    ar = torch.arange(nat, device=C_out.device)
    dg = torch.diagonal(C_out[..., ar, ar, :, :], dim1=-2, dim2=-1)
    fin_d = torch.isfinite(dg).flatten(-2).all(dim=-1)
    inf = torch.full_like(status[..., 0], float("inf"))
    piv = torch.where(fin_d, (dg * dg).flatten(-2).amin(dim=-1), inf)
    fin = torch.isfinite(C_out).flatten(-4).all(dim=-1)
    bad = ~fin | (piv <= 0.0)
    first = torch.where((status[..., 2] < 0) & bad,
                        torch.full_like(status[..., 2], float(ndt)),
                        status[..., 2])
    return torch.stack([torch.minimum(status[..., 0], piv),
                        torch.maximum(status[..., 1], (~fin).to(status.dtype)),
                        first], dim=-1)
