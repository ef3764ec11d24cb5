"""Quantities read off a factor.

Only :func:`logdet` is ported so far; the multi-RHS solves, sampling and
marginal variances come with the solve slice.
"""
from __future__ import annotations

import torch

from .cholesky import CholeskyFactor

__all__ = ["logdet"]


def logdet(factor: CholeskyFactor) -> torch.Tensor:
    """log det A from its Cholesky factor."""
    return factor.logdet()
