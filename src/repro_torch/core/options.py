"""Solver options for the port's entry points.

The JAX package's ``SolverOptions`` also carries the sweep schedule, the
bucketing policy, the regularization ladder, the partition plan and the
marginal-variance method; those fields come with the slices that port
them.  The sweep schedule has no field yet: the port has one sweep per
backend (the one-launch CUDA kernel, or the plain column loop), so
``impl`` chooses it.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

__all__ = ["SolverOptions"]


@dataclasses.dataclass(frozen=True)
class SolverOptions:
    """How to factorize — everything except the data itself.

    Fields:
      impl: kernel backend — ``"cuda"`` (the hand-written kernels, the
        band sweep in one launch), ``"ref"`` (the plain PyTorch versions,
        the band sweep as a column loop) or None: the kernels for tensors
        on the card, the plain versions for tensors on the CPU.
    """

    impl: Optional[str] = None

    def __post_init__(self):
        if self.impl not in (None, "ref", "cuda"):
            raise ValueError(f"unknown impl {self.impl!r} (want 'cuda', "
                             "'ref' or None)")
