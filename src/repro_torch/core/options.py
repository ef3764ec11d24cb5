"""Solver options for the port's entry points.

The JAX package's ``SolverOptions`` also carries the bucketing policy
(``policy``), the regularization ladder (``regularize``), the sweep
schedule (``sweep``) and the partition plan (``partition_plan``); those
fields come with the slices that port them.  The sweep schedule has no
field yet: the port has one sweep per backend (the one-launch CUDA
kernel, or the plain column loop), so ``impl`` chooses it.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

__all__ = ["SolverOptions"]


@dataclasses.dataclass(frozen=True)
class SolverOptions:
    """How to factorize — everything except the data itself.

    Fields:
      impl: kernel backend — ``"cuda"`` (the hand-written kernels, each
        sweep in one launch), ``"ref"`` (the plain PyTorch versions, the
        sweeps as column loops) or None: the kernels for tensors on the
        card, the plain versions for tensors on the CPU.
      method: how ``marginal_variances`` computes the variances —
        ``"selinv"`` (the Takahashi recurrence; also what None means) or
        ``"panels"`` (one forward sweep of unit vectors).
    """

    impl: Optional[str] = None
    method: Optional[str] = None

    def __post_init__(self):
        if self.impl not in (None, "ref", "cuda"):
            raise ValueError(f"unknown impl {self.impl!r} (want 'cuda', "
                             "'ref' or None)")
        if self.method not in (None, "selinv", "panels"):
            raise ValueError(f"unknown method {self.method!r} (want 'selinv', "
                             "'panels' or None)")
