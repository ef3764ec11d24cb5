"""Solver options for the port's entry points.

The JAX package's ``SolverOptions`` also carries the bucketing policy
(``policy``), the regularization ladder (``regularize``) and the sweep
schedule (``sweep``); the first two come with the slices that port them.
The sweep schedule has no field: ``impl`` picks the backend's sweep (the
one-launch CUDA kernel, or the plain column loop), and a
``partition_plan`` of more than one partition picks the partitioned sweep.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

from .ordering import PartitionPlan

__all__ = ["SolverOptions"]


@dataclasses.dataclass(frozen=True)
class SolverOptions:
    """How to factorize — everything except the data itself.

    Fields:
      impl: kernel backend — ``"cuda"`` (the hand-written kernels, each
        sweep in one launch), ``"ref"`` (the plain PyTorch versions, the
        sweeps as column loops) or None: the kernels for tensors on the
        card, the plain versions for tensors on the CPU.
      partition_plan: a :class:`~repro_torch.core.ordering.PartitionPlan`
        of the band's independent partitions (``detect_partition_plan``
        finds them); with more than one, ``factorize_window`` runs the
        partitioned sweep, one block a partition.  See
        ``core.cholesky._factorize_window_impl``.
      method: how ``marginal_variances`` computes the variances —
        ``"selinv"`` (the Takahashi recurrence; also what None means) or
        ``"panels"`` (one forward sweep of unit vectors).

    Frozen and hashable, as the reference's.
    """

    impl: Optional[str] = None
    partition_plan: Optional[PartitionPlan] = None
    method: Optional[str] = None

    def __post_init__(self):
        if self.impl not in (None, "ref", "cuda"):
            raise ValueError(f"unknown impl {self.impl!r} (want 'cuda', "
                             "'ref' or None)")
        if self.partition_plan is not None and not isinstance(self.partition_plan,
                                                              PartitionPlan):
            raise TypeError(f"partition_plan must be a PartitionPlan, got "
                            f"{type(self.partition_plan).__name__}")
        if self.method not in (None, "selinv", "panels"):
            raise ValueError(f"unknown method {self.method!r} (want 'selinv', "
                             "'panels' or None)")
