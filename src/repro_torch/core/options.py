"""Solver options for the port's entry points.

The JAX package's ``SolverOptions`` also carries the bucketing policy
(``policy``), with ``compile_key`` and ``resolve_options``; those come
with the slice that ports the policy.  ``sweep`` picks how ``factorize_window``
walks the band, as the reference's does: ``"auto"`` dispatches by the
plan and the backend, the other four force one route
(``core.cholesky._factorize_window_impl``).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Union

from .ordering import PartitionPlan
from .robustness import RegularizePolicy

__all__ = ["SolverOptions", "SWEEPS"]

SWEEPS = ("auto", "fused", "ring", "window", "partitioned")


@dataclasses.dataclass(frozen=True)
class SolverOptions:
    """How to factorize — everything except the data itself.

    Fields:
      impl: kernel backend — ``"cuda"`` (the hand-written kernels, each
        sweep in one launch), ``"ref"`` (the plain PyTorch versions, the
        sweeps as column loops) or None: the kernels for tensors on the
        card, the plain versions for tensors on the CPU.
      sweep: the factorization's band sweep — ``"auto"`` (the partitioned
        sweep when ``partition_plan`` has more than one partition, else
        the fused kernel on the CUDA backend and the ring column loop on
        the plain one), ``"fused"`` (the one-launch CUDA sweep),
        ``"ring"`` (the plain column loop), ``"window"`` (the legacy
        panel loop, one ``band_update``, ``potrf`` and ``trsm`` launch a
        column) or ``"partitioned"`` (the partition-parallel sweep; needs
        a plan).
      partition_plan: a :class:`~repro_torch.core.ordering.PartitionPlan`
        of the band's independent partitions (``detect_partition_plan``
        finds them); with more than one, ``sweep="auto"`` runs the
        partitioned sweep, one thread-block cluster a partition.
      method: how ``marginal_variances`` computes the variances —
        ``"selinv"`` (the Takahashi recurrence; also what None means) or
        ``"panels"`` (one forward sweep of unit vectors).
      regularize: breakdown recovery for ``factorize_window`` and
        ``factorize_window_batched`` — None or False (off), True (the
        default :class:`~repro_torch.core.robustness.RegularizePolicy`) or
        a policy: the escalating-jitter ladder, and a ``FactorInfo`` on the
        factor.  Checked by ``RegularizePolicy.resolve``.

    Refused as the reference refuses them: an unknown value, ``"ring"``
    with ``impl="cuda"`` and ``"fused"`` with ``impl="ref"`` (the ring
    sweep is the plain loop and the fused sweep is the kernel, so either
    would run another backend than asked), and ``"partitioned"`` without a
    plan.  Frozen and hashable, as the reference's.
    """

    impl: Optional[str] = None
    sweep: str = "auto"
    partition_plan: Optional[PartitionPlan] = None
    method: Optional[str] = None
    regularize: Union[None, bool, RegularizePolicy] = None

    def __post_init__(self):
        if self.impl not in (None, "ref", "cuda"):
            raise ValueError(f"unknown impl {self.impl!r} (want 'cuda', "
                             "'ref' or None)")
        if self.sweep not in SWEEPS:
            raise ValueError(f"unknown sweep {self.sweep!r} (want one of {SWEEPS})")
        if (self.sweep, self.impl) in (("ring", "cuda"), ("fused", "ref")):
            raise ValueError(
                f"sweep={self.sweep!r} contradicts impl={self.impl!r}: the ring sweep "
                "is the plain column loop and the fused sweep is the CUDA kernel; use "
                "sweep='auto' to dispatch by impl")
        if self.partition_plan is not None and not isinstance(self.partition_plan,
                                                              PartitionPlan):
            raise TypeError(f"partition_plan must be a PartitionPlan, got "
                            f"{type(self.partition_plan).__name__}")
        if self.sweep == "partitioned" and self.partition_plan is None:
            raise ValueError("sweep='partitioned' needs a partition plan: pass "
                             "SolverOptions(partition_plan=...) (see "
                             "core.ordering.detect_partition_plan)")
        if self.method not in (None, "selinv", "panels"):
            raise ValueError(f"unknown method {self.method!r} (want 'selinv', "
                             "'panels' or None)")
        RegularizePolicy.resolve(self.regularize)
