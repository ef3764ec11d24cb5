"""Solver options for the port's entry points.

One frozen, hashable dataclass, :class:`SolverOptions`, carries every
knob of the entry points, taken as the keyword ``options=``: the
bucketing policy, breakdown recovery, the backend, the factorization's
sweep, the partition plan and ``marginal_variances``'s method.  Its fields
are the reference's, in the reference's order, so ``SolverOptions(*args)``
means the same in both packages.

:meth:`SolverOptions.compile_key` is the subset of the options that
changes what a built sweep computes: the batched entry points key their
caches on it (``core/batching.py``).  :func:`resolve_options` folds
per-field legacy arguments into an options object with one
``DeprecationWarning`` each, as the reference's does (its rung server
calls it); the port's own entry points take ``options=`` only.

Port of the JAX package's ``core/options.py``.
"""
from __future__ import annotations

import dataclasses
import warnings
from typing import Optional, Union

from .gridpolicy import GridBucketPolicy
from .ordering import PartitionPlan
from .robustness import RegularizePolicy

__all__ = ["SolverOptions", "resolve_options", "UNSET", "SWEEPS"]

SWEEPS = ("auto", "fused", "ring", "window", "partitioned")


class _Unset:
    """Sentinel telling "argument not passed" from an explicit None
    (``impl=None`` has a meaning: the backend by device)."""

    _instance = None

    def __new__(cls):
        if cls._instance is None:
            cls._instance = super().__new__(cls)
        return cls._instance

    def __repr__(self):
        return "<UNSET>"

    def __bool__(self):
        return False


UNSET = _Unset()


@dataclasses.dataclass(frozen=True)
class SolverOptions:
    """How to factorize and solve — everything except the data itself.

    Fields, in the reference's order:
      policy: a :class:`~repro_torch.core.gridpolicy.GridBucketPolicy`
        (canonical-grid bucketing: the matrix is embedded on its canonical
        grid, every sweep skips the identity prefix, and the results come
        back on the source grid) or None (each grid as it is).
      regularize: breakdown recovery for ``factorize_window`` and
        ``factorize_window_batched`` — None or False (off), True (the
        default :class:`~repro_torch.core.robustness.RegularizePolicy`) or
        a policy: the escalating-jitter ladder, and a ``FactorInfo`` on the
        factor.  Checked by ``RegularizePolicy.resolve``.
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
        partitioned sweep, one thread-block cluster a partition.  Under a
        ``policy`` it is shifted past the identity prefix
        (``PartitionPlan.shifted``).
      method: how ``marginal_variances`` computes the variances —
        ``"selinv"`` (the Takahashi recurrence; also what None means) or
        ``"panels"`` (one forward sweep of unit vectors).

    Refused as the reference refuses them: an unknown value, ``"ring"``
    with ``impl="cuda"`` and ``"fused"`` with ``impl="ref"`` (the ring
    sweep is the plain loop and the fused sweep is the kernel, so either
    would run another backend than asked), and ``"partitioned"`` without a
    plan; a ``policy`` or ``partition_plan`` of another type raises
    ``TypeError``.  Frozen and hashable, as the reference's.  Per-call data
    (right-hand sides, ``start_tile``, ``bucket``) stays out: options say
    how, arguments say what.
    """

    policy: Optional[GridBucketPolicy] = None
    regularize: Union[None, bool, RegularizePolicy] = None
    impl: Optional[str] = None
    sweep: str = "auto"
    partition_plan: Optional[PartitionPlan] = None
    method: Optional[str] = None

    def __post_init__(self):
        if self.policy is not None and not isinstance(self.policy, GridBucketPolicy):
            raise TypeError(f"policy must be a GridBucketPolicy, got "
                            f"{type(self.policy).__name__}")
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

    def compile_key(self) -> "SolverOptions":
        """The subset that changes what a built sweep computes, as an
        options object: ``policy`` (it picks which grid is built, already
        in every key), ``regularize`` (the ladder calls the same callable
        again) and ``method`` (it picks an entry point) are cleared, so
        option-equal calls share cache entries across them."""
        return dataclasses.replace(self, policy=None, regularize=None, method=None)

    def replace(self, **changes) -> "SolverOptions":
        """``dataclasses.replace`` as a method."""
        return dataclasses.replace(self, **changes)


def resolve_options(options: Optional[SolverOptions] = None, *,
                    _where: str = "this entry point",
                    _stacklevel: int = 3,
                    **legacy) -> SolverOptions:
    """Merge legacy per-field arguments into a :class:`SolverOptions`.

    ``legacy`` maps field names to the caller's values, :data:`UNSET`
    meaning "not passed".  Each one passed emits one ``DeprecationWarning``
    naming its replacement, then overrides that field of ``options``
    (legacy wins, as in the reference).  With none passed the options pass
    through as they are."""
    base = options if options is not None else SolverOptions()
    if not isinstance(base, SolverOptions):
        raise TypeError(f"options= must be a SolverOptions, got {type(base).__name__}")
    updates = {}
    for name, value in legacy.items():
        if value is UNSET:
            continue
        warnings.warn(
            f"{_where}: the `{name}=` kwarg is deprecated; pass "
            f"options=SolverOptions({name}=...) instead",
            DeprecationWarning, stacklevel=_stacklevel)
        updates[name] = value
    return dataclasses.replace(base, **updates) if updates else base
