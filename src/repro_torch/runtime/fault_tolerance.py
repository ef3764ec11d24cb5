"""Fault injection: process faults, numerical faults, dispatch faults and
stragglers, each seeded and recorded so a test can assert exactly what the
recovery machinery must catch.

* :class:`FailureInjector` raises ``RuntimeError`` at chosen steps (a
  transient or hard step failure);
* :class:`NumericalFaultInjector` corrupts chosen elements of a CTSF
  matrix batch (an indefinite shift or a NaN poke), so the breakdown
  detection and the jitter ladder of ``core/robustness.py`` can be driven
  deterministically end to end;
* :class:`DispatchFaultInjector` makes a dispatch raise
  (:class:`InjectedDispatchError`, transient or permanent) or straggle,
  every decision a hash of the batch's composition, so a chaos schedule
  replays bit for bit;
* :class:`StragglerMonitor` flags a duration slower than a multiple of the
  running median;
* :class:`TrainLoop` drives a training step with retries, and on a hard
  failure restores the latest checkpoint and replays from its step.

Port of the JAX package's ``runtime/fault_tolerance.py``: the same seeded
tiles, entries and decisions, on torch tensors.  ``TrainLoop`` restores
onto the template state's devices, and with ``state_shardings`` onto this
rank's blocks of another mesh (the reference's elastic re-meshing).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch

__all__ = ["FailureInjector", "NumericalFaultInjector", "InjectedDispatchError",
           "DispatchFaultInjector", "StragglerMonitor", "TrainLoop"]


class FailureInjector:
    """Raises RuntimeError at listed (step, attempt) pairs — test hook."""

    def __init__(self, fail_at: Optional[Dict[int, int]] = None):
        self.fail_at = dict(fail_at or {})   # step -> #failures to inject
        self.injected: List[int] = []

    def maybe_fail(self, step: int):
        if self.fail_at.get(step, 0) > 0:
            self.fail_at[step] -= 1
            self.injected.append(step)
            raise RuntimeError(f"injected failure at step {step}")


class NumericalFaultInjector:
    """Deterministically corrupts elements of a CTSF matrix batch — the
    numerical sibling of :class:`FailureInjector`.  Where FailureInjector
    models *process* faults (raise, retry the step), this models *data*
    faults that would otherwise sail through silently: an indefinite
    diagonal (model misconfiguration, a θ-candidate outside the SPD cone)
    or a NaN (a bad copy, a poisoned upstream reduction).  The corruption
    is seeded and recorded, so tests can assert exactly which elements the
    detector must flag and the jitter ladder must recover or degrade
    gracefully.

    ``corrupt(batch, modes)`` takes a batched :class:`BandedCTSF` (leading
    batch axis) and a dict ``{element_index: mode}`` with mode
    ``"indefinite"`` (subtract ``shift`` times the mean |diagonal| of the
    element's band from one seeded diagonal tile) or ``"nan"`` (poke NaN
    into one seeded band entry); it returns a new batch (the input is left
    as it is) and appends ``(index, mode, tile)`` records to ``injected``.
    """

    def __init__(self, seed: int = 0, shift: float = 10.0):
        self.seed = seed
        self.shift = shift
        self.injected: List[tuple] = []

    def corrupt(self, batch, modes: Dict[int, str]):
        rng = np.random.default_rng(self.seed)
        Dr = batch.Dr.clone()
        g = batch.grid
        t = g.t
        ndt = g.n_diag_tiles
        for idx in sorted(modes):
            mode = modes[idx]
            tile = int(rng.integers(0, max(1, ndt)))
            if mode == "indefinite":
                diag = torch.diagonal(Dr[idx, :, 0], dim1=-2, dim2=-1)
                drop = self.shift * diag.abs().mean()
                Dr[idx, tile, 0] += -drop * torch.eye(t, dtype=Dr.dtype, device=Dr.device)
            elif mode == "nan":
                a, b = int(rng.integers(0, t)), int(rng.integers(0, t))
                Dr[idx, tile, 0, a, b] = float("nan")
            else:
                raise ValueError(
                    f"unknown corruption mode {mode!r} for element {idx} "
                    "(want 'indefinite' or 'nan')")
            self.injected.append((idx, mode, tile))
        return type(batch)(g, Dr, batch.R, batch.C)

    def corrupt_one(self, mat, mode: str):
        """Corrupt a single *unbatched* CTSF matrix, the per-request form:
        the same seeded tile and entry as :meth:`corrupt` on a singleton
        batch."""
        g = mat.grid
        batch = type(mat)(g, mat.Dr[None], mat.R[None], mat.C[None])
        out = self.corrupt(batch, {0: mode})
        return type(mat)(g, out.Dr[0], out.R[0], out.C[0])


class InjectedDispatchError(RuntimeError):
    """The exception :class:`DispatchFaultInjector` raises in place of a
    real dispatch failure (out of memory, device loss, runtime abort).  A
    resilient executor must treat it exactly like any other throwing
    dispatch — retry, bisect, quarantine — which is what makes a chaos
    drill a faithful drill of the production failure paths."""

    def __init__(self, kind: str, tag: str, rids: Tuple[int, ...],
                 attempt: int):
        super().__init__(f"injected {kind} dispatch fault "
                         f"(rung={tag}, rids={rids}, attempt={attempt})")
        self.kind = kind
        self.tag = tag
        self.rids = rids
        self.attempt = attempt


class DispatchFaultInjector:
    """Seeded *dispatch*-level fault injection for a serving executor — the
    process-fault sibling of :class:`NumericalFaultInjector`.  Where that
    one corrupts matrix entries (exercising the in-sweep jitter ladder),
    this one makes the executor itself misbehave, in three seeded modes:

    * **transient** — ``before_dispatch`` raises for a seeded fraction of
      batches, but only for attempts ``< transient_attempts``: a retry
      ladder must recover these without any request noticing;
    * **permanent** — raises on *every* attempt for batches containing a
      poisoned request id (``poison_rids``) or landing on a poisoned rung
      tag (``poison_rungs``): bisection must quarantine the poison and a
      circuit breaker must stop feeding the rung;
    * **straggler** — ``straggler_extra_for`` returns extra device
      seconds for a seeded fraction of batches, which the executor burns
      through its injected clock, so the straggler monitor and the
      degradation policy see it.

    Every decision hashes ``(seed, rung tag, member rids)`` — never a
    call counter or wall clock — so the same schedule replayed through
    the same injector makes identical decisions in any order.  Raises and
    straggler grants are recorded in ``injected``.
    """

    def __init__(self, seed: int = 0, transient_rate: float = 0.0,
                 transient_attempts: int = 1,
                 poison_rids: Iterable[int] = (),
                 poison_rungs: Iterable[str] = (),
                 straggler_rate: float = 0.0,
                 straggler_extra: float = 0.05):
        if not 0.0 <= transient_rate <= 1.0:
            raise ValueError(f"transient_rate must be in [0, 1], "
                             f"got {transient_rate}")
        if not 0.0 <= straggler_rate <= 1.0:
            raise ValueError(f"straggler_rate must be in [0, 1], "
                             f"got {straggler_rate}")
        self.seed = seed
        self.transient_rate = transient_rate
        self.transient_attempts = transient_attempts
        self.poison_rids = frozenset(int(r) for r in poison_rids)
        self.poison_rungs = frozenset(str(r) for r in poison_rungs)
        self.straggler_rate = straggler_rate
        self.straggler_extra = straggler_extra
        self.injected: List[tuple] = []

    def _draw(self, salt: int, tag: str, rids: Tuple[int, ...]) -> float:
        """Uniform [0,1) deterministic in (seed, salt, tag, rids) only."""
        tag_key = [ord(c) for c in tag[:16]]
        seq = np.random.SeedSequence([self.seed, salt, len(rids),
                                      *[int(r) for r in rids], *tag_key])
        return float(np.random.default_rng(seq).random())

    def before_dispatch(self, tag: str, rids, attempt: int) -> None:
        """Call at the top of every dispatch attempt; raises
        :class:`InjectedDispatchError` when this (batch, attempt) draws a
        fault.  ``tag`` is the canonical rung tag, ``rids`` the member
        request ids in batch order."""
        rids = tuple(int(r) for r in rids)
        if tag in self.poison_rungs or self.poison_rids & set(rids):
            self.injected.append(("permanent", tag, rids, attempt))
            raise InjectedDispatchError("permanent", tag, rids, attempt)
        if (self.transient_rate > 0.0 and attempt < self.transient_attempts
                and self._draw(11, tag, rids) < self.transient_rate):
            self.injected.append(("transient", tag, rids, attempt))
            raise InjectedDispatchError("transient", tag, rids, attempt)

    def straggler_extra_for(self, tag: str, rids) -> float:
        """Extra device seconds to inject for this batch (0.0 for most)."""
        rids = tuple(int(r) for r in rids)
        if (self.straggler_rate > 0.0
                and self._draw(13, tag, rids) < self.straggler_rate):
            self.injected.append(("straggler", tag, rids,
                                  self.straggler_extra))
            return float(self.straggler_extra)
        return 0.0


class StragglerMonitor:
    """Per-step/per-batch wall-time watchdog: a recording slower than
    ``factor`` x the running median (over the last ``window`` records,
    once ``min_history`` records exist) is flagged."""

    def __init__(self, factor: float = 3.0, window: int = 50,
                 min_history: int = 5):
        self.factor = factor
        self.window = window
        self.min_history = min_history
        self.times: List[float] = []
        self.flagged: List[tuple] = []

    def record(self, step: int, dt: float) -> bool:
        """Record one duration; returns True when it was flagged."""
        hit = False
        if len(self.times) >= self.min_history:
            med = float(np.median(self.times[-self.window:]))
            if dt > self.factor * med:
                self.flagged.append((step, dt, med))
                hit = True
        self.times.append(dt)
        return hit

    @property
    def median(self) -> float:
        return float(np.median(self.times)) if self.times else 0.0


@dataclasses.dataclass
class TrainLoop:
    """Drives (state, batch) -> (state, metrics) with fault tolerance.

    A step that raises is retried up to ``max_step_retries`` times; past
    that it is a hard failure: the latest checkpoint is restored (onto the
    current state's devices and dtypes) and the loop replays from its step.
    ``batch_fn(step)`` must be a function of the step alone, so a replay
    sees the same data.  A step that updates its state in place must raise
    before it writes (as the injector does), or leave the retry to a
    restore.  With ``state_shardings`` (a sharded step's, ``launch/train.py::
    shard_train_step``) the state is this rank's blocks: checkpoints gather
    it and a restore places this rank's blocks again."""
    step_fn: Callable
    batch_fn: Callable                       # step -> host batch
    checkpointer: Any                        # checkpoint.checkpointer.Checkpointer
    checkpoint_every: int = 50
    max_step_retries: int = 2
    injector: Optional[FailureInjector] = None
    straggler: StragglerMonitor = dataclasses.field(default_factory=StragglerMonitor)
    state_shardings: Optional[Any] = None
    log_every: int = 10
    log_fn: Callable = print

    def run(self, state: Any, start_step: int, num_steps: int) -> Any:
        step = start_step
        history = []
        while step < start_step + num_steps:
            batch = self.batch_fn(step)
            t0 = time.perf_counter()
            try:
                new_state, metrics = self._try_step(state, batch, step)
            except Exception as exc:  # hard failure -> restore & replay
                self.log_fn(f"[ft] step {step}: hard failure ({exc}); "
                            f"restoring latest checkpoint")
                restored = self.checkpointer.latest_step()
                if restored is None:
                    raise
                state = self.checkpointer.restore(state, shardings=self.state_shardings)
                step = restored
                continue
            dt = time.perf_counter() - t0
            self.straggler.record(step, dt)
            state = new_state
            history.append(metrics)
            if self.log_every and step % self.log_every == 0:
                self.log_fn(f"step {step}: " + ", ".join(
                    f"{k}={float(v):.4f}" for k, v in metrics.items()))
            step += 1
            if step % self.checkpoint_every == 0:
                self.checkpointer.save(step, state, shardings=self.state_shardings)
        self.checkpointer.save(step, state, block=True, shardings=self.state_shardings)
        self.history = history
        return state

    def _try_step(self, state, batch, step):
        last = None
        for attempt in range(self.max_step_retries + 1):
            try:
                if self.injector:
                    self.injector.maybe_fail(step)
                return self.step_fn(state, batch)
            except Exception as exc:
                last = exc
                self.log_fn(f"[ft] step {step} attempt {attempt} failed: {exc}")
        raise last
