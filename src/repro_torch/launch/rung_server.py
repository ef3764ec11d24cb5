"""Continuous-batching rung server: the serving front end over the
canonical-grid bucketing (``core/gridpolicy.py``), the batched
factorization (``core/cholesky.py``) and the batched solves
(``core/solve.py``).

Mixed-grid factorize/solve requests arrive continuously; each is
canonicalized by :class:`~repro_torch.core.gridpolicy.GridBucketPolicy`
into a **rung** (canonical grid × right-hand-side panel width) and queued
per rung.  A rung queue flushes as one micro-batch when any of three
conditions fires:

========  ==========================================================
reason    trigger
========  ==========================================================
full      the queue reached ``max_batch`` pending requests
deadline  ``now`` passed some queued request's ``flush_by`` time
          (``min(arrival + max_delay, request deadline)``)
drain     explicit shutdown/idle drain — everything left flushes
========  ==========================================================

A flushed batch is embedded onto its canonical grid
(:func:`~repro_torch.core.gridpolicy.assemble_rung_batch`), factorized
through the rung-keyed batched sweep (the built entries and the corner's
CUDA graphs stay O(#rungs), not O(#grids)) under the jitter ladder
(``regularize=``), and solved with per-request panels
(:func:`~repro_torch.core.solve.solve_many_batched`).  Each request's
future resolves with its restricted solution, its factor, the
per-element :class:`~repro_torch.core.robustness.FactorInfo` outcome (a
failed request degrades to a flagged future, never poisoning its rung
siblings) and its latency.

**Determinism is the design center.**  The scheduler
(:class:`RungScheduler`) is a pure, clock-injected state machine —
``tick(now, arrivals) -> [RungBatch]`` reads no wall clock, never sleeps,
touches no device and iterates its queues in insertion order — so
replaying the same arrival stream gives the same batch compositions and
flush reasons, and (each batch element computed apart from its siblings
by the same launches) bit-identical numerical results.  Tests drive it
with :class:`SimClock`; production drives the same code with
``time.monotonic``.

**The executor's device discipline.**  :class:`RungExecutor` owns a CUDA
stream.  ``dispatch`` makes that stream wait on the event ``submit``
recorded on the client's stream (the client built the request's tensors
there), marks the tensors that cross streams (``record_stream``), runs the
assembly, the batched factorization and the batched solve on it, records
one event after its last launch and returns.  ``finalize`` waits on that
event (``Event.synchronize``), never on the whole device, which would
also wait for every client thread's work; then it reads the batch's
outcome to the host once and hands each request its results on the
caller's stream.  The server dispatches batch N+1 before it finalizes
batch N, so the host assembles the next batch while the card runs the
last one; the jitter ladder's status readback synchronizes the
*factorization* on the executor's stream (and a jitter-recovered batch's
refinement decision the solve's first pass), so a dispatch's overlap ends
there.  The optional threaded pump (:meth:`RungServer.start`) only moves
the same synchronous ``pump()`` loop off the caller's thread.

**Failure domains and overload.**  Progress never hinges on one request,
one batch or one rung completing cleanly:

* *Admission control* — per-rung (``max_queue``) and global
  (``max_pending``) queue-depth bounds; an over-bound ``submit`` raises
  the typed :class:`RungOverloadError` (or, with ``on_overload="shed"``,
  resolves the future at once with a ``STATUS_SHED`` result).
* *Deadline shedding* — a request whose deadline has passed at
  flush-decision time (or on arrival) is never embedded or computed: it
  leaves as a ``FLUSH_SHED`` batch and its future resolves with
  ``STATUS_SHED`` / ``SHED_DEADLINE``.
* *Dispatch-failure isolation* — :class:`ResilientRungExecutor` wraps
  the raw executor: a throwing dispatch/finalize fails only its batch
  (retried with seeded exponential backoff + jitter, then bisected so
  poison requests are quarantined as ``STATUS_FAILED`` while survivors
  resolve normally), and a per-rung clock-injected
  :class:`CircuitBreaker` sheds load from a rung whose dispatches keep
  failing while healthy rungs serve on.
* *Graceful degradation* — under sustained overload (queue utilization
  past the high watermark, or flagged stragglers) a
  :class:`DegradationPolicy` shrinks ``max_delay``, caps the batch size
  and sheds the lowest-slack queued request first, recovering
  hysteretically once utilization stays below the low watermark.

Every path stays deterministic under the injected clock: backoff burns
time through ``SimClock.advance`` offline (``time.sleep`` on the wall),
the breaker and degradation state machines read only injected ``now``s,
and fault decisions (``runtime.fault_tolerance.DispatchFaultInjector``)
hash the batch composition, so a chaos schedule replays bit for bit.

Port of the JAX package's ``launch/rung_server.py``; run it from the command line with
``python -m repro_torch.launch.rung_server`` (the card by default,
``--device cpu`` on the CPU).  Three departures: a result's ``x`` is a
tensor on the server's device (the reference returns numpy);
``submit`` touches no device memory (the reference copies the panel to
the device there), so a request's tensors reach the server's device at
dispatch, on the pump's thread; and the telemetry: the histogram
``serving.device_seconds`` is a batch's device time (CUDA events from
dispatch to ``done``; the reference's is the clock around finalize),
``serving.assemble`` is a span of the port's own, and the fault paths
(retries, bisections, quarantines, sheds, overload rejections, breaker
transitions, stragglers, degradation steps) report through ``events``
alone, where the reference also counts them in telemetry.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import itertools
import os
import threading
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.batching import RungQueue
from repro_torch.core.cholesky import CholeskyFactor, factorize_window_batched
from repro_torch.core.ctsf import BandedCTSF, resolve_device
from repro_torch.core.gridpolicy import (GridBucketPolicy, assemble_rung_batch,
                                         assemble_rung_rhs, restrict_rhs)
from repro_torch.core.options import UNSET, SolverOptions, resolve_options
from repro_torch.core.robustness import (STATUS_FAILED, STATUS_OK, STATUS_RECOVERED,
                                         STATUS_SHED, FactorInfo)
from repro_torch.core.solve import solve_many_batched
from repro_torch.core.structure import TileGrid
from repro_torch.runtime import telemetry
from repro_torch.runtime.fault_tolerance import DispatchFaultInjector, StragglerMonitor

__all__ = ["FLUSH_FULL", "FLUSH_DEADLINE", "FLUSH_DRAIN", "FLUSH_SHED",
           "SHED_DEADLINE", "SHED_OVERLOAD", "SHED_BREAKER", "SHED_SLACK",
           "SHED_SHUTDOWN", "RungOverloadError", "DegradationPolicy",
           "CircuitBreaker", "SimClock",
           "RungRequest", "RungBatch", "RungScheduler", "RungResult",
           "RungFuture", "RungExecutor", "ResilientRungExecutor",
           "RungServer", "replay"]

FLUSH_FULL = "full"          # queue reached max_batch
FLUSH_DEADLINE = "deadline"  # a queued request's flush_by time passed
FLUSH_DRAIN = "drain"        # explicit drain (shutdown / idle flush)
FLUSH_SHED = "shed"          # never dispatched: resolved with STATUS_SHED

# shed details (RungBatch.detail / RungResult.detail): why a request was
# shed — every STATUS_SHED result carries exactly one of these
SHED_DEADLINE = "deadline_expired"   # deadline passed before flush/arrival
SHED_OVERLOAD = "overload"           # admission bound hit (shed mode)
SHED_BREAKER = "breaker_open"        # rung circuit breaker open
SHED_SLACK = "low_slack"             # degradation evicted lowest slack
SHED_SHUTDOWN = "shutdown"           # server stopped with work pending

_STATUS_NAMES = {0: "ok", 1: "recovered", 2: "failed", 3: "shed"}


class RungOverloadError(RuntimeError):
    """Typed backpressure signal raised by ``submit`` when an admission
    bound is hit: carries which bound (``scope`` is ``"rung"`` or
    ``"global"``), the rung tag, the observed depth and the limit, so a
    client can back off or retarget without string-matching a message."""

    def __init__(self, scope: str, rung: str, depth: int, limit: int):
        super().__init__(f"{scope} queue bound hit for rung {rung}: "
                         f"{depth}/{limit} pending")
        self.scope = scope
        self.rung = rung
        self.depth = depth
        self.limit = limit


class SimClock:
    """Deterministic injectable clock for tests, replays and benchmarks:
    call it for the current time, advance it explicitly.  Time only moves
    when its owner says so — the scheduler never sleeps — which is what
    makes deadline-expiry paths unit-testable without wall-clock waits."""

    def __init__(self, start: float = 0.0):
        self.now = float(start)

    def __call__(self) -> float:
        return self.now

    def advance(self, dt: float) -> float:
        if dt < 0:
            raise ValueError(f"cannot advance by negative dt {dt}")
        self.now += dt
        return self.now

    def advance_to(self, t: float) -> float:
        """Move to absolute time ``t`` (no-op if already past it)."""
        self.now = max(self.now, float(t))
        return self.now


@dataclasses.dataclass(frozen=True)
class DegradationPolicy:
    """How the scheduler degrades under sustained overload, and how it
    recovers.  All inputs are clock-injected and queue-derived, so the
    state trajectory is a pure function of the arrival schedule.

    Entering degradation: when queue utilization (global pending over
    ``max_pending``, or the worst per-rung depth over ``max_queue``)
    reaches ``high_watermark`` — or ``straggler_trigger`` straggler flags
    accumulate — the level steps up (at most once per ``step_dwell``).
    At level L the effective ``max_delay`` is scaled by
    ``delay_shrink**L`` (flush sooner, trade batch occupancy for
    latency), the effective ``max_batch`` by ``batch_shrink**L`` (cap
    batch size so one flush never monopolizes the device), and an
    over-bound submit sheds the lowest-slack queued request instead of
    rejecting the newcomer.

    Recovering: hysteretic — the level steps down one rung only after
    utilization has stayed at or below ``low_watermark`` for
    ``recover_dwell`` (a single quiet tick never flaps the policy)."""
    high_watermark: float = 0.75
    low_watermark: float = 0.25
    delay_shrink: float = 0.5
    batch_shrink: float = 0.5
    max_level: int = 2
    step_dwell: float = 1e-3
    recover_dwell: float = 5e-3
    straggler_trigger: int = 3


class _DegradationState:
    """Mutable level tracker for one scheduler (policy stays frozen)."""

    def __init__(self, policy: Optional[DegradationPolicy]):
        self.policy = policy
        self.level = 0
        self._last_step = float("-inf")
        self._below_since: Optional[float] = None
        self._stragglers = 0

    def _step_up(self, now: float) -> None:
        p = self.policy
        if self.level < p.max_level and now - self._last_step >= p.step_dwell:
            self.level += 1
            self._last_step = now
            self._below_since = None

    def update(self, now: float, utilization: float) -> None:
        p = self.policy
        if p is None:
            return
        if utilization >= p.high_watermark:
            self._below_since = None
            self._step_up(now)
        elif utilization <= p.low_watermark:
            if self._below_since is None:
                self._below_since = now
            elif (self.level > 0
                  and now - self._below_since >= p.recover_dwell):
                self.level -= 1
                self._below_since = now
        else:
            self._below_since = None

    def note_straggler(self, now: float) -> None:
        if self.policy is None:
            return
        self._stragglers += 1
        if self._stragglers >= self.policy.straggler_trigger:
            self._stragglers = 0
            self._step_up(now)


class CircuitBreaker:
    """Per-rung closed/open/half-open breaker, clock-injected.

    ``failure_threshold`` consecutive raw dispatch failures open the
    breaker; while open, :meth:`allow` is False and the server sheds the
    rung's batches (``SHED_BREAKER``) without touching the device.  After
    ``reset_timeout`` the next :meth:`allow` transitions to half-open and
    admits one trial batch: success closes the breaker, failure reopens
    it for another full timeout.  All timestamps come from the caller,
    so breaker trajectories replay deterministically under SimClock."""

    def __init__(self, failure_threshold: int = 5, reset_timeout: float = 0.1,
                 on_transition=None):
        if failure_threshold < 1:
            raise ValueError(f"failure_threshold must be >= 1, "
                             f"got {failure_threshold}")
        if reset_timeout < 0:
            raise ValueError(f"reset_timeout must be >= 0, "
                             f"got {reset_timeout}")
        self.failure_threshold = failure_threshold
        self.reset_timeout = reset_timeout
        self.state = "closed"
        self.failures = 0                 # consecutive, since last success
        self.opened_at: Optional[float] = None
        self._on_transition = on_transition

    def _transition(self, state: str, now: float) -> None:
        if state != self.state:
            self.state = state
            if self._on_transition is not None:
                self._on_transition(state, now)

    def allow(self, now: float) -> bool:
        """May a batch be dispatched at ``now``?  (Open -> half-open once
        the reset timeout elapses, admitting the trial batch.)"""
        if self.state == "open":
            if now - self.opened_at >= self.reset_timeout:
                self._transition("half_open", now)
                return True
            return False
        return True

    def record_success(self, now: float) -> None:
        self.failures = 0
        self._transition("closed", now)

    def record_failure(self, now: float) -> None:
        self.failures += 1
        if self.state == "half_open" or self.failures >= self.failure_threshold:
            self.opened_at = now
            self._transition("open", now)


@dataclasses.dataclass
class RungRequest:
    """One queued unit of work: a matrix to factorize, optionally with a
    right-hand-side panel to solve.  ``deadline`` is an absolute clock time
    (in the injected clock's units) the request must be flushed by; None
    means only the scheduler's ``max_delay`` bounds its wait.  ``arrival``
    / ``flush_by`` / ``rung`` are stamped by the scheduler at submit.
    ``rhs`` is the caller's ``(padded_n, k)`` panel as it was given (a
    tensor on any device, or a host array); ``ready`` the event recorded on
    the caller's stream at submit when the request's tensors sit on the
    card, which the executor's stream waits on before it reads them."""
    rid: int
    matrix: BandedCTSF
    rhs: Optional[torch.Tensor] = None
    deadline: Optional[float] = None
    future: Optional["RungFuture"] = None
    submitted_wall: float = 0.0
    arrival: float = 0.0
    flush_by: float = 0.0
    rung: Optional[TileGrid] = None
    ready: Optional["torch.cuda.Event"] = None

    @property
    def grid(self) -> TileGrid:
        return self.matrix.grid

    @property
    def k(self) -> Optional[int]:
        return None if self.rhs is None else int(self.rhs.shape[-1])


@dataclasses.dataclass(frozen=True)
class RungBatch:
    """One flush decision: the requests (arrival order preserved), the
    rung key ``(canonical grid, rhs width or None)``, why it flushed and
    when.  ``detail`` refines ``FLUSH_SHED`` batches with the shed reason
    (``SHED_DEADLINE`` / ``SHED_OVERLOAD`` / ``SHED_SLACK``).
    ``signature()`` is the host-comparable composition record the replay
    tests diff across runs."""
    key: Tuple[TileGrid, Optional[int]]
    requests: Tuple[RungRequest, ...]
    reason: str
    decided_at: float
    detail: str = ""

    def signature(self) -> Tuple[str, Optional[int], Tuple[int, ...], str,
                                 str]:
        return (telemetry.rung_tag(self.key[0]), self.key[1],
                tuple(r.rid for r in self.requests), self.reason,
                self.detail)


class RungScheduler:
    """Pure clock-injected micro-batching state machine.

    All methods take ``now`` explicitly; nothing here reads a clock,
    sleeps, or spawns a thread.  Rung queues live in an insertion-ordered
    dict and items in arrival order, so for a fixed sequence of
    ``submit``/``tick``/``drain`` calls the emitted batches — membership,
    order, and flush reasons — are exactly reproducible.

    Admission control: ``max_queue`` bounds each rung queue and
    ``max_pending`` bounds the global backlog (None = unbounded).  An
    over-bound ``submit`` raises :class:`RungOverloadError` — unless a
    :class:`DegradationPolicy` is active at level > 0, in which case the
    lowest-slack request (queued or the newcomer) is shed instead.
    Requests whose deadline has already passed — on arrival or at
    flush-decision time — leave as ``FLUSH_SHED`` batches, never
    consuming device time; the server resolves them with ``STATUS_SHED``.
    """

    def __init__(self, policy: Optional[GridBucketPolicy] = None,
                 max_batch: int = 8, max_delay: float = 10e-3,
                 max_queue: Optional[int] = None,
                 max_pending: Optional[int] = None,
                 degradation: Optional[DegradationPolicy] = None):
        if max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {max_batch}")
        if max_delay < 0:
            raise ValueError(f"max_delay must be >= 0, got {max_delay}")
        if max_queue is not None and max_queue < 1:
            raise ValueError(f"max_queue must be >= 1 or None, "
                             f"got {max_queue}")
        if max_pending is not None and max_pending < 1:
            raise ValueError(f"max_pending must be >= 1 or None, "
                             f"got {max_pending}")
        self.policy = policy or GridBucketPolicy()
        self.max_batch = max_batch
        self.max_delay = max_delay
        self.max_queue = max_queue
        self.max_pending = max_pending
        self.degradation = degradation
        self._deg = _DegradationState(degradation)
        self._queues: Dict[Tuple[TileGrid, Optional[int]], RungQueue] = {}
        # requests shed outside tick (arrival-expired, slack eviction):
        # grouped into FLUSH_SHED batches on the next tick
        self._shed_buffer: List[Tuple[tuple, RungRequest, str]] = []

    @property
    def pending(self) -> int:
        return (sum(len(q) for q in self._queues.values())
                + len(self._shed_buffer))

    @property
    def level(self) -> int:
        """Current degradation level (0 = healthy)."""
        return self._deg.level

    def utilization(self) -> float:
        """Backlog relative to the admission bounds in [0, 1+]: global
        pending over ``max_pending`` when set, else the worst per-rung
        depth over ``max_queue``; 0.0 when unbounded."""
        if self.max_pending is not None:
            return self.pending / self.max_pending
        if self.max_queue is not None and self._queues:
            return max(len(q) for q in self._queues.values()) / self.max_queue
        return 0.0

    def effective_max_delay(self) -> float:
        if self.degradation is None or self._deg.level == 0:
            return self.max_delay
        return self.max_delay * self.degradation.delay_shrink ** self._deg.level

    def effective_max_batch(self) -> int:
        if self.degradation is None or self._deg.level == 0:
            return self.max_batch
        shrink = self.degradation.batch_shrink ** self._deg.level
        return max(1, int(self.max_batch * shrink))

    def note_straggler(self, now: float) -> None:
        """Feed one straggler flag (from the executor's monitor) to the
        degradation policy — repeated flags step the level up."""
        self._deg.note_straggler(now)

    @staticmethod
    def _slack(req: RungRequest, now: float) -> float:
        return float("inf") if req.deadline is None else req.deadline - now

    def submit(self, now: float, req: RungRequest) -> Tuple[TileGrid,
                                                            Optional[int]]:
        """Enqueue one request under its rung key, stamping arrival and
        flush-by times.  Returns the key (useful for tests); flushing
        happens only in :meth:`tick`/:meth:`drain`, so a submit can never
        reorder ahead of earlier arrivals.  Raises
        :class:`RungOverloadError` when an admission bound is hit (and no
        degradation level is active to shed slack instead); a request
        whose deadline already passed is buffer-shed, never queued."""
        self._deg.update(now, self.utilization())
        cgrid = self.policy.canonicalize(req.matrix.grid)
        key = (cgrid, req.k)
        req.arrival = now
        req.rung = cgrid
        req.flush_by = now + self.effective_max_delay()
        if req.deadline is not None:
            req.flush_by = min(req.flush_by, float(req.deadline))
        if telemetry.enabled():
            telemetry.inc("serving.requests")
        if req.deadline is not None and now > req.deadline:
            # dead on arrival: shed without ever occupying a queue slot
            self._shed_buffer.append((key, req, SHED_DEADLINE))
            return key
        q = self._queues.get(key)
        if q is None:
            q = self._queues[key] = RungQueue(maxlen=self.max_queue)
        over_rung = q.full
        over_global = (self.max_pending is not None
                       and self.pending >= self.max_pending)
        if over_rung or over_global:
            scope = "rung" if over_rung else "global"
            depth = len(q) if over_rung else self.pending
            limit = self.max_queue if over_rung else self.max_pending
            if self.degradation is not None and self._deg.level > 0:
                # degraded: make room by shedding whoever can least
                # afford to wait — the lowest-slack request, newcomer
                # included (ties keep the oldest, i.e. evict it first)
                victim = q.evict_min(lambda r: self._slack(r, now)) \
                    if len(q) else None
                if victim is None or (self._slack(req, now)
                                      < self._slack(victim, now)):
                    if victim is not None:
                        q.push(victim, victim.flush_by)
                    self._shed_buffer.append((key, req, SHED_SLACK))
                    return key
                self._shed_buffer.append((key, victim, SHED_SLACK))
            else:
                raise RungOverloadError(scope, telemetry.rung_tag(cgrid),
                                        depth, limit)
        q.push(req, req.flush_by)
        if telemetry.enabled():
            telemetry.gauge("serving.queue_depth", len(q),
                            rung=telemetry.rung_tag(cgrid))
        return key

    def next_flush_by(self) -> Optional[float]:
        """Earliest pending flush-by time across all rungs (None when
        idle) — the exact boundary a deterministic loop must tick at,
        and the longest a threaded pump may sleep.  Buffered sheds are
        already due (they resolve on the next tick)."""
        if self._shed_buffer:
            return float("-inf")
        if not self._queues:
            return None
        return min(q.earliest_flush_by() for q in self._queues.values())

    def tick(self, now: float,
             arrivals: Sequence[RungRequest] = ()) -> List[RungBatch]:
        """Advance the state machine to ``now``: enqueue ``arrivals``,
        shed expired/buffered requests, then emit every batch-full and
        deadline-expired flush, in rung insertion order then arrival
        order.  Pure function of (state, now, arrivals) — the unit the
        replay/property tests drive."""
        for req in arrivals:
            self.submit(now, req)
        self._deg.update(now, self.utilization())
        out: List[RungBatch] = self._drain_shed_buffer(now)
        eff_batch = self.effective_max_batch()
        for key, q in list(self._queues.items()):
            expired = q.remove_if(
                lambda r: r.deadline is not None and now > r.deadline)
            if expired:
                out.append(self._flush(key, expired, FLUSH_SHED, now,
                                       detail=SHED_DEADLINE))
            while len(q) >= eff_batch:
                out.append(self._flush(key, q.pop(eff_batch),
                                       FLUSH_FULL, now))
            if len(q) and q.earliest_flush_by() <= now:
                out.append(self._flush(key, q.pop(), FLUSH_DEADLINE, now))
            if not len(q):
                del self._queues[key]
        return out

    def drain(self, now: float) -> List[RungBatch]:
        """Flush everything: regular full/deadline flushes first (so a
        drain at a deadline boundary classifies identically to a tick),
        then whatever remains as FLUSH_DRAIN batches."""
        out = self.tick(now)
        for key, q in list(self._queues.items()):
            if len(q):
                out.append(self._flush(key, q.pop(), FLUSH_DRAIN, now))
            del self._queues[key]
        return out

    def abort(self) -> List[RungRequest]:
        """Tear down the state machine without flushing: remove and
        return every queued or buffer-shed request (the server resolves
        them terminally on shutdown).  After this, ``pending`` is 0."""
        reqs: List[RungRequest] = []
        for key, q in list(self._queues.items()):
            reqs.extend(q.pop())
            del self._queues[key]
        reqs.extend(r for _, r, _ in self._shed_buffer)
        self._shed_buffer = []
        return reqs

    def _drain_shed_buffer(self, now: float) -> List[RungBatch]:
        """Group buffered sheds into FLUSH_SHED batches per (key, detail),
        preserving buffer order."""
        if not self._shed_buffer:
            return []
        groups: Dict[Tuple[tuple, str], List[RungRequest]] = {}
        for key, req, detail in self._shed_buffer:
            groups.setdefault((key, detail), []).append(req)
        self._shed_buffer = []
        return [self._flush(key, reqs, FLUSH_SHED, now, detail=detail)
                for (key, detail), reqs in groups.items()]

    def _flush(self, key, reqs: List[RungRequest], reason: str,
               now: float, detail: str = "") -> RungBatch:
        if telemetry.enabled():
            telemetry.inc("serving.flush", reason=reason)
            telemetry.observe("serving.batch_size", len(reqs))
            for r in reqs:
                telemetry.observe("serving.queue_wait", now - r.arrival)
            q = self._queues.get(key)
            telemetry.gauge("serving.queue_depth", len(q) if q else 0,
                            rung=telemetry.rung_tag(key[0]))
        return RungBatch(key=key, requests=tuple(reqs), reason=reason,
                         decided_at=now, detail=detail)


@dataclasses.dataclass
class RungResult:
    """What a resolved future carries: the per-request numerical outcome
    (``status``/``attempts``/``tau`` from the jitter ladder — a FAILED
    element flags only itself), the solution panel ``x`` in the request's
    own padded layout (a tensor on the server's device; None for
    factorize-only requests), the per-request ``factor`` (on the canonical
    grid with ``source_grid`` set, its arrays views of the batch's), and
    both latency views — ``latency`` in the injected clock's units
    (deterministic under replay) and ``wall_latency_s`` in real seconds
    (what the latency histogram reports).

    ``status`` is always one of the closed set ``STATUS_OK`` /
    ``STATUS_RECOVERED`` (ladder-jittered, or served only after dispatch
    retries/bisection) / ``STATUS_FAILED`` (numerically failed, or
    quarantined as dispatch poison — ``x``/``factor`` are None) /
    ``STATUS_SHED`` (never computed; ``detail`` says why)."""
    rid: int
    status: int
    attempts: int
    tau: float
    x: Optional[torch.Tensor]
    factor: Optional[CholeskyFactor]
    latency: float
    wall_latency_s: float
    flush_reason: str
    batch_size: int
    rung: str
    detail: str = ""

    def ok(self) -> bool:
        return self.status in (STATUS_OK, STATUS_RECOVERED)


class RungFuture:
    """Per-request completion handle.  ``result()`` blocks (threaded
    serving) or returns immediately once the synchronous pump finalized
    the batch; failures arrive as a FAILED-status result, never as an
    exception leaking from a rung sibling.

    Resolution is strictly once: the first ``_resolve`` wins, later ones
    are counted (``duplicate_resolves``) and dropped — the conservation
    invariant the chaos harness and property tests assert on."""

    def __init__(self, rid: int):
        self.rid = rid
        self._event = threading.Event()
        self._result: Optional[RungResult] = None
        self._resolve_lock = threading.Lock()
        self.duplicate_resolves = 0

    def done(self) -> bool:
        return self._event.is_set()

    def result(self, timeout: Optional[float] = None) -> RungResult:
        if not self._event.wait(timeout):
            raise TimeoutError(f"request {self.rid} not completed "
                               f"within {timeout}s")
        return self._result

    def _resolve(self, result: RungResult) -> bool:
        with self._resolve_lock:
            if self._event.is_set():
                self.duplicate_resolves += 1
                return False
            self._result = result
            self._event.set()
            return True


@dataclasses.dataclass
class _Inflight:
    """One dispatched-but-not-finalized batch: its factor and solutions
    (their launches queued on the executor's stream), the event recorded
    after the last launch (None on the CPU), and the metadata to route the
    results home.  While telemetry is on, ``begin`` is an event recorded at
    the dispatch's start, and ``device_s`` the batch's device time, from
    ``begin`` to ``done`` (read once ``finalize`` has waited on ``done``;
    on the CPU the dispatch's own time, the host being the device)."""
    batch: RungBatch
    factor: CholeskyFactor
    start: int
    X: Optional[torch.Tensor]
    done: Optional["torch.cuda.Event"]
    begin: Optional["torch.cuda.Event"] = None
    device_s: Optional[float] = None


# a request's outcome where the factorization ran without the ladder
_CLEAN = {"status": STATUS_OK, "attempts": 1, "tau": 0.0,
          "min_pivot": float("nan"), "first_bad_tile": -1}


def _client_fence(matrix, rhs) -> Optional["torch.cuda.Event"]:
    """An event recorded on the caller's current stream when the request's
    tensors sit on the card (they were made there), else None; the only
    CUDA call of ``submit``."""
    for x in (getattr(matrix, "Dr", None), rhs):
        if torch.is_tensor(x) and x.is_cuda:
            event = torch.cuda.Event()
            event.record(torch.cuda.current_stream(x.device))
            return event
    return None


class RungExecutor:
    """Assembles, dispatches and finalizes rung batches on ``device``
    (None: the card, ``resolve_device``; ``"cpu"`` runs the plain versions
    and has no stream).

    ``dispatch`` runs on the executor's own CUDA stream: it waits on each
    request's ``ready`` event, moves a request whose tensors sit on another
    device, embeds and stacks the batch onto its canonical grid and queues
    the factorization (+ the solve), then records ``done`` and returns, so
    the caller can assemble the next batch while the card works.
    ``finalize`` waits on ``done``, reads the batch's five outcome fields
    to the host once, restricts each element back to its source layout on
    the caller's current stream and resolves the futures.  The tensors
    handed out (and the batch's, which the per-request factors view) are
    marked as used on that stream, so the caching allocator gives their
    memory to no later batch before the caller's work on them is done."""

    def __init__(self, *, impl=UNSET, tree_chunks: int = 8,
                 sweep=UNSET, regularize=UNSET, bucket: bool = True,
                 options: Optional[SolverOptions] = None, device=None):
        opts = resolve_options(options, _where="RungExecutor",
                               impl=impl, sweep=sweep, regularize=regularize)
        # the server's historical default is the jitter ladder ON; an
        # explicit options object is respected verbatim
        if options is None and regularize is UNSET:
            opts = opts.replace(regularize=True)
        self.options = opts
        self.tree_chunks = tree_chunks
        self.bucket = bucket
        self.device = resolve_device(device)
        self.stream = (torch.cuda.Stream(self.device) if self.device.type == "cuda"
                       else None)

    def _on_stream(self):
        return (torch.cuda.stream(self.stream) if self.stream is not None
                else contextlib.nullcontext())

    def _inputs(self, req: RungRequest) -> Tuple[BandedCTSF, Optional[torch.Tensor]]:
        """The request's matrix and panel on the executor's device, read on
        its stream: the stream waits for the client's work on them, and
        every CUDA tensor of theirs is marked as used by the stream."""
        if req.ready is not None:
            # a CPU executor given the card's tensors: the host waits
            if self.stream is not None:
                self.stream.wait_event(req.ready)
            else:
                req.ready.synchronize()
        m = req.matrix
        if m.device != self.device:
            m = BandedCTSF(m.grid, *(x.to(self.device) for x in m.arrays()))
        rhs = req.rhs
        if rhs is not None:
            rhs = torch.as_tensor(rhs, dtype=torch.float32, device=self.device)
        if self.stream is not None:
            for x in (*m.arrays(), rhs):
                if x is not None and x.is_cuda:
                    x.record_stream(self.stream)
        return m, rhs

    def dispatch(self, batch: RungBatch, now: float) -> _Inflight:
        cgrid, k = batch.key
        reqs = batch.requests
        with telemetry.span("serving.dispatch", rung=telemetry.rung_tag(cgrid),
                            b=len(reqs), reason=batch.reason), self._on_stream():
            begin, t0 = None, time.perf_counter()
            if self.stream is not None and telemetry.enabled():
                begin = torch.cuda.Event(enable_timing=True)
                begin.record(self.stream)
            with telemetry.span("serving.assemble"):
                inputs = [self._inputs(r) for r in reqs]
                stacked, start = assemble_rung_batch([m for m, _ in inputs], cgrid)
                B = None if k is None else assemble_rung_rhs(
                    [b for _, b in inputs], [r.grid for r in reqs], cgrid)
            factor = factorize_window_batched(
                stacked, tree_chunks=self.tree_chunks,
                bucket=self.bucket, start_tile=start, options=self.options)
            X = None
            if B is not None:
                X = solve_many_batched(factor, B, start_tile=start,
                                       bucket=self.bucket, options=self.options)
            done, device_s = None, None
            if self.stream is not None:
                done = torch.cuda.Event(enable_timing=begin is not None)
                done.record(self.stream)
            elif telemetry.enabled():
                device_s = time.perf_counter() - t0
            return _Inflight(batch=batch, factor=factor, start=start, X=X, done=done,
                             begin=begin, device_s=device_s)

    def _handed_out(self, inflight: _Inflight) -> List[torch.Tensor]:
        """The executor stream's tensors the caller's stream reads: the
        solutions, the batch's factor (the per-request factors view it) and
        its outcome, with the kept original matrices."""
        f, info = inflight.factor.ctsf, inflight.factor.info
        out = [f.Dr, f.R, f.C]
        if inflight.X is not None:
            out.append(inflight.X)
        if info is not None:
            out += [info.status, info.attempts, info.tau, info.min_pivot,
                    info.first_bad_tile]
            if info.matrix is not None:
                out += list(info.matrix.arrays())
        return out

    def finalize(self, inflight: _Inflight, now: float) -> List[RungResult]:
        batch = inflight.batch
        cgrid = batch.key[0]
        factor, info = inflight.factor, inflight.factor.info
        with telemetry.span("serving.finalize",
                            rung=telemetry.rung_tag(cgrid),
                            b=len(batch.requests)):
            if inflight.done is not None:
                inflight.done.synchronize()
                if inflight.begin is not None:
                    inflight.device_s = inflight.begin.elapsed_time(inflight.done) / 1e3
                here = torch.cuda.current_stream(self.device)
                for x in self._handed_out(inflight):
                    x.record_stream(here)
            # the batch's outcome in one read, not one a field an element
            elems = info.elements() if info is not None else \
                [_CLEAN] * len(batch.requests)
            f = factor.ctsf
            results = []
            for i, req in enumerate(batch.requests):
                elem = elems[i]
                x = None
                if inflight.X is not None:
                    x = restrict_rhs(inflight.X[i], req.grid, cgrid)
                # the per-request factor stays on the canonical grid with
                # source_grid set, so later solve/selinv calls reuse the
                # rung-keyed entries and graphs; a jittered element keeps its
                # original matrix so those solves still refine; its outcome
                # fields are 0-d views of the batch's, on the factor's device
                einfo = None
                if info is not None:
                    matrix = None
                    if info.matrix is not None and elem["tau"] > 0:
                        m = info.matrix
                        matrix = BandedCTSF(cgrid, m.Dr[i], m.R[i], m.C[i])
                    einfo = FactorInfo(
                        status=info.status[i], attempts=info.attempts[i],
                        tau=info.tau[i], min_pivot=info.min_pivot[i],
                        first_bad_tile=info.first_bad_tile[i], matrix=matrix)
                rf = CholeskyFactor(
                    BandedCTSF(cgrid, f.Dr[i], f.R[i], f.C[i]),
                    source_grid=req.grid, info=einfo)
                wall = time.perf_counter() - req.submitted_wall \
                    if req.submitted_wall else 0.0
                res = RungResult(
                    rid=req.rid, status=elem["status"],
                    attempts=elem["attempts"], tau=elem["tau"], x=x,
                    factor=rf, latency=now - req.arrival,
                    wall_latency_s=wall, flush_reason=batch.reason,
                    batch_size=len(batch.requests),
                    rung=telemetry.rung_tag(cgrid))
                if telemetry.enabled():
                    telemetry.inc("serving.completed",
                                  outcome=_STATUS_NAMES.get(
                                      elem["status"], "unknown"))
                    telemetry.observe("serving.request_seconds", wall)
                results.append(res)
                if req.future is not None:
                    req.future._resolve(res)
            return results


@dataclasses.dataclass
class _RInflight:
    """Resilient wrapper around one in-flight batch.  ``raw`` is None
    when the first dispatch attempt failed (or was never made) — the
    recovery ladder then runs entirely inside ``finalize``."""
    batch: RungBatch
    raw: Optional[_Inflight]
    dispatched_at: float


class ResilientRungExecutor:
    """Dispatch-failure isolation around a raw :class:`RungExecutor`.

    A throwing ``dispatch``/``finalize`` fails only its batch, and a
    failed batch walks a recovery ladder instead of raising to the pump:

    1. **Retry** the whole batch up to ``max_retries`` times with seeded
       exponential backoff + jitter (delays burn through ``sleep_fn`` —
       ``SimClock.advance`` offline, ``time.sleep`` on the wall — so
       replays stay bit-identical).
    2. **Bisect**: split the batch and execute the halves independently,
       recursing on failures, so poison requests are isolated in
       O(log batch) dispatches while healthy siblings resolve normally.
    3. **Quarantine**: a singleton that still fails resolves with a
       ``STATUS_FAILED`` result (``detail="dispatch_failed"``, no
       solution/factor) — never an exception.

    A per-rung :class:`CircuitBreaker` counts consecutive raw failures;
    while open, :meth:`allow` tells the server to shed the rung's batches
    (``SHED_BREAKER``) without touching the device.  A
    :class:`~repro_torch.runtime.fault_tolerance.StragglerMonitor` watches
    clock-accounted per-batch device time and feeds flags to the
    scheduler's degradation policy via ``on_straggler``.  An optional
    :class:`~repro_torch.runtime.fault_tolerance.DispatchFaultInjector` (the
    chaos harness) raises seeded faults and injects stragglers ahead of
    real dispatches.

    Every decision — backoff jitter, fault draws — hashes the batch
    composition (rung tag + member rids + attempt), never a call counter
    or wall clock, so a chaos schedule replays exactly.  Noteworthy
    transitions append to the shared ``events`` list the server exposes
    (and the chaos benchmark diffs across replay passes).
    """

    def __init__(self, inner: RungExecutor, clock, sleep_fn,
                 events: Optional[List[tuple]] = None, max_retries: int = 2,
                 backoff_base: float = 1e-3, backoff_factor: float = 2.0,
                 seed: int = 0, breaker_threshold: int = 5,
                 breaker_reset: float = 0.1,
                 injector: Optional[DispatchFaultInjector] = None,
                 straggler_factor: float = 3.0, on_straggler=None):
        if max_retries < 0:
            raise ValueError(f"max_retries must be >= 0, got {max_retries}")
        self.inner = inner
        self.clock = clock
        self.sleep_fn = sleep_fn
        self.events = events if events is not None else []
        self.max_retries = max_retries
        self.backoff_base = backoff_base
        self.backoff_factor = backoff_factor
        self.seed = seed
        self.breaker_threshold = breaker_threshold
        self.breaker_reset = breaker_reset
        self.injector = injector
        self.monitor = StragglerMonitor(factor=straggler_factor)
        self.on_straggler = on_straggler
        self._breakers: Dict[tuple, CircuitBreaker] = {}
        self._step = 0

    # -- breaker ------------------------------------------------------------

    def breaker(self, key) -> CircuitBreaker:
        br = self._breakers.get(key)
        if br is None:
            tag = telemetry.rung_tag(key[0])

            def on_transition(state, now, _tag=tag):
                self.events.append(("breaker", _tag, state, round(now, 9)))

            br = self._breakers[key] = CircuitBreaker(
                failure_threshold=self.breaker_threshold,
                reset_timeout=self.breaker_reset,
                on_transition=on_transition)
        return br

    def allow(self, key, now: float) -> bool:
        """May a batch for ``key`` be dispatched at ``now``?  False means
        the rung's breaker is open — the server sheds the batch."""
        return self.breaker(key).allow(now)

    # -- deterministic backoff ---------------------------------------------

    def _backoff(self, tag: str, rids: Tuple[int, ...], attempt: int) -> float:
        """attempt-th retry delay: exponential base with a jitter factor
        in [0, 1) drawn from a hash of (seed, batch composition, attempt)
        — same batch, same delays, every replay."""
        ss = np.random.SeedSequence(
            [self.seed, 29, attempt, len(rids), *rids,
             *(ord(c) for c in tag[:16])])
        jitter = float(np.random.default_rng(ss).random())
        return self.backoff_base * self.backoff_factor ** (attempt - 1) \
            * (1.0 + jitter)

    # -- raw attempts -------------------------------------------------------

    def _raw_dispatch(self, batch: RungBatch, now: float,
                      attempt: int) -> _Inflight:
        if self.injector is not None:
            self.injector.before_dispatch(
                telemetry.rung_tag(batch.key[0]),
                tuple(r.rid for r in batch.requests), attempt)
        return self.inner.dispatch(batch, now)

    def _raw_finalize(self, batch: RungBatch, raw,
                      now: float) -> List[RungResult]:
        tag = telemetry.rung_tag(batch.key[0])
        rids = tuple(r.rid for r in batch.requests)
        t0 = self.clock()
        if self.injector is not None:
            extra = self.injector.straggler_extra_for(tag, rids)
            if extra > 0:
                self.sleep_fn(extra)  # the injected stall burns clock time
        results = self.inner.finalize(raw, now)
        dt = self.clock() - t0
        self._step += 1
        # the batch's device time, where the inner executor measured it
        device_s = getattr(raw, "device_s", None)
        if telemetry.enabled() and device_s is not None:
            telemetry.observe("serving.device_seconds", device_s, rung=tag)
        if self.monitor.record(self._step, dt):
            self.events.append(("straggler", tag, self._step, round(dt, 9)))
            if self.on_straggler is not None:
                self.on_straggler(self.clock())
        return results

    def _note_failure(self, batch: RungBatch, now: float, err: Exception,
                      attempt: int) -> None:
        tag = telemetry.rung_tag(batch.key[0])
        rids = tuple(r.rid for r in batch.requests)
        self.events.append(("fail", tag, rids, attempt,
                            type(err).__name__))
        self.breaker(batch.key).record_failure(now)

    # -- executor interface -------------------------------------------------

    def dispatch(self, batch: RungBatch, now: float) -> _RInflight:
        """First dispatch attempt.  On success the raw in-flight batch
        rides along (double buffering preserved); on failure the error is
        recorded and recovery is deferred to :meth:`finalize`."""
        try:
            raw = self._raw_dispatch(batch, now, attempt=0)
            return _RInflight(batch=batch, raw=raw, dispatched_at=now)
        except Exception as e:  # noqa: BLE001 — isolation boundary
            self._note_failure(batch, now, e, attempt=0)
            return _RInflight(batch=batch, raw=None, dispatched_at=now)

    def finalize(self, rin: _RInflight, now: float) -> List[RungResult]:
        """Block on the in-flight batch; on any failure run the recovery
        ladder.  Always returns one result per request, all futures
        resolved — exceptions stop at this boundary."""
        batch = rin.batch
        if rin.raw is not None:
            try:
                results = self._raw_finalize(batch, rin.raw, now)
                self.breaker(batch.key).record_success(self.clock())
                return results
            except Exception as e:  # noqa: BLE001 — isolation boundary
                self._note_failure(batch, self.clock(), e, attempt=0)
        return self._recover(batch, self.max_retries)

    # -- recovery ladder ----------------------------------------------------

    def _try_once(self, batch: RungBatch, attempt: int) -> List[RungResult]:
        now = self.clock()
        raw = self._raw_dispatch(batch, now, attempt)
        return self._raw_finalize(batch, raw, self.clock())

    @staticmethod
    def _mark_recovered(results: List[RungResult]) -> List[RungResult]:
        # served, but only after dispatch retries/bisection — surface
        # that in the status (OK -> RECOVERED; ladder RECOVERED stays)
        for res in results:
            if res.status == STATUS_OK:
                res.status = STATUS_RECOVERED
        return results

    def _quarantine(self, batch: RungBatch, attempts: int) -> RungResult:
        req = batch.requests[0]
        tag = telemetry.rung_tag(batch.key[0])
        t = self.clock()
        self.events.append(("quarantine", tag, req.rid, round(t, 9)))
        if telemetry.enabled():
            telemetry.inc("serving.completed", outcome="failed")
        wall = time.perf_counter() - req.submitted_wall \
            if req.submitted_wall else 0.0
        res = RungResult(rid=req.rid, status=STATUS_FAILED,
                         attempts=attempts, tau=0.0, x=None, factor=None,
                         latency=t - req.arrival, wall_latency_s=wall,
                         flush_reason=batch.reason, batch_size=1, rung=tag,
                         detail="dispatch_failed")
        if req.future is not None:
            req.future._resolve(res)
        return res

    def _recover(self, batch: RungBatch, retries: int) -> List[RungResult]:
        """The batch's initial attempt already failed.  Retry whole with
        backoff, then bisect, then quarantine the singleton."""
        tag = telemetry.rung_tag(batch.key[0])
        rids = tuple(r.rid for r in batch.requests)
        for attempt in range(1, retries + 1):
            self.sleep_fn(self._backoff(tag, rids, attempt))
            self.events.append(("retry", tag, rids, attempt,
                                round(self.clock(), 9)))
            try:
                results = self._try_once(batch, attempt)
                self.breaker(batch.key).record_success(self.clock())
                return self._mark_recovered(results)
            except Exception as e:  # noqa: BLE001 — isolation boundary
                self._note_failure(batch, self.clock(), e, attempt)
        if len(batch.requests) == 1:
            return [self._quarantine(batch, attempts=retries + 1)]
        self.events.append(("bisect", tag, rids, round(self.clock(), 9)))
        mid = len(batch.requests) // 2
        out: List[RungResult] = []
        for part in (batch.requests[:mid], batch.requests[mid:]):
            sub = dataclasses.replace(batch, requests=tuple(part))
            try:
                # past the transient window (attempt > max_retries): only
                # genuinely poison sub-batches keep failing here
                results = self._try_once(sub, attempt=retries + 1)
                self.breaker(batch.key).record_success(self.clock())
                out.extend(self._mark_recovered(results))
            except Exception as e:  # noqa: BLE001 — isolation boundary
                self._note_failure(sub, self.clock(), e, attempt=retries + 1)
                out.extend(self._recover(sub, retries=1))
        return out


class RungServer:
    """The serving front-end: thread-safe submission over the pure
    scheduler, double-buffered execution, per-request futures.

    Synchronous use (tests, replay benchmarks, ``replay``)::

        clock = SimClock()
        server = RungServer(clock=clock, max_batch=4, max_delay=2e-3)
        fut = server.submit(matrix, rhs)
        clock.advance(2e-3); server.pump()   # deadline flush
        server.drain()
        result = fut.result(timeout=0)

    Threaded use (production shape): ``start()`` runs the same ``pump``
    loop on a background thread against the real clock; ``submit`` from
    any thread; ``stop()`` drains and joins.  The numerical pipeline is
    identical — the thread only moves *when* ``pump`` runs.

    ``device`` (None: the card, ``resolve_device``) is where the server's
    own executor computes; with an ``executor=`` of the caller's the
    server takes that executor's (if it has one).  Everything after
    ``max_delay`` is keyword-only.
    """

    def __init__(self, policy: Optional[GridBucketPolicy] = None,
                 max_batch: int = 8, max_delay: float = 10e-3, *,
                 impl=UNSET, tree_chunks: int = 8,
                 sweep=UNSET, regularize=UNSET, bucket: bool = True,
                 options: Optional[SolverOptions] = None,
                 clock=None, poll_interval: float = 1e-3,
                 max_queue: Optional[int] = None,
                 max_pending: Optional[int] = None,
                 degradation: Optional[DegradationPolicy] = None,
                 on_overload: str = "raise", max_retries: int = 2,
                 backoff_base: float = 1e-3, backoff_factor: float = 2.0,
                 breaker_threshold: int = 5, breaker_reset: float = 0.1,
                 injector="auto", straggler_factor: float = 3.0,
                 seed: int = 0, executor: Optional[RungExecutor] = None,
                 device=None):
        if on_overload not in ("raise", "shed"):
            raise ValueError(f"on_overload must be 'raise' or 'shed', "
                             f"got {on_overload!r}")
        opts = resolve_options(options, _where="RungServer",
                               impl=impl, sweep=sweep, regularize=regularize)
        if options is None and regularize is UNSET:
            opts = opts.replace(regularize=True)
        self.options = opts
        self.scheduler = RungScheduler(policy=policy, max_batch=max_batch,
                                       max_delay=max_delay,
                                       max_queue=max_queue,
                                       max_pending=max_pending,
                                       degradation=degradation)
        self.clock = clock if clock is not None else time.monotonic
        self.on_overload = on_overload
        self.poll_interval = poll_interval
        self.history: List[tuple] = []      # batch signatures, flush order
        self.events: List[tuple] = []       # resilience events, in order
        if injector == "auto":
            # opt-in chaos for CI legs / soak runs: REPRO_CHAOS_SEED=<int>
            # arms a seeded transient+straggler injector on every server
            cseed = os.environ.get("REPRO_CHAOS_SEED")
            injector = None if cseed is None else DispatchFaultInjector(
                seed=int(cseed), transient_rate=0.1, transient_attempts=1,
                straggler_rate=0.05, straggler_extra=5e-3)
        # offline (SimClock) runs burn waits by advancing the clock —
        # deterministic; wall-clock runs really sleep
        sleep_fn = clock.advance if isinstance(clock, SimClock) \
            else time.sleep
        inner = executor if executor is not None else RungExecutor(
            tree_chunks=tree_chunks, bucket=bucket, options=opts, device=device)
        self.device = getattr(inner, "device", None)
        self.executor = ResilientRungExecutor(
            inner, clock=self.clock, sleep_fn=sleep_fn, events=self.events,
            max_retries=max_retries, backoff_base=backoff_base,
            backoff_factor=backoff_factor, seed=seed,
            breaker_threshold=breaker_threshold, breaker_reset=breaker_reset,
            injector=injector, straggler_factor=straggler_factor,
            on_straggler=self._on_straggler)
        self._rids = itertools.count()
        self._lock = threading.RLock()
        self._outstanding: Dict[int, RungFuture] = {}
        self._inflight: Optional[_RInflight] = None
        self._thread: Optional[threading.Thread] = None
        self._stop_evt = threading.Event()

    def _on_straggler(self, now: float) -> None:
        with self._lock:
            self.scheduler.note_straggler(now)

    # -- submission ---------------------------------------------------------

    def submit(self, matrix: BandedCTSF, rhs=None,
               deadline: Optional[float] = None,
               on_overload: Optional[str] = None) -> RungFuture:
        """Queue one request; returns its future.  ``rhs`` is an optional
        ``(padded_n, k)`` panel in ``matrix.grid``'s padded layout, a tensor
        on any device or a host array; ``deadline`` an absolute clock time
        to flush by (the scheduler's ``max_delay`` applies regardless).

        Touches no device memory: the panel's shape is checked and the
        caller's objects are kept as they are (they reach the server's
        device at dispatch).  When the request's tensors sit on the card, an
        event is recorded on the caller's current stream, which the
        executor's stream waits on before it reads them.

        When an admission bound is hit, ``on_overload`` (per-call, else
        the server default) decides: ``"raise"`` propagates the typed
        :class:`RungOverloadError`; ``"shed"`` returns a future already
        resolved with ``STATUS_SHED`` / ``SHED_OVERLOAD``."""
        if rhs is not None:
            if not hasattr(rhs, "shape"):
                rhs = np.asarray(rhs, np.float32)
            if len(rhs.shape) != 2 or rhs.shape[0] != matrix.grid.padded_n:
                raise ValueError(
                    f"rhs must be (padded_n={matrix.grid.padded_n}, k), "
                    f"got {tuple(rhs.shape)}")
        ready = _client_fence(matrix, rhs)
        mode = on_overload if on_overload is not None else self.on_overload
        with self._lock:
            rid = next(self._rids)
            fut = RungFuture(rid)
            req = RungRequest(rid=rid, matrix=matrix, rhs=rhs,
                              deadline=deadline, future=fut,
                              submitted_wall=time.perf_counter(), ready=ready)
            now = self.clock()
            try:
                self.scheduler.submit(now, req)
            except RungOverloadError:
                if mode == "raise":
                    raise
                fut._resolve(self._shed_result(req, SHED_OVERLOAD, now))
                return fut
            self._outstanding[rid] = fut
        return fut

    # -- synchronous pump ---------------------------------------------------

    @property
    def pending(self) -> int:
        with self._lock:
            return self.scheduler.pending

    def next_flush_by(self) -> Optional[float]:
        with self._lock:
            return self.scheduler.next_flush_by()

    def pump(self) -> int:
        """One scheduler step at the current clock: emit due flushes and
        run them double-buffered.  Returns the number of batches
        emitted (0 = nothing was due; shed batches count too)."""
        now = self.clock()
        with self._lock:
            batches = self.scheduler.tick(now)
            if len(self._outstanding) > 4 * max(
                    1, self.scheduler.max_batch):
                self._outstanding = {rid: f for rid, f
                                     in self._outstanding.items()
                                     if not f.done()}
        self._run(batches)
        return len(batches)

    def drain(self) -> int:
        """Flush every queued request and finalize all in-flight work —
        after this, every submitted future is resolved."""
        now = self.clock()
        with self._lock:
            batches = self.scheduler.drain(now)
        self._run(batches)
        self._finalize_inflight()
        return len(batches)

    def _shed_result(self, req: RungRequest, detail: str,
                     now: float) -> RungResult:
        wall = time.perf_counter() - req.submitted_wall \
            if req.submitted_wall else 0.0
        rung = telemetry.rung_tag(req.rung) if req.rung is not None \
            else telemetry.rung_tag(req.matrix.grid)
        return RungResult(rid=req.rid, status=STATUS_SHED, attempts=0,
                          tau=0.0, x=None, factor=None,
                          latency=now - req.arrival, wall_latency_s=wall,
                          flush_reason=FLUSH_SHED, batch_size=1, rung=rung,
                          detail=detail)

    def _resolve_shed(self, batch: RungBatch,
                      detail: Optional[str] = None) -> None:
        """Resolve every request of a never-dispatched batch with an
        explicit STATUS_SHED result — shedding is always a result, never
        a dropped or hanging future."""
        detail = detail if detail is not None else \
            (batch.detail or SHED_DEADLINE)
        for req in batch.requests:
            res = self._shed_result(req, detail, batch.decided_at)
            if req.future is not None:
                req.future._resolve(res)
        if telemetry.enabled():
            telemetry.inc("serving.completed", len(batch.requests),
                          outcome="shed")

    def _run(self, batches: List[RungBatch]) -> None:
        # double buffer: dispatch batch N+1 before blocking on batch N,
        # so host-side assembly overlaps device execution of the
        # previous batch (the executor's stream carries the rest)
        for batch in batches:
            self.history.append(batch.signature())
            if batch.reason == FLUSH_SHED:
                self._resolve_shed(batch)
                continue
            if not self.executor.allow(batch.key, batch.decided_at):
                # rung breaker open: shed without touching the device —
                # healthy rungs keep dispatching around it
                self.events.append(
                    ("breaker_shed", telemetry.rung_tag(batch.key[0]),
                     tuple(r.rid for r in batch.requests),
                     round(batch.decided_at, 9)))
                self._resolve_shed(batch, detail=SHED_BREAKER)
                continue
            nxt = self.executor.dispatch(batch, batch.decided_at)
            prev, self._inflight = self._inflight, nxt
            if prev is not None:
                self.executor.finalize(prev, batch.decided_at)

    def _finalize_inflight(self) -> None:
        prev, self._inflight = self._inflight, None
        if prev is not None:
            self.executor.finalize(prev, self.clock())

    # -- threaded pump (production shape; the slow e2e smoke test) ----------

    def start(self) -> None:
        """Run the pump loop on a background thread (real clock)."""
        if self._thread is not None:
            raise RuntimeError("server already started")
        self._stop_evt.clear()
        self._thread = threading.Thread(target=self._loop,
                                        name="rung-server-pump", daemon=True)
        self._thread.start()

    def _loop(self) -> None:
        while not self._stop_evt.is_set():
            if self.pump() == 0:
                # nothing due: settle the in-flight buffer so a lone
                # trailing batch doesn't wait for the next flush, then
                # sleep at most to the next deadline boundary
                self._finalize_inflight()
                nxt = self.next_flush_by()
                wait = self.poll_interval if nxt is None else \
                    max(0.0, min(self.poll_interval, nxt - self.clock()))
                self._stop_evt.wait(wait)

    def stop(self, drain: bool = True, timeout: float = 120.0) -> None:
        """Stop the pump thread and leave **no future unresolved**.

        By default the queue is drained first so pending work completes
        normally.  If the pump thread does not join within ``timeout``
        (a wedged executor — e.g. a dispatch stuck in a device call),
        draining would wedge this caller too: instead the scheduler is
        aborted and every still-unresolved future — queued, in-flight,
        or mid-dispatch — resolves with a terminal ``STATUS_SHED`` /
        ``SHED_SHUTDOWN`` result.  Either way ``stop`` returns with zero
        outstanding futures (asserted), so no client blocks forever on a
        server that no longer exists."""
        if self._thread is None:
            return
        self._stop_evt.set()
        self._thread.join(timeout=timeout)
        wedged = self._thread.is_alive()
        self._thread = None
        if drain and not wedged:
            self.drain()
        # terminal sweep: whatever is still unresolved (everything, when
        # wedged; shed buffers and races otherwise) resolves as shed
        with self._lock:
            now = self.clock()
            for req in self.scheduler.abort():
                if req.future is not None and not req.future.done():
                    req.future._resolve(
                        self._shed_result(req, SHED_SHUTDOWN, now))
            unresolved = [f for f in self._outstanding.values()
                          if not f.done()]
            for fut in unresolved:
                res = RungResult(
                    rid=fut.rid, status=STATUS_SHED, attempts=0, tau=0.0,
                    x=None, factor=None, latency=0.0, wall_latency_s=0.0,
                    flush_reason=FLUSH_SHED, batch_size=1, rung="",
                    detail=SHED_SHUTDOWN)
                fut._resolve(res)
            leftover = [f.rid for f in self._outstanding.values()
                        if not f.done()]
            assert not leftover, \
                f"stop() left futures unresolved: {leftover}"
            self._outstanding = {}


def replay(server: RungServer, clock: SimClock,
           arrivals: Sequence[tuple]) -> List[RungFuture]:
    """Drive a server deterministically through a timed arrival list.

    ``arrivals`` is a sequence of ``(arrival_time, matrix, rhs, deadline)``
    in nondecreasing arrival order (``rhs``/``deadline`` may be None).
    The clock advances only to arrival times and scheduler flush
    boundaries — exactly the event points a real-time loop would act
    at — then the tail is pumped dry and drained.  Returns the futures in
    submission order, all resolved.  Replaying the same list against a
    fresh server reproduces ``server.history`` and every numerical result
    bit for bit."""
    futures: List[RungFuture] = []
    for arrival, matrix, rhs, deadline in arrivals:
        while True:
            nxt = server.next_flush_by()
            if nxt is None or nxt > arrival:
                break
            clock.advance_to(nxt)
            server.pump()
        clock.advance_to(arrival)
        futures.append(server.submit(matrix, rhs, deadline=deadline))
        server.pump()
    while server.pending:
        nxt = server.next_flush_by()
        clock.advance_to(nxt)
        server.pump()
    server.drain()
    return futures


def _build_arrivals(stream, t: int = 8, device=None):
    """Materialize a ``data.synthetic.request_stream`` spec list into
    (arrival, matrix, rhs, deadline) tuples for :func:`replay`, the
    matrices and panels on ``device`` (None: the card): the reference's
    matrices, grids and panels for the same specs."""
    from repro_torch.data.gmrf import make_arrowhead
    arrivals = []
    grids: Dict[tuple, Any] = {}
    for spec in stream:
        n, bw, ar = spec["case"]
        A, _st = make_arrowhead(n, bw, ar, rho=0.7, seed=spec["seed"] % 97)
        key = spec["case"]
        if key not in grids:
            grids[key] = TileGrid(_st, t=t)
        grid = grids[key]
        mat = BandedCTSF.from_sparse(A, grid, device=device)
        rng = np.random.default_rng(spec["seed"])
        rhs = None
        if spec["k"]:
            rhs = np.zeros((grid.padded_n, spec["k"]), np.float32)
            rows = grid.padded_indices(np.arange(n))
            rhs[rows] = rng.standard_normal((n, spec["k"])).astype(np.float32)
            rhs = torch.from_numpy(rhs).to(mat.device)
        arrivals.append((spec["arrival"], mat, rhs, spec["deadline"]))
    return arrivals


def main(argv=None) -> None:
    """Command line: replay a seeded Poisson mixed-grid stream through the
    server and print throughput/latency/flush statistics."""
    from repro_torch.data.synthetic import request_stream
    p = argparse.ArgumentParser(description=__doc__.split("\n", 1)[0])
    p.add_argument("--requests", type=int, default=32)
    p.add_argument("--rate", type=float, default=2000.0,
                   help="arrivals per clock unit (Poisson)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--k", type=int, default=4, help="RHS panel width")
    p.add_argument("--max-batch", type=int, default=4)
    p.add_argument("--max-delay", type=float, default=2e-3)
    p.add_argument("--impl", default=None)
    p.add_argument("--device", default=None,
                   help="where to serve (default: the card; 'cpu' runs the plain versions)")
    args = p.parse_args(argv)

    cases = [(64, 6, 4), (96, 12, 8), (120, 16, 4), (136, 10, 8)]
    stream = request_stream(args.seed, cases, args.requests, rate=args.rate,
                            k=args.k)
    device = resolve_device(args.device)
    arrivals = _build_arrivals(stream, device=device)
    clock = SimClock()
    server = RungServer(max_batch=args.max_batch, max_delay=args.max_delay,
                        options=SolverOptions(impl=args.impl,
                                              regularize=True),
                        clock=clock, device=device)
    t0 = time.perf_counter()
    futures = replay(server, clock, arrivals)
    wall = time.perf_counter() - t0
    results = [f.result(timeout=0) for f in futures]
    lats = sorted(r.wall_latency_s for r in results)
    reasons: Dict[str, int] = {}
    for sig in server.history:
        reasons[sig[3]] = reasons.get(sig[3], 0) + 1
    print(f"served {len(results)} requests on {device} in {wall:.3f}s "
          f"({len(results) / wall:.1f} req/s) over "
          f"{len(server.history)} batches")
    print(f"flush reasons: {reasons}")
    print(f"wall latency p50 {lats[len(lats) // 2] * 1e3:.2f} ms, "
          f"p99 {lats[min(len(lats) - 1, int(0.99 * len(lats)))] * 1e3:.2f} "
          f"ms")
    print("statuses:", {s: sum(r.status == s for r in results)
                        for s in sorted({r.status for r in results})})


if __name__ == "__main__":
    main()
