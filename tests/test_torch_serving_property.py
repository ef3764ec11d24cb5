"""Hypothesis property tests of the port's rung-server batcher, against
the JAX package's: the properties of ``tests/test_serving_property.py``
at its ``max_examples``, each plan also run through the reference.

* conservation, the deadline budget and rung keying hold for the port's
  scheduler over arbitrary arrival/deadline interleavings, and its batches
  are the reference's signature for signature;
* the same plan replayed twice gives the same signatures;
* a full server (scripted executor, injected faults, admission bounds)
  resolves every request exactly once with a status in the closed set
  {OK, RECOVERED, FAILED, SHED}, and its history, events and outcomes are
  the reference's."""
import types

import numpy as np
import pytest

import repro.core as J
from repro.launch import rung_server as JR
from repro.runtime import telemetry as jtelemetry
from repro_torch.core import (STATUS_FAILED, STATUS_OK, STATUS_RECOVERED, STATUS_SHED,
                              GridBucketPolicy, TileGrid)
from repro_torch.launch import rung_server as PR
from repro_torch.launch.rung_server import FLUSH_FULL, FLUSH_SHED, SHED_DEADLINE
from repro_torch.runtime import telemetry

pytest.importorskip("hypothesis", reason="property tests need the hypothesis package")
from hypothesis import given, settings, strategies as st  # noqa: E402

pytestmark = pytest.mark.serving

SETTINGS = dict(max_examples=12, deadline=None)
_GRID = {PR: TileGrid, JR: J.TileGrid}
_TEL = {PR: telemetry, JR: jtelemetry}
TERMINAL = {STATUS_OK, STATUS_RECOVERED, STATUS_FAILED, STATUS_SHED}


def _fake_request(mod, rid, grid, k=None, deadline=None):
    rhs = None if k is None else np.zeros((1, k), np.float32)
    return mod.RungRequest(rid=rid, matrix=types.SimpleNamespace(grid=grid),
                           rhs=rhs, deadline=deadline)


def _grid(mod, ndt):
    return _GRID[mod].from_tile_counts(8, ndt, 1, 1)


@st.composite
def arrival_plan(draw):
    """(max_batch, max_delay, [(gap, ndt, k, rel_deadline)...]) — arbitrary
    mixed-rung arrivals with optional per-request deadlines."""
    max_batch = draw(st.integers(1, 4))
    max_delay = draw(st.sampled_from([0.0, 0.5, 2.0]))
    events = draw(st.lists(st.tuples(
        st.floats(0.0, 1.0, allow_nan=False, allow_infinity=False),
        st.integers(3, 10),                       # source ndt
        st.sampled_from([None, 1, 3]),            # rhs width
        st.sampled_from([None, 0.0, 0.25, 1.0]),  # deadline - arrival
    ), min_size=1, max_size=16))
    return max_batch, max_delay, events


def _drive(mod, plan):
    """One scheduler driven through ``plan`` as the reference test does:
    returns the flushed batches, the requests by rid, the tick times and
    the policy."""
    max_batch, max_delay, events = plan
    policy = GridBucketPolicy() if mod is PR else J.GridBucketPolicy()
    s = mod.RungScheduler(policy=policy, max_batch=max_batch, max_delay=max_delay)
    flushed, requests, ticks = [], {}, []
    now = 0.0
    for rid, (gap, ndt, k, rel_dl) in enumerate(events):
        now += gap
        req = _fake_request(mod, rid, _grid(mod, ndt), k=k,
                            deadline=None if rel_dl is None else now + rel_dl)
        requests[rid] = req
        flushed += s.tick(now, [req])
        ticks.append(now)
        nxt = s.next_flush_by()
        if nxt is not None and nxt <= now:
            # a zero-budget deadline flushes on the very next tick
            flushed += s.tick(now)
            ticks.append(now)
    end = now + max_delay + 1.0
    flushed += s.tick(end)
    flushed += s.drain(end)
    ticks.append(end)
    return flushed, requests, ticks, policy


@given(arrival_plan())
@settings(max_examples=25, deadline=None)
def test_scheduler_invariants(plan):
    """Conservation + deadline budget + rung keying, in one sweep, and the
    reference's batches."""
    flushed, requests, ticks, policy = _drive(PR, plan)
    jflushed, *_ = _drive(JR, plan)
    assert [b.signature() for b in flushed] == [b.signature() for b in jflushed]
    seen = [r.rid for b in flushed for r in b.requests]
    assert sorted(seen) == sorted(requests)       # no loss, no duplication
    for b in flushed:
        cgrid, k = b.key
        for r in b.requests:
            assert cgrid == policy.canonicalize(r.matrix.grid)
            assert r.k == k
            if b.reason == FLUSH_SHED:
                assert b.detail == SHED_DEADLINE
                assert r.deadline is not None and b.decided_at > r.deadline
            else:
                first_due = min(t for t in ticks if t >= r.flush_by)
                assert b.decided_at <= first_due or b.reason == FLUSH_FULL


@given(arrival_plan())
@settings(**SETTINGS)
def test_scheduler_replay_identical(plan):
    """The state machine is deterministic: the same plan replayed twice
    gives the same batch signatures in the same order."""
    max_batch, max_delay, events = plan

    def run():
        s = PR.RungScheduler(max_batch=max_batch, max_delay=max_delay)
        out, now = [], 0.0
        for i, (gap, ndt, k, rel_dl) in enumerate(events):
            now += gap
            out += s.tick(now, [_fake_request(
                PR, i, _grid(PR, ndt), k=k,
                deadline=None if rel_dl is None else now + rel_dl)])
        out += s.drain(now + max_delay + 1.0)
        return [b.signature() for b in out]

    assert run() == run()


# ---------------------------------------------------------------------------
# full-server resilience property: conservation under faults + overload
# ---------------------------------------------------------------------------

class _ChaoticExecutor:
    """Fake device of package ``mod``: resolves futures with OK results,
    but fails dispatch for scripted rids — ``poison`` forever, ``flaky``
    once each."""

    def __init__(self, mod, poison, flaky):
        self.mod = mod
        self.poison = set(poison)
        self.flaky = dict.fromkeys(flaky, 1)

    def dispatch(self, batch, now):
        for r in batch.requests:
            if r.rid in self.poison:
                raise RuntimeError(f"poison {r.rid}")
        for r in batch.requests:
            if self.flaky.get(r.rid, 0) > 0:
                self.flaky[r.rid] -= 1
                raise RuntimeError(f"flaky {r.rid}")
        return batch

    def finalize(self, batch, now):
        out = []
        for r in batch.requests:
            res = self.mod.RungResult(
                rid=r.rid, status=STATUS_OK, attempts=1, tau=0.0, x=None, factor=None,
                latency=now - r.arrival, wall_latency_s=0.0, flush_reason=batch.reason,
                batch_size=len(batch.requests), rung=_TEL[self.mod].rung_tag(batch.key[0]))
            if r.future is not None:
                r.future._resolve(res)
            out.append(res)
        return out


@st.composite
def server_plan(draw):
    """Arbitrary interleaving of arrivals (gap, rung, deadline, fault)
    with server-shape knobs: queue bounds, overload mode, degradation."""
    events = draw(st.lists(st.tuples(
        st.sampled_from([0.0, 4e-4, 1.1e-3, 6e-3]),   # inter-arrival gap
        st.sampled_from([6, 9]),                       # rung (source ndt)
        st.sampled_from([None, 0.0, 1e-3, 5e-3]),      # deadline - arrival
        st.sampled_from([None, "flaky", "poison"]),    # dispatch fault
    ), min_size=1, max_size=24))
    max_queue = draw(st.sampled_from([None, 1, 2, 4]))
    on_overload = draw(st.sampled_from(["raise", "shed"]))
    degrade = draw(st.booleans())
    max_batch = draw(st.integers(1, 3))
    return events, max_queue, on_overload, degrade, max_batch


def _serve_plan(mod, plan):
    events, max_queue, on_overload, degrade, max_batch = plan
    poison = {i for i, e in enumerate(events) if e[3] == "poison"}
    flaky = {i for i, e in enumerate(events) if e[3] == "flaky"}
    clock = mod.SimClock()
    server = mod.RungServer(
        clock=clock, executor=_ChaoticExecutor(mod, poison, flaky),
        injector=None, max_batch=max_batch, max_delay=2e-3,
        max_queue=max_queue, on_overload=on_overload,
        degradation=mod.DegradationPolicy(step_dwell=0.0) if degrade else None,
        max_retries=1, backoff_base=1e-5, breaker_threshold=3,
        breaker_reset=5e-3)
    futures, rejected = {}, []
    for i, (gap, ndt, rel_dl, _fault) in enumerate(events):
        clock.advance(gap)
        dl = None if rel_dl is None else clock.now + rel_dl
        try:
            futures[i] = server.submit(types.SimpleNamespace(grid=_grid(mod, ndt)),
                                       deadline=dl)
        except mod.RungOverloadError:
            rejected.append(i)             # typed backpressure, no future
        server.pump()
    server.drain()
    return server, futures, rejected, poison


@given(server_plan())
@settings(max_examples=20, deadline=None)
def test_server_conservation_under_faults_and_overload(plan):
    """No request is ever lost, duplicated or left unresolved, every
    terminal status is in the closed taxonomy, and the run is the
    reference's."""
    server, futures, rejected, poison = _serve_plan(PR, plan)
    jserver, jfutures, jrejected, _ = _serve_plan(JR, plan)
    assert len(futures) + len(rejected) == len(plan[0])   # every event accounted
    outcome = {}
    for i, fut in futures.items():
        assert fut.done()                          # nothing left hanging
        r = fut.result(timeout=0)
        assert r.rid == fut.rid
        assert r.status in TERMINAL                # closed status taxonomy
        assert fut.duplicate_resolves == 0         # resolved exactly once
        if i in poison and r.status != STATUS_SHED:
            assert r.status == STATUS_FAILED       # poison never "succeeds"
        if r.status == STATUS_SHED:
            assert r.detail                        # shed always says why
        outcome[i] = (r.rid, r.status, r.detail, r.attempts, r.flush_reason, r.latency)
    joutcome = {i: (r.rid, r.status, r.detail, r.attempts, r.flush_reason, r.latency)
                for i, r in ((i, f.result(timeout=0)) for i, f in jfutures.items())}
    assert (server.history, server.events, rejected, outcome) == \
        (jserver.history, jserver.events, jrejected, joutcome)
