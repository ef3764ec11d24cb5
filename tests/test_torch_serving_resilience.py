"""The port's rung-server resilience (admission control, shedding,
dispatch-failure isolation, circuit breaking, graceful degradation,
shutdown) against the JAX package's, on the CPU: the cases of
``tests/test_serving_resilience.py``.

Each scenario runs thread-free on a ``SimClock`` with scripted executors
(no device work) through both packages' servers and schedulers, and the
port's ``history``, ``events`` and every result's (rid, status, detail,
attempts, flush reason, latency) must equal the reference's, besides the
reference test's own contracts; the seeded chaos injector must make the
same decisions; the wedged-shutdown case runs on the port's threaded pump
with a timeout on every wait."""
import threading
import time
import types

import pytest

import repro.core as J
from repro.core.batching import RungQueue as JRungQueue
from repro.launch import rung_server as JR
from repro.runtime import fault_tolerance as jft
from repro.runtime import telemetry as jtelemetry
from repro_torch.core import STATUS_FAILED, STATUS_OK, STATUS_RECOVERED, STATUS_SHED, TileGrid
from repro_torch.core.batching import RungQueue, RungQueueFull
from repro_torch.data.synthetic import request_stream
from repro_torch.launch import rung_server as PR
from repro_torch.launch.rung_server import (FLUSH_DEADLINE, FLUSH_SHED, SHED_BREAKER,
                                            SHED_DEADLINE, SHED_OVERLOAD, SHED_SHUTDOWN,
                                            SHED_SLACK, CircuitBreaker, RungServer)
from repro_torch.runtime import fault_tolerance as pft
from repro_torch.runtime import telemetry

pytestmark = pytest.mark.serving

_GRID = {PR: TileGrid, JR: J.TileGrid}
_TEL = {PR: telemetry, JR: jtelemetry}
_FT = {PR: pft, JR: jft}


def _grid(mod, ndt=6):
    return _GRID[mod].from_tile_counts(8, ndt, 1, 1)


def _fake_request(mod, rid, grid, deadline=None):
    return mod.RungRequest(rid=rid, matrix=types.SimpleNamespace(grid=grid),
                           rhs=None, deadline=deadline)


def _stub_matrix(mod, ndt=6):
    return types.SimpleNamespace(grid=_grid(mod, ndt))


class ScriptedExecutor:
    """Duck-typed RungExecutor of package ``mod`` whose failures are
    scripted per rid: ``poison`` rids raise on every dispatch,
    ``flaky[rid] = n`` raises on the first ``n`` dispatches that include
    the rid.  Counts dispatches so tests can assert shed batches never touch
    the 'device'."""

    def __init__(self, mod, poison=(), flaky=None):
        self.mod = mod
        self.poison = set(poison)
        self.flaky = dict(flaky or {})
        self.dispatches = 0
        self.dispatched_rids = []

    def dispatch(self, batch, now):
        self.dispatches += 1
        rids = [r.rid for r in batch.requests]
        for rid in rids:
            if rid in self.poison:
                raise RuntimeError(f"poison rid {rid}")
        for rid in rids:
            if self.flaky.get(rid, 0) > 0:
                self.flaky[rid] -= 1
                raise RuntimeError(f"flaky rid {rid}")
        self.dispatched_rids.extend(rids)
        return batch

    def finalize(self, batch, now):
        results = []
        for r in batch.requests:
            res = self.mod.RungResult(
                rid=r.rid, status=STATUS_OK, attempts=1, tau=0.0, x=None, factor=None,
                latency=now - r.arrival, wall_latency_s=0.0, flush_reason=batch.reason,
                batch_size=len(batch.requests), rung=_TEL[self.mod].rung_tag(batch.key[0]))
            if r.future is not None:
                r.future._resolve(res)
            results.append(res)
        return results


def _server(mod, clock=None, executor=None, **kw):
    kw.setdefault("max_batch", 4)
    kw.setdefault("max_delay", 1e-3)
    kw.setdefault("injector", None)
    kw.setdefault("backoff_base", 1e-6)
    return mod.RungServer(clock=clock or mod.SimClock(),
                          executor=executor or ScriptedExecutor(mod), **kw)


def _outcome(server, futs):
    """What a scenario must reproduce across packages."""
    res = [f.result(timeout=0) for f in futs]
    return (list(server.history), list(server.events),
            [(r.rid, r.status, r.detail, r.attempts, r.flush_reason, r.batch_size, r.rung,
              r.latency) for r in res])


def _both(scenario):
    """``scenario(mod)`` on both packages; the port's outcome (whatever the
    scenario returns) must equal the reference's."""
    got, want = scenario(PR), scenario(JR)
    assert got == want
    return got


# ---------------------------------------------------------------------------
# bounded queues (core/batching.py)
# ---------------------------------------------------------------------------

def test_rung_queue_bound_and_shedding_primitives():
    for cls in (RungQueue, JRungQueue):
        q = cls(maxlen=2)
        q.push("a", 1.0)
        q.push("b", 2.0)
        assert q.full
        with pytest.raises(Exception) as ei:
            q.push("c", 3.0)
        assert ei.value.depth == 2 and ei.value.maxlen == 2
        assert q.remove_if(lambda it: it == "a") == ["a"]
        q.push("c", 0.5)
        assert q.evict_min(lambda it: 0.0) == "b"      # ties go to the oldest
        assert q.pop() == ["c"]
    with pytest.raises(RungQueueFull):
        q = RungQueue(maxlen=1)
        q.push(1, 0.0)
        q.push(2, 0.0)


# ---------------------------------------------------------------------------
# admission control + typed backpressure
# ---------------------------------------------------------------------------

def test_submit_raises_typed_overload_on_rung_bound():
    def scenario(mod):
        server = _server(mod, max_queue=2, max_delay=10.0)
        for _ in range(2):
            server.submit(_stub_matrix(mod))
        with pytest.raises(mod.RungOverloadError) as ei:
            server.submit(_stub_matrix(mod))
        server.submit(_stub_matrix(mod, ndt=12))        # other rungs are unaffected
        return ei.value.scope, ei.value.rung, ei.value.depth, ei.value.limit, str(ei.value)

    assert _both(scenario)[0] == "rung"


def test_submit_raises_on_global_bound():
    def scenario(mod):
        server = _server(mod, max_pending=2, max_delay=10.0)
        server.submit(_stub_matrix(mod, ndt=6))
        server.submit(_stub_matrix(mod, ndt=12))
        with pytest.raises(mod.RungOverloadError) as ei:
            server.submit(_stub_matrix(mod, ndt=9))
        return ei.value.scope, ei.value.depth, ei.value.limit

    assert _both(scenario)[0] == "global"


def test_overload_shed_mode_resolves_future_immediately():
    def scenario(mod):
        server = _server(mod, max_queue=1, max_delay=10.0, on_overload="shed")
        server.submit(_stub_matrix(mod))
        r = server.submit(_stub_matrix(mod)).result(timeout=0)
        server2 = _server(mod, max_queue=1, max_delay=10.0)
        server2.submit(_stub_matrix(mod))
        r2 = server2.submit(_stub_matrix(mod), on_overload="shed").result(timeout=0)
        return [(x.status, x.detail, x.ok(), x.flush_reason) for x in (r, r2)]

    (r, r2) = _both(scenario)
    assert r == (STATUS_SHED, SHED_OVERLOAD, False, FLUSH_SHED)
    assert r2[0] == STATUS_SHED


# ---------------------------------------------------------------------------
# deadline-expiry shedding
# ---------------------------------------------------------------------------

def _signatures(batches):
    return [b.signature() for b in batches]


def test_expired_requests_shed_never_dispatch():
    def scenario(mod):
        s = mod.RungScheduler(max_batch=8, max_delay=10.0)
        g = _grid(mod)
        s.submit(0.0, _fake_request(mod, 0, g, deadline=1.0))
        s.submit(0.0, _fake_request(mod, 1, g))
        first = s.tick(1.5)
        pending = s.pending
        return _signatures(first), pending, _signatures(s.tick(10.0))

    first, pending, late = _both(scenario)
    assert [(b[3], b[4], b[2]) for b in first] == [(FLUSH_SHED, SHED_DEADLINE, (0,))]
    assert pending == 1
    assert [(b[3], b[2]) for b in late] == [(FLUSH_DEADLINE, (1,))]


def test_flush_at_exact_deadline_still_serves():
    def scenario(mod):
        s = mod.RungScheduler(max_batch=8, max_delay=10.0)
        s.submit(0.0, _fake_request(mod, 0, _grid(mod), deadline=2.0))
        return _signatures(s.tick(2.0))

    ((_, _, _, reason, _),) = _both(scenario)
    assert reason == FLUSH_DEADLINE


def test_dead_on_arrival_is_shed():
    def scenario(mod):
        s = mod.RungScheduler(max_batch=8, max_delay=10.0)
        s.submit(5.0, _fake_request(mod, 0, _grid(mod), deadline=1.0))
        return _signatures(s.tick(5.0))

    ((_, _, _, reason, detail),) = _both(scenario)
    assert (reason, detail) == (FLUSH_SHED, SHED_DEADLINE)


def test_shed_future_resolves_with_status_shed_and_no_device_time():
    def scenario(mod):
        clock = mod.SimClock()
        ex = ScriptedExecutor(mod)
        server = _server(mod, clock=clock, executor=ex, max_delay=10.0)
        fut = server.submit(_stub_matrix(mod), deadline=1.0)
        clock.advance(2.0)
        server.pump()
        r = fut.result(timeout=0)
        assert r.x is None and r.factor is None
        return _outcome(server, [fut]), ex.dispatches

    (history, _, ((_, status, detail, _, reason, _, _, _),)), dispatches = _both(scenario)
    assert (status, detail, reason) == (STATUS_SHED, SHED_DEADLINE, FLUSH_SHED)
    assert dispatches == 0                        # never touched the device
    assert history[-1][3:] == (FLUSH_SHED, SHED_DEADLINE)


# ---------------------------------------------------------------------------
# dispatch-failure isolation: retry, bisect, quarantine
# ---------------------------------------------------------------------------

def test_transient_failure_retries_and_recovers():
    def scenario(mod):
        clock = mod.SimClock()
        server = _server(mod, clock=clock, executor=ScriptedExecutor(mod, flaky={0: 1}),
                         max_retries=2)
        futs = [server.submit(_stub_matrix(mod)) for _ in range(2)]
        clock.advance(1e-3)
        server.pump()
        server.drain()
        return _outcome(server, futs)

    _, events, results = _both(scenario)
    assert [r[1] for r in results] == [STATUS_RECOVERED] * 2
    kinds = [e[0] for e in events]
    assert "retry" in kinds and "quarantine" not in kinds


def test_poison_request_quarantined_siblings_survive():
    def scenario(mod):
        clock = mod.SimClock()
        server = _server(mod, clock=clock, executor=ScriptedExecutor(mod, poison={2}),
                         max_retries=1)
        futs = [server.submit(_stub_matrix(mod)) for _ in range(4)]
        clock.advance(1e-3)
        server.pump()
        server.drain()
        rs = [f.result(timeout=0) for f in futs]
        assert rs[2].x is None and rs[2].factor is None
        return _outcome(server, futs), [f.duplicate_resolves for f in futs]

    (_, events, results), dups = _both(scenario)
    assert results[2][1:3] == (STATUS_FAILED, "dispatch_failed")
    assert all(results[i][1] == STATUS_RECOVERED for i in (0, 1, 3))
    kinds = [e[0] for e in events]
    assert "bisect" in kinds and "quarantine" in kinds
    assert dups == [0, 0, 0, 0]                  # every future resolved once


def test_backoff_burns_injected_clock_deterministically():
    def scenario(mod):
        clock = mod.SimClock()
        server = _server(mod, clock=clock, executor=ScriptedExecutor(mod, flaky={0: 2}),
                         max_retries=3, backoff_base=1e-3)
        fut = server.submit(_stub_matrix(mod))
        clock.advance(1e-3)
        server.pump()
        server.drain()
        return _outcome(server, [fut]), clock.now

    first, again = _both(scenario), scenario(PR)
    assert first == again                         # backoff replays exactly
    (_, _, ((_, status, *_),)), now = first
    assert status == STATUS_RECOVERED and now > 2e-3   # retries actually waited


# ---------------------------------------------------------------------------
# circuit breaker
# ---------------------------------------------------------------------------

def test_breaker_state_machine():
    def scenario(mod):
        br = mod.CircuitBreaker(failure_threshold=2, reset_timeout=1.0)
        trace = [br.allow(0.0), br.state]
        br.record_failure(0.0)
        trace.append(br.state)
        br.record_failure(0.1)
        trace += [br.state, br.allow(0.5), br.allow(1.2), br.state]
        br.record_failure(1.3)
        trace += [br.state, br.allow(1.4), br.allow(2.4), br.state]
        br.record_success(2.5)
        return trace + [br.state, br.failures]

    assert _both(scenario) == [True, "closed", "closed", "open", False, True, "half_open",
                               "open", False, True, "half_open", "closed", 0]
    with pytest.raises(ValueError):
        CircuitBreaker(failure_threshold=0)


def test_open_breaker_sheds_rung_but_not_neighbors():
    def scenario(mod):
        clock = mod.SimClock()
        ex = ScriptedExecutor(mod, poison={0, 1, 2})      # rung ndt=6 always fails
        server = _server(mod, clock=clock, executor=ex, max_retries=0,
                         breaker_threshold=2, breaker_reset=100.0, max_batch=1)
        bad = [server.submit(_stub_matrix(mod, ndt=6)) for _ in range(3)]
        good = [server.submit(_stub_matrix(mod, ndt=12)) for _ in range(3)]
        clock.advance(1e-3)
        server.pump()
        server.drain()
        return _outcome(server, bad + good)

    _, events, results = _both(scenario)
    assert [r[1] for r in results[:3]] == [STATUS_FAILED, STATUS_FAILED, STATUS_SHED]
    assert results[2][2] == SHED_BREAKER
    assert all(r[1] == STATUS_OK for r in results[3:])
    assert [e[2] for e in events if e[0] == "breaker"] == ["open"]


def test_breaker_recovers_through_half_open_trial():
    def scenario(mod):
        clock = mod.SimClock()
        server = _server(mod, clock=clock, executor=ScriptedExecutor(mod, flaky={0: 1, 1: 1}),
                         max_retries=0, breaker_threshold=2, breaker_reset=0.5,
                         max_batch=1, max_delay=1e-3)
        f0 = server.submit(_stub_matrix(mod))
        f1 = server.submit(_stub_matrix(mod))
        clock.advance(1e-3)
        server.pump()
        server.drain()
        f2 = server.submit(_stub_matrix(mod))            # while open: shed
        clock.advance(2e-3)
        server.pump()
        clock.advance(0.5)                                # past reset_timeout
        f3 = server.submit(_stub_matrix(mod))
        clock.advance(1e-3)
        server.pump()                                     # half-open trial succeeds
        server.drain()
        return _outcome(server, [f0, f1, f2, f3])

    _, events, results = _both(scenario)
    assert [r[1] for r in results] == [STATUS_FAILED, STATUS_FAILED, STATUS_SHED, STATUS_OK]
    assert results[2][2] == SHED_BREAKER
    assert [e[2] for e in events if e[0] == "breaker"] == ["open", "half_open", "closed"]


# ---------------------------------------------------------------------------
# graceful degradation
# ---------------------------------------------------------------------------

def test_degradation_steps_up_and_sheds_lowest_slack():
    def scenario(mod):
        pol = mod.DegradationPolicy(high_watermark=0.5, low_watermark=0.1,
                                    step_dwell=0.0, recover_dwell=1.0)
        s = mod.RungScheduler(max_batch=8, max_delay=1.0, max_queue=4, degradation=pol)
        g = _grid(mod)
        for i in range(4):
            s.submit(float(i) * 1e-3, _fake_request(mod, i, g, deadline=10.0 + i))
        knobs = (s.level, s.effective_max_delay(), s.effective_max_batch())
        s.submit(4e-3, _fake_request(mod, 9, g, deadline=99.0))
        return knobs, _signatures(s.tick(5e-3))

    (level, delay, batch), sigs = _both(scenario)
    assert level >= 1 and delay < 1.0 and batch < 8
    shed = [b for b in sigs if b[3] == FLUSH_SHED]
    assert len(shed) == 1 and shed[0][4] == SHED_SLACK and shed[0][2] == (0,)


def test_degradation_recovers_hysteretically():
    def scenario(mod):
        pol = mod.DegradationPolicy(high_watermark=0.5, low_watermark=0.25,
                                    step_dwell=0.0, recover_dwell=1.0, max_level=1)
        s = mod.RungScheduler(max_batch=8, max_delay=1.0, max_queue=4, degradation=pol)
        g = _grid(mod)
        for i in range(4):
            s.submit(0.0, _fake_request(mod, i, g))
        levels = [s.level]
        for now in (1.0, 1.5, 2.5):
            s.tick(now)
            levels.append(s.level)
        return levels

    assert _both(scenario) == [1, 1, 1, 0]


def test_straggler_flags_feed_degradation():
    def scenario(mod):
        s = mod.RungScheduler(max_batch=8, max_delay=1.0,
                              degradation=mod.DegradationPolicy(straggler_trigger=2,
                                                                step_dwell=0.0))
        s.note_straggler(0.0)
        first = s.level
        s.note_straggler(0.1)
        return first, s.level

    assert _both(scenario) == (0, 1)


def test_straggler_monitor_flags_outliers():
    def scenario(mod):
        m = _FT[mod].StragglerMonitor(factor=3.0, window=8, min_history=3)
        return [m.record(i, dt) for i, dt in enumerate([1.0] * 5 + [10.0, 1.1])]

    assert _both(scenario) == [False] * 5 + [True, False]


# ---------------------------------------------------------------------------
# chaos injector determinism
# ---------------------------------------------------------------------------

def test_injector_decisions_hash_composition_not_call_order():
    probe = [("ndt6.bt1.nat1.t8", (0, 1)), ("ndt12.bt1.nat1.t8", (2,)),
             ("ndt6.bt1.nat1.t8", (3, 4, 5))]

    def outcomes(mod, order):
        inj = _FT[mod].DispatchFaultInjector(seed=3, transient_rate=0.5)
        out = []
        for tag, rids in order:
            try:
                inj.before_dispatch(tag, rids, attempt=0)
                out.append((tag, rids, None))
            except Exception as e:              # the package's InjectedDispatchError
                out.append((tag, rids, e.kind))
        return out

    fwd = _both(lambda mod: outcomes(mod, probe))
    rev = _both(lambda mod: outcomes(mod, list(reversed(probe))))
    assert sorted(fwd) == sorted(rev)             # order-independent draws


def test_injector_poison_and_transient_modes():
    inj = pft.DispatchFaultInjector(seed=0, transient_rate=1.0, transient_attempts=1,
                                    poison_rids=(7,))
    with pytest.raises(pft.InjectedDispatchError) as ei:
        inj.before_dispatch("t", (0, 1), attempt=0)
    assert ei.value.kind == "transient"
    inj.before_dispatch("t", (0, 1), attempt=1)   # transient clears
    for attempt in range(3):                      # poison never clears
        with pytest.raises(pft.InjectedDispatchError) as ei:
            inj.before_dispatch("t", (6, 7), attempt=attempt)
        assert ei.value.kind == "permanent"


def test_chaos_replay_is_bit_identical():
    def scenario(mod):
        clock = mod.SimClock()
        inj = _FT[mod].DispatchFaultInjector(seed=11, transient_rate=0.4,
                                             transient_attempts=1, poison_rids=(3,),
                                             straggler_rate=0.3, straggler_extra=2e-3)
        server = _server(mod, clock=clock, executor=ScriptedExecutor(mod), injector=inj,
                         max_retries=2, backoff_base=1e-4, max_batch=2, max_delay=1e-3)
        futs = [server.submit(_stub_matrix(mod, ndt=6 + 3 * (i % 2)),
                              deadline=clock.now + 5e-3) for i in range(8)]
        for _ in range(8):
            clock.advance(1e-3)
            server.pump()
        server.drain()
        return _outcome(server, futs), inj.injected

    assert _both(scenario) == scenario(PR)


# ---------------------------------------------------------------------------
# burst arrivals (data/synthetic.py)
# ---------------------------------------------------------------------------

def test_burst_mode_off_is_bit_compatible():
    base = request_stream(3, [(64, 6, 4)], 32, rate=500.0)
    assert base == request_stream(3, [(64, 6, 4)], 32, rate=500.0, burst_factor=1.0)


def test_burst_mode_is_seeded_and_compresses_arrivals():
    kw = dict(rate=500.0, burst_factor=8.0, burst_len=20e-3, normal_len=20e-3)
    a = request_stream(3, [(64, 6, 4)], 64, **kw)
    assert a == request_stream(3, [(64, 6, 4)], 64, **kw)    # seeded, replayable
    arr = [s["arrival"] for s in a]
    assert all(x < y for x, y in zip(arr, arr[1:]))
    base = request_stream(3, [(64, 6, 4)], 64, rate=500.0)
    assert arr[-1] < base[-1]["arrival"]          # bursts only accelerate
    strip = lambda specs: [{k: v for k, v in s.items() if k not in ("arrival", "deadline")}
                           for s in specs]
    assert strip(a) == strip(base)


# ---------------------------------------------------------------------------
# shutdown: no future left behind
# ---------------------------------------------------------------------------

class WedgedExecutor(ScriptedExecutor):
    """Dispatch parks until released — the stuck-device regression case."""

    def __init__(self):
        super().__init__(PR)
        self.entered = threading.Event()
        self.release = threading.Event()

    def dispatch(self, batch, now):
        self.entered.set()
        self.release.wait(60.0)
        raise RuntimeError("released")


def test_stop_resolves_all_futures_when_executor_wedges():
    ex = WedgedExecutor()
    server = RungServer(executor=ex, injector=None, max_batch=1, max_delay=1e-3,
                        poll_interval=1e-3, max_retries=0)
    server.start()
    try:
        futs = [server.submit(_stub_matrix(PR)) for _ in range(3)]
        assert ex.entered.wait(timeout=30.0)      # the pump is now wedged
        t0 = time.perf_counter()
        server.stop(timeout=0.2)                  # must not hang on drain
        assert time.perf_counter() - t0 < 30.0
        for f in futs:
            r = f.result(timeout=0)               # already resolved
            assert r.status == STATUS_SHED and r.detail == SHED_SHUTDOWN
        assert server._thread is None
    finally:
        ex.release.set()                          # let the parked pump thread end
    for t in threading.enumerate():
        if t.name == "rung-server-pump":
            t.join(timeout=30.0)
            assert not t.is_alive()


def test_stop_without_thread_is_noop():
    _server(PR).stop()                            # never started: fine


def test_env_var_arms_default_chaos_injector(monkeypatch):
    """REPRO_CHAOS_SEED arms a seeded injector on servers built with the
    default ``injector="auto"``, and the armed server conserves every
    future, as the reference's does on the same stream."""
    monkeypatch.setenv("REPRO_CHAOS_SEED", "23")

    def scenario(mod):
        clock = mod.SimClock()
        server = mod.RungServer(clock=clock, executor=ScriptedExecutor(mod),
                                max_batch=2, max_delay=1e-3, backoff_base=1e-6)
        assert server.executor.injector is not None
        assert server.executor.injector.seed == 23
        futs = [server.submit(_stub_matrix(mod)) for _ in range(6)]
        clock.advance(2e-3)
        server.pump()
        server.drain()
        for f in futs:
            assert f.done() and f.duplicate_resolves == 0
            assert f.result(timeout=0).status in (STATUS_OK, STATUS_RECOVERED)
        return _outcome(server, futs)

    _both(scenario)
    # explicit pins always win over the env var
    monkeypatch.setenv("REPRO_CHAOS_SEED", "99")
    assert _server(PR).executor.injector is None


def test_chaos_over_a_request_stream_matches_reference():
    """A seeded chaos schedule over a burst-mode stream through admission
    bounds and the degradation ladder: the port's history, events and
    outcomes equal the reference's."""
    stream = request_stream(5, [(64, 6, 4), (96, 12, 8)], 40, rate=2000.0,
                            deadline_budget=4e-3, burst_factor=6.0)

    def scenario(mod):
        clock = mod.SimClock()
        inj = _FT[mod].DispatchFaultInjector(seed=2, transient_rate=0.3, poison_rids=(7, 21),
                                             straggler_rate=0.2, straggler_extra=3e-3)
        server = _server(mod, clock=clock, executor=ScriptedExecutor(mod), injector=inj,
                         max_batch=3, max_delay=1e-3, max_queue=4, on_overload="shed",
                         degradation=mod.DegradationPolicy(step_dwell=0.0),
                         breaker_threshold=3, breaker_reset=5e-3, backoff_base=1e-4)
        futs = []
        for spec in stream:
            while True:
                nxt = server.next_flush_by()
                if nxt is None or nxt > spec["arrival"]:
                    break
                clock.advance_to(nxt)
                server.pump()
            clock.advance_to(spec["arrival"])
            ndt = 6 if spec["case"][0] == 64 else 12
            futs.append(server.submit(_stub_matrix(mod, ndt), deadline=spec["deadline"]))
            server.pump()
        server.drain()
        assert all(f.duplicate_resolves == 0 for f in futs)
        return _outcome(server, futs), server.scheduler.level

    (history, events, results), _ = _both(scenario)
    assert len(results) == len(stream) and history and events
