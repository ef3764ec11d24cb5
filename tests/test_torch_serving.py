"""The port's rung server (``repro_torch.launch.rung_server``) against the
JAX package's, on the CPU: the cases of ``tests/test_serving.py``, each run
through both servers on the same numpy-built arrivals (the reference's
t = 8 cases) on a ``SimClock``.

The scheduler's batches are held to the reference's signature for
signature; a served stream's ``history`` equal to the reference's, every
status, attempts and tau exactly, every ``x`` within rtol = atol = 1e-5
(float32 on both sides, different summation orders); the port's own
replay bit for bit; the telemetry it emits (counters, gauges, histogram
counts, spans and their parents) the reference's.  Port-only contracts:
``submit`` keeps the caller's objects and touches no device, a server
with no ``device=`` is the card's (and raises without one), ``finalize``
reads a batch's outcome to the host once, a result's ``x`` is a tensor and
its factor's ``FactorInfo`` holds 0-d tensors on the factor's device, and
``request_stream`` equals the reference's."""
import functools
import importlib
import threading
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as J
from repro.data import make_arrowhead as jmake_arrowhead
from repro.data import request_stream as jrequest_stream
from repro.launch import rung_server as JR
from repro.runtime import telemetry as jtelemetry
from repro_torch.core import (BandedCTSF, FactorInfo, GridBucketPolicy, SolverOptions,
                              TileGrid, factorize_window, solve_many)
from repro_torch.core import cholesky as _cholesky
from repro_torch.core.robustness import STATUS_FAILED, STATUS_OK, STATUS_RECOVERED
from repro_torch.data import make_arrowhead, request_stream
from repro_torch.launch import rung_server as PR
from repro_torch.launch.rung_server import (FLUSH_DEADLINE, FLUSH_DRAIN, FLUSH_FULL,
                                            RungScheduler, RungServer, SimClock)
from repro_torch.runtime import telemetry
from repro_torch.runtime.fault_tolerance import NumericalFaultInjector

# ``repro_torch.core`` re-exports the ``solve`` function, shadowing the
# module attribute: the module's private cache is reached through importlib
_solve = importlib.import_module("repro_torch.core.solve")

pytestmark = pytest.mark.serving

CASES = [(64, 6, 4), (96, 12, 8), (120, 16, 4)]
TOL = dict(rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _problem(n, bw, ar, seed=0, t=8, k=2):
    """(port matrix, port panel, reference matrix, numpy panel) from one
    numpy build, the panel in the padded layout, as the reference's test
    builds it."""
    A, st = make_arrowhead(n, bw, ar, rho=0.7, seed=seed)
    grid = TileGrid(st, t=t)
    m = BandedCTSF.from_sparse(A, grid, device="cpu")
    jA, jst = jmake_arrowhead(n, bw, ar, rho=0.7, seed=seed)
    jm = J.BandedCTSF.from_sparse(jA, J.TileGrid(jst, t=t))
    rng = np.random.default_rng(seed)
    b = np.zeros((grid.padded_n, k), np.float32)
    rows = np.array([grid.padded_index(i) for i in range(n)])
    b[rows] = rng.standard_normal((n, k)).astype(np.float32)
    return m, torch.from_numpy(b), jm, b


def _arrivals(num=6, k=2, gap=7e-4, deadline=None):
    """The reference test's mixed-grid arrival list, for both servers:
    ``(port arrivals, reference arrivals)``."""
    port, ref = [], []
    for i in range(num):
        n, bw, ar = CASES[i % len(CASES)]
        m, b, jm, jb = _problem(n, bw, ar, seed=i, k=k)
        dl = None if deadline is None else gap * (i + 1) + deadline
        port.append((gap * (i + 1), m, b, dl))
        ref.append((gap * (i + 1), jm, jb, dl))
    return port, ref


def _serve(mod, arrivals, **kw):
    clock = mod.SimClock()
    kw.setdefault("max_batch", 3)
    kw.setdefault("max_delay", 3e-3)
    if mod is PR:
        kw.setdefault("device", "cpu")
    server = mod.RungServer(clock=clock, **kw)
    futures = mod.replay(server, clock, arrivals)
    return server, [f.result(timeout=0) for f in futures]


@functools.lru_cache(maxsize=None)
def _reference_run(num=6):
    """The reference server on the reference test's arrivals (its compiles
    are the expensive part, so one run serves every test)."""
    return _serve(JR, _arrivals(num)[1])


def _same_result(got, want, x=True):
    assert (got.rid, got.status, got.attempts, got.flush_reason, got.batch_size, got.rung,
            got.detail) == (want.rid, want.status, want.attempts, want.flush_reason,
                            want.batch_size, want.rung, want.detail)
    # tau exactly: NaN where the ladder's last rung was NaN (a FAILED element)
    assert got.tau == want.tau or (np.isnan(got.tau) and np.isnan(want.tau))
    assert got.latency == want.latency
    if x:
        assert torch.is_tensor(got.x)
        np.testing.assert_allclose(got.x.numpy(), want.x, **TOL)


def _fake_request(mod, rid, grid, k=None, deadline=None):
    """Scheduler-only request: a stand-in matrix carrying just a grid."""
    rhs = None if k is None else np.zeros((1, k), np.float32)
    return mod.RungRequest(rid=rid, matrix=types.SimpleNamespace(grid=grid),
                           rhs=rhs, deadline=deadline)


def _grids(ndt=6, bt=1, nat=1, t=8):
    return (TileGrid.from_tile_counts(t, ndt, bt, nat),
            J.TileGrid.from_tile_counts(t, ndt, bt, nat))


def _both(plan):
    """Run ``plan(mod, grid_of)`` on both packages' schedulers; returns the
    port's batches after checking their signatures equal the reference's."""
    port = plan(PR, lambda **kw: _grids(**kw)[0])
    ref = plan(JR, lambda **kw: _grids(**kw)[1])
    assert [b.signature() for b in port] == [b.signature() for b in ref]
    return port


# ---------------------------------------------------------------------------
# scheduler state machine (pure, no arrays, no device)
# ---------------------------------------------------------------------------

def test_batch_full_flush_path():
    def plan(mod, grid_of):
        s = mod.RungScheduler(max_batch=3, max_delay=1.0)
        g = grid_of()
        out = s.tick(0.0, [_fake_request(mod, i, g) for i in range(7)])
        assert s.pending == 1 and s.tick(0.5) == []
        out += s.tick(1.0)
        assert s.pending == 0
        return out

    batches = _both(plan)
    assert [b.reason for b in batches] == [FLUSH_FULL, FLUSH_FULL, FLUSH_DEADLINE]
    assert [tuple(r.rid for r in b.requests) for b in batches] == [(0, 1, 2), (3, 4, 5), (6,)]


def test_deadline_flush_takes_min_of_delay_and_request_deadline():
    def plan(mod, grid_of):
        s = mod.RungScheduler(max_batch=8, max_delay=10.0)
        g = grid_of()
        s.submit(0.0, _fake_request(mod, 0, g, deadline=2.0))
        s.submit(1.0, _fake_request(mod, 1, g))
        assert s.next_flush_by() == 2.0
        assert s.tick(1.9) == []
        return s.tick(2.0)

    (b,) = _both(plan)
    assert b.reason == FLUSH_DEADLINE and tuple(r.rid for r in b.requests) == (0, 1)


def test_drain_flush_path():
    def plan(mod, grid_of):
        s = mod.RungScheduler(max_batch=8, max_delay=10.0)
        ga, gb = grid_of(ndt=6), grid_of(ndt=12)
        s.tick(0.0, [_fake_request(mod, 0, ga), _fake_request(mod, 1, gb),
                     _fake_request(mod, 2, ga)])
        out = s.drain(0.1)
        assert s.pending == 0 and s.next_flush_by() is None
        return out

    batches = _both(plan)
    assert [b.reason for b in batches] == [FLUSH_DRAIN, FLUSH_DRAIN]
    assert {tuple(r.rid for r in b.requests) for b in batches} == {(0, 2), (1,)}


def test_drain_classifies_due_flushes_as_deadline_first():
    def plan(mod, grid_of):
        s = mod.RungScheduler(max_batch=8, max_delay=1.0)
        s.submit(0.0, _fake_request(mod, 0, grid_of()))
        return s.drain(5.0)

    (b,) = _both(plan)
    assert b.reason == FLUSH_DEADLINE


def test_rung_keys_match_policy_canonicalize():
    policy, jpolicy = GridBucketPolicy(), J.GridBucketPolicy()
    s = RungScheduler(policy=policy, max_batch=8)
    js = JR.RungScheduler(policy=jpolicy, max_batch=8)
    for i, (n, bw, ar) in enumerate(CASES):
        m, _, jm, _ = _problem(n, bw, ar)
        key = s.submit(0.0, _fake_request(PR, i, m.grid, k=3))
        jkey = js.submit(0.0, _fake_request(JR, i, jm.grid, k=3))
        assert key == (policy.canonicalize(m.grid), 3)
        assert telemetry.rung_tag(key[0]) == jtelemetry.rung_tag(jkey[0])
    # the same canonical grid with another panel width is another rung
    assert s.submit(0.0, _fake_request(PR, 9, _problem(*CASES[0])[0].grid, k=5))[1] == 5


# ---------------------------------------------------------------------------
# end-to-end replay (SimClock, synchronous pump)
# ---------------------------------------------------------------------------

def test_replay_bit_identical_and_history_stable():
    server1, res1 = _serve(PR, _arrivals()[0])
    server2, res2 = _serve(PR, _arrivals()[0])
    jserver, _ = _reference_run()
    assert server1.history == server2.history == jserver.history
    assert len(server1.history) >= 2             # actually batched
    for a, b in zip(res1, res2):
        assert a.rid == b.rid and a.flush_reason == b.flush_reason
        assert torch.equal(a.x, b.x)             # bit-identical, not close


def test_replay_matches_reference_and_sequential_oracle():
    arrivals = _arrivals()[0]
    _, results = _serve(PR, arrivals)
    _, jresults = _reference_run()
    for (arrival, m, b, _dl), r, jr in zip(arrivals, results, jresults):
        _same_result(r, jr)
        assert r.status == 0 and r.attempts == 1
        f = factorize_window(m, options=SolverOptions(regularize=True))
        x_oracle = solve_many(f, b)
        assert (r.x - x_oracle).abs().max() < 2e-5
        # the per-request factor solves in the request's own layout too
        assert (solve_many(r.factor, b) - x_oracle).abs().max() < 2e-5
        # its outcome: 0-d tensors on the factor's device, as the batch's
        info = r.factor.info
        for field in ("status", "attempts", "tau", "min_pivot", "first_bad_tile"):
            v = getattr(info, field)
            assert torch.is_tensor(v) and v.dim() == 0 and v.device == r.x.device
        assert int(info.status) == r.status and float(info.tau) == r.tau


def test_compile_count_stays_at_rungs_not_grids():
    arrivals = _arrivals(num=9)[0]              # 3 distinct source grids
    policy = GridBucketPolicy()
    rungs = {telemetry.rung_tag(policy.canonicalize(m.grid)) for _, m, _, _ in arrivals}
    fac0 = set(_cholesky._BATCHED_WINDOW_CACHE.keys())
    sol0 = set(_solve._BATCHED_SOLVE_CACHE.keys())
    _serve(PR, arrivals)
    assert len(set(_cholesky._BATCHED_WINDOW_CACHE.keys()) - fac0) <= len(rungs)
    assert len(set(_solve._BATCHED_SOLVE_CACHE.keys()) - sol0) <= len(rungs)


def test_deadline_budget_respected_under_replay():
    port, ref = _arrivals(num=5, deadline=1e-3)
    with telemetry.capture() as reg:
        reg.reset()
        server, results = _serve(PR, port, max_batch=50, max_delay=5.0)
        wait = reg.hist_summary("serving.queue_wait")
        reg.reset()
    jserver, jresults = _serve(JR, ref, max_batch=50, max_delay=5.0)
    assert server.history == jserver.history
    for r, jr in zip(results, jresults):
        _same_result(r, jr)
    assert {r.flush_reason for r in results} == {FLUSH_DEADLINE}
    assert wait["count"] == len(results)
    assert wait["max"] <= 1e-3 + 1e-12


def _telemetry_of(mod, tel, arrivals):
    with tel.capture() as reg:
        reg.reset()
        server, results = _serve(mod, arrivals)
        snap = reg.snapshot()
        reg.reset()
    names = {s["id"]: s["name"] for s in snap["spans"]}
    spans = sorted((s["name"], names.get(s["parent"]),
                    tuple(sorted((k, str(v)) for k, v in s["tags"].items())))
                   for s in snap["spans"])
    return server, results, snap, spans


def test_serving_telemetry_counters_and_spans():
    port, ref = _arrivals()
    server, results, snap, spans = _telemetry_of(PR, telemetry, port)
    _, _, jsnap, jspans = _telemetry_of(JR, jtelemetry, ref)
    c = snap["counters"]
    assert c["serving.requests"] == len(results)
    assert sum(v for k, v in c.items() if k.startswith("serving.completed")) == len(results)
    assert sum(v for k, v in c.items() if k.startswith("serving.flush")) == len(server.history)
    lat = telemetry.hist_summary("serving.request_seconds")
    assert lat is None or lat["count"] == 0          # reset after the snapshot
    assert snap["histograms"]["serving.request_seconds"]["count"] == len(results)
    assert {"serving.dispatch", "serving.finalize"} <= {s[0] for s in spans}
    # what the reference emits for the same stream, name for name
    assert c == jsnap["counters"]
    assert snap["gauges"] == jsnap["gauges"]
    assert ({k: h["count"] for k, h in snap["histograms"].items()}
            == {k: h["count"] for k, h in jsnap["histograms"].items()})
    assert spans == jspans


def test_fault_injection_under_serving():
    """Corrupted requests degrade to flagged futures; clean requests in the
    same rung batches stay bit-identical to an uncontaminated run.  The
    corrupted matrices are made once (by the port's injector) and carried
    into the reference, so both servers see the same bits."""
    clean, _ = _arrivals(num=6)
    bad = list(clean)
    inj = NumericalFaultInjector(seed=5)
    # rids 0 and 3 share the CASES[0] rung; corrupt 3 (nan -> FAILED)
    # and 4 (indefinite -> RECOVERED), leaving their batch siblings clean
    bad[3] = (bad[3][0], inj.corrupt_one(bad[3][1], "nan"), bad[3][2], bad[3][3])
    bad[4] = (bad[4][0], inj.corrupt_one(bad[4][1], "indefinite"), bad[4][2], bad[4][3])
    _, jclean = _arrivals(num=6)
    jbad = list(jclean)
    for i in (3, 4):
        jm = jclean[i][1]
        jbad[i] = (jbad[i][0], J.BandedCTSF(jm.grid, *(jnp.asarray(x.numpy())
                                                       for x in bad[i][1].arrays())),
                   jbad[i][2], jbad[i][3])
    server_c, res_c = _serve(PR, clean)
    server_b, res_b = _serve(PR, bad)
    jserver_b, jres_b = _serve(JR, jbad)
    assert server_c.history == server_b.history == jserver_b.history
    assert res_b[3].status == STATUS_FAILED and not res_b[3].ok()
    assert res_b[4].status == STATUS_RECOVERED and res_b[4].ok()
    assert res_b[4].tau > 0 and res_b[4].attempts > 1
    for i in (0, 1, 2, 5):
        assert res_b[i].status == STATUS_OK
        assert torch.equal(res_b[i].x, res_c[i].x)
    # every outcome the reference's; rid 4's batch holds no FAILED element,
    # so the reference refines it too (ROADMAP C) and its x compares
    for i in range(6):
        _same_result(res_b[i], jres_b[i], x=i != 3)
    assert torch.isfinite(res_b[4].x).all()
    assert res_b[4].factor.info.matrix is not None  # the original kept


def test_factorize_only_requests():
    n, bw, ar = CASES[0]
    m, _, jm, _ = _problem(n, bw, ar, seed=11)
    outs = []
    for mod, mat in ((PR, m), (JR, jm)):
        clock = mod.SimClock()
        server = (mod.RungServer(clock=clock, max_batch=4, max_delay=1e-3, device="cpu")
                  if mod is PR else mod.RungServer(clock=clock, max_batch=4, max_delay=1e-3))
        fut = server.submit(mat, rhs=None)
        clock.advance(1e-3)
        server.pump()
        server.drain()
        outs.append(fut.result(timeout=0))
    r, jr = outs
    assert r.x is None and r.status == 0
    _same_result(r, jr, x=False)
    f_oracle = factorize_window(m, options=SolverOptions(regularize=True))
    np.testing.assert_allclose(r.factor.restrict().ctsf.Dr.numpy(), f_oracle.ctsf.Dr.numpy(),
                               atol=2e-5)
    np.testing.assert_allclose(r.factor.restrict().ctsf.Dr.numpy(),
                               np.asarray(jr.factor.restrict().ctsf.Dr), **TOL)


def test_submit_validates_rhs_shape():
    m = _problem(*CASES[0])[0]
    server = RungServer(clock=SimClock(), device="cpu")
    with pytest.raises(ValueError, match="padded_n"):
        server.submit(m, rhs=np.zeros((3, 2), np.float32))
    with pytest.raises(ValueError, match="padded_n"):
        server.submit(m, rhs=torch.zeros(m.grid.padded_n))


def test_submit_keeps_the_callers_objects():
    """``submit`` copies nothing: the request holds the caller's matrix and
    panel (a tensor or a host array), and off the card records no event."""
    m, b, _, jb = _problem(*CASES[0])
    server = RungServer(clock=SimClock(), device="cpu", max_delay=10.0)
    server.submit(m, b)
    server.submit(m, jb)
    reqs = [r for q in server.scheduler._queues.values() for r in q.pop()]
    assert reqs[0].matrix is m and reqs[0].rhs is b and reqs[1].rhs is jb
    assert all(r.ready is None for r in reqs)


def test_host_panels_reach_the_device_at_dispatch():
    """A numpy panel gives what a tensor panel gives."""
    port, _ = _arrivals(num=3)
    host = [(a, m, b.numpy(), dl) for a, m, b, dl in port]
    _, res_t = _serve(PR, port)
    _, res_h = _serve(PR, host)
    for a, b in zip(res_t, res_h):
        assert torch.equal(a.x, b.x)


def test_server_without_device_is_the_cards():
    if torch.cuda.is_available():
        assert RungServer(clock=SimClock()).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            RungServer(clock=SimClock())
        with pytest.raises(RuntimeError, match="CUDA"):
            PR.RungExecutor()
    assert RungServer(clock=SimClock(), device="cpu").executor.inner.stream is None


def test_finalize_reads_each_batch_outcome_once(monkeypatch):
    """The executor reads a batch's five outcome fields to the host in one
    read (``FactorInfo.elements``), never element by element."""
    calls = []
    monkeypatch.setattr(FactorInfo, "element", lambda self, i: pytest.fail("element()"))
    orig = FactorInfo.elements
    monkeypatch.setattr(FactorInfo, "elements",
                        lambda self: calls.append(self.status.shape) or orig(self))
    server, results = _serve(PR, _arrivals()[0])
    assert len(calls) == len(server.history)
    assert all(r.status == STATUS_OK for r in results)


@pytest.mark.parametrize("batch", [None, 1, 4])
def test_factor_info_elements_is_one_host_read(monkeypatch, batch):
    shape = () if batch is None else (batch,)
    g = torch.Generator().manual_seed(batch or 0)
    info = FactorInfo(status=torch.randint(0, 3, shape, dtype=torch.int32, generator=g),
                      attempts=torch.randint(1, 5, shape, dtype=torch.int32, generator=g),
                      tau=torch.rand(shape, generator=g),
                      min_pivot=torch.where(torch.rand(shape, generator=g) > 0.5,
                                            torch.rand(shape, generator=g),
                                            torch.tensor(float("inf"))),
                      first_bad_tile=torch.randint(-1, 9, shape, dtype=torch.int32,
                                                   generator=g))
    want = [info.element(i) for i in range(batch or 1)]
    reads = []
    orig = torch.Tensor.cpu
    monkeypatch.setattr(torch.Tensor, "cpu", lambda self, *a, **k: reads.append(1) or
                        orig(self, *a, **k))
    got = info.elements()
    assert got == want and len(reads) == 1
    for e in got:
        assert [type(e[k]) for k in ("status", "attempts", "tau", "min_pivot",
                                     "first_bad_tile")] == [int, int, float, float, int]


@pytest.mark.parametrize("seed", [0, 3, 7, 11])
@pytest.mark.parametrize("burst", [None, dict(burst_factor=8.0, burst_len=20e-3,
                                              normal_len=20e-3)])
def test_request_stream_equals_reference(seed, burst):
    kw = dict(rate=500.0, k=3, deadline_budget=2e-3, **(burst or {}))
    cases = [(64, 6, 4), (96, 12, 8), (120, 16, 4)]
    assert request_stream(seed, cases, 40, **kw) == jrequest_stream(seed, cases, 40, **kw)


def test_build_arrivals_matches_reference():
    stream = request_stream(3, [(64, 6, 4), (96, 12, 8)], 4, k=2)
    port = PR._build_arrivals(stream, device="cpu")
    ref = JR._build_arrivals(stream)
    for (a, m, b, dl), (ja, jm, jb, jdl) in zip(port, ref):
        assert (a, dl) == (ja, jdl)
        assert telemetry.rung_tag(m.grid) == jtelemetry.rung_tag(jm.grid)
        for x, y in zip(m.arrays(), jm.arrays()):
            np.testing.assert_array_equal(x.numpy(), np.asarray(y))
        np.testing.assert_array_equal(b.numpy(), np.asarray(jb))


def test_command_line_on_the_cpu(capsys):
    PR.main(["--device", "cpu", "--requests", "6", "--k", "2"])
    out = capsys.readouterr().out
    assert "served 6 requests on cpu" in out and "statuses: {0: 6}" in out


def test_threaded_server_end_to_end_smoke():
    """Production shape: background pump on the real clock, futures
    resolving across threads; every wait has a timeout, so a hang fails."""
    arrivals = _arrivals(num=6)[0]
    server = RungServer(max_batch=3, max_delay=0.05, device="cpu")
    server.start()
    try:
        futures = [server.submit(m, b) for _, m, b, _ in arrivals]
        results = [f.result(timeout=60.0) for f in futures]
    finally:
        server.stop(timeout=60.0)
    for (_, m, b, _), r in zip(arrivals, results):
        assert r.status == 0
        f = factorize_window(m, options=SolverOptions(regularize=True))
        assert (r.x - solve_many(f, b)).abs().max() < 2e-5
    assert server._thread is None and not server._outstanding
    assert all(t.name != "rung-server-pump" for t in threading.enumerate())


# ---------------------------------------------------------------------------
# the capture sites: errors confined to the capturing thread
# ---------------------------------------------------------------------------

class _Recorder:
    """Stands in for ``torch.cuda.graph``: records its arguments, runs the
    body."""

    def __init__(self):
        self.calls = []

    def __call__(self, graph, **kwargs):
        import contextlib
        self.calls.append(kwargs)
        return contextlib.nullcontext()


def test_capture_sites_confine_capture_errors_to_their_thread(monkeypatch):
    """Both capture sites (the solves' corner and the task list) capture
    with ``capture_error_mode="thread_local"``, so a client thread's
    allocation or pageable copy neither fails nor invalidates the pump's
    capture; on the card ``test_torch_gpu.py`` captures beside such threads."""
    from repro_torch.core import TileMatrix
    rec = _Recorder()
    monkeypatch.setattr(torch.cuda, "graph", rec)
    monkeypatch.setattr(torch.cuda, "CUDAGraph", lambda: object())
    _cholesky.capture(object())
    C = torch.eye(8).expand(1, 1, 8, 8).contiguous()
    panel = torch.ones(1, 8, 2)
    _solve._capture_corner(lambda c, p, impl: p.clone(), C, (panel,))
    # the task list's site, its stream handling and kernels stood in for
    stream = types.SimpleNamespace(wait_stream=lambda other: None)
    monkeypatch.setattr(torch.cuda, "Stream", lambda: stream)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda: stream)
    monkeypatch.setattr(torch.cuda, "stream", lambda s: __import__("contextlib").nullcontext())
    monkeypatch.setattr(_cholesky, "_warm_up", lambda *a: None)
    monkeypatch.setattr(_cholesky, "_run_tasklist", lambda tiles, *a: tiles)
    A, st = make_arrowhead(64, 6, 4, rho=0.7, seed=0)
    _cholesky._capture_tasklist(TileMatrix.from_sparse(A, TileGrid(st, t=8), device="cpu"), 0)
    assert rec.calls == [dict(capture_error_mode="thread_local")] * 3
