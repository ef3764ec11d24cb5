"""The port's ``runtime/telemetry.py`` against the JAX package's, case for
case with ``tests/test_telemetry.py`` where the case is not JAX-specific:
registry units (counters, labels, nearest-rank quantiles, the sample cap,
span nesting and late tags, a thread hammer, reset), tensors refused (the
twin of a tracer failing loudly), disabled mode records nothing and costs
under 5 % of a cached ``solve_many`` on the plain backend, ``capture``,
launch reports (one plain call a fused sweep on the CPU), ``sweep_cost``
equal to the reference's exactly, the exporters' round trips, the named
and anonymous ``LRUCache``s; and the hooks of the ported core: the
mixed-grid run's counters (with their values), histograms and spans and
the jitter ladder's counters, equal to the reference's run on the same
inputs (the port's own sub-spans, ``tests/_torch_spans.py``, left out of
the comparison and checked on their own: their tree a call, no device
time on the CPU, none of them and no ``record_function`` while disabled),
the clock epoch against the wall clock, the launch counter of
``kernels/_build.py`` on a stand-in wrapper and a graph replay's
``kernel.launches``."""
import json
import re
import threading
import time
from collections import Counter

import jax
import numpy as np
import pytest
import torch

import repro.core as J
from repro.core import cholesky as jcholesky
from repro.core import selinv as jselinv
from repro.core.batching import LRUCache as JLRUCache
from repro.runtime import telemetry as jtelemetry
from repro_torch.core import (ArrowheadStructure, BandedCTSF, GridBucketPolicy, SolverOptions,
                              TileGrid, factorize_window, factorize_window_batched,
                              selinv_batched, solve_many, solve_many_batched)
from repro_torch.core import cholesky as tcholesky
from repro_torch.core import selinv as tselinv
from repro_torch.core.batching import LRUCache
from repro_torch.core.cholesky import GraphCache
from repro_torch.data import make_arrowhead
from repro_torch.kernels import _build, ops
from repro_torch.kernels.ring import band_row_to_col
from repro_torch.runtime import telemetry
from repro_torch.runtime.telemetry import (Telemetry, count_launches, kernel_report,
                                           sweep_cost)
from _torch_spans import PORT_SPANS, reference_view, tree

JREF = J.SolverOptions(impl="ref")


@pytest.fixture(autouse=True)
def _clean_registries():
    """Every test starts from (and leaves behind) disabled, empty default
    registries in both packages: telemetry is process-global state."""
    for t in (telemetry, jtelemetry):
        t.disable()
        t.reset()
    yield
    for t in (telemetry, jtelemetry):
        t.disable()
        t.reset()


def _pair(n=96, bw=8, ar=4, t=8, seed=0, rho=0.6):
    A, st = make_arrowhead(n, bw, ar, rho=rho, seed=seed)
    jgrid = J.TileGrid(J.ArrowheadStructure(n=st.n, bandwidth=st.bandwidth, arrow=st.arrow), t)
    return BandedCTSF.from_sparse(A, TileGrid(st, t), device="cpu"), J.BandedCTSF.from_sparse(
        A, jgrid)


# ---------------------------------------------------------------------------
# Registry units
# ---------------------------------------------------------------------------

def test_counters_gauges_and_labels():
    reg = Telemetry(enabled=True)
    reg.inc("a")
    reg.inc("a", 2.5)
    reg.inc("a", 1, tag="x")
    reg.gauge("g", 7.0)
    reg.gauge("g", 3.0)            # last write wins
    snap = reg.snapshot()
    assert snap["counters"]["a"] == 3.5
    assert snap["counters"]["a{tag=x}"] == 1.0
    assert snap["gauges"]["g"] == 3.0


def test_histogram_quantiles_nearest_rank():
    reg = Telemetry(enabled=True)
    for v in range(1, 101):
        reg.observe("h", float(v))
    s = reg.snapshot()["histograms"]["h"]
    assert s["count"] == 100 and s["sum"] == 5050.0
    assert s["min"] == 1.0 and s["max"] == 100.0
    assert (s["p50"], s["p90"], s["p99"]) == (50.0, 90.0, 99.0)


def test_histogram_sample_cap_keeps_exact_count():
    reg = Telemetry(enabled=True, max_samples=16)
    for v in range(100):
        reg.observe("h", float(v))
    s = reg.snapshot()["histograms"]["h"]
    assert s["count"] == 100 and s["max"] == 99.0
    assert s["samples_dropped"] == 100 - 16


def test_span_nesting_parents_and_timing():
    reg = Telemetry(enabled=True)
    with reg.span("outer", who="t"):
        with reg.span("mid"):
            with reg.span("leaf"):
                time.sleep(0.002)
    spans = {s["name"]: s for s in reg.snapshot()["spans"]}
    assert spans["leaf"]["parent"] == spans["mid"]["id"]
    assert spans["mid"]["parent"] == spans["outer"]["id"]
    assert spans["outer"]["parent"] is None
    assert spans["outer"]["tags"] == {"who": "t"}
    assert spans["outer"]["dur_us"] >= spans["mid"]["dur_us"] \
        >= spans["leaf"]["dur_us"] >= 1500


def test_span_tag_after_open():
    reg = Telemetry(enabled=True)
    with reg.span("s") as sp:
        sp.tag(rung="r1", k=4)
    (rec,) = reg.snapshot()["spans"]
    assert rec["tags"] == {"rung": "r1", "k": 4}


def test_counter_thread_hammer():
    reg = Telemetry(enabled=True)
    threads, per = 8, 2000

    def work(i):
        for _ in range(per):
            reg.inc("hammer")
            reg.observe("lat", float(i))
            with reg.span("w"):
                pass

    ts = [threading.Thread(target=work, args=(i,)) for i in range(threads)]
    [t.start() for t in ts]
    [t.join(timeout=60) for t in ts]
    assert not any(t.is_alive() for t in ts)
    snap = reg.snapshot()
    assert snap["counters"]["hammer"] == threads * per
    assert snap["histograms"]["lat"]["count"] == threads * per
    assert len(snap["spans"]) == threads * per
    assert all(s["parent"] is None for s in snap["spans"])


def test_reset_clears_everything():
    reg = Telemetry(enabled=True)
    reg.inc("a")
    with reg.span("s"):
        pass
    reg.reset()
    snap = reg.snapshot()
    assert snap["counters"] == {} and snap["spans"] == []
    assert reg.enabled()               # reset does not flip the flag


@pytest.mark.parametrize("record", ["inc", "gauge", "observe"])
def test_tensor_recording_is_refused(record):
    """The twin of the reference's tracer failing loudly: a tensor would be
    a hidden device sync on the card, so it raises at the call site;
    numbers, numpy scalars included, are taken."""
    reg = Telemetry(enabled=True)
    with pytest.raises(TypeError, match="torch.Tensor"):
        getattr(reg, record)("bad", torch.tensor(1.0))
    getattr(reg, record)("good", np.float32(2.0))
    telemetry.enable()
    with pytest.raises(TypeError, match="torch.Tensor"):
        getattr(telemetry, record)("bad", torch.ones(()))


# ---------------------------------------------------------------------------
# Disabled mode: no-op behaviour + overhead guard
# ---------------------------------------------------------------------------

def test_disabled_mode_records_nothing():
    assert not telemetry.enabled()
    telemetry.inc("c")
    telemetry.observe("h", 1.0)
    telemetry.gauge("g", 1.0)
    with telemetry.span("s", k=1) as sp:
        sp.tag(more="tags")
    snap = telemetry.snapshot()
    assert snap["counters"] == {} and snap["gauges"] == {}
    assert snap["histograms"] == {} and snap["spans"] == []


def test_capture_restores_previous_state():
    assert not telemetry.enabled()
    with telemetry.capture() as reg:
        assert telemetry.enabled()
        reg.inc("inside")
    assert not telemetry.enabled()
    assert telemetry.snapshot()["counters"]["inside"] == 1.0


def _request_surface(grid):
    """The reference's surface of one request: a span with a late tag, a
    counter and a histogram."""
    with telemetry.span("solve.solve_many", k=4) as sp:
        sp.tag(grid=telemetry.rung_tag(grid))
    telemetry.inc("cache.hit", cache="batched_window")
    telemetry.observe("lat", 1.0)


def _solve_sub_spans(grid):
    """The port's sub-spans of one batched solve, the device-timed ones
    with ``device=True``."""
    with telemetry.span("solve.prepare"):
        pass
    for name in ("solve.forward", "solve.corner", "solve.backward"):
        with telemetry.span(name, device=True):
            pass
    with telemetry.span("solve.assemble"):
        pass


@_build.counted(lambda x: {"t": 8, "n": 1})
def _standin_cuda(x):
    """A stand-in kernel wrapper: one checked launch of nothing."""
    _build.check(None, 0, "_standin")
    return x


def _solve_launches(grid):
    """The launch counter around the launches of one solve on the card:
    two band sweeps and 2 nat ``solve_panel``."""
    for _ in range(2 + 2 * grid.n_arrow_tiles):
        _standin_cuda(None)


@pytest.mark.parametrize("surface", [_request_surface, _solve_sub_spans, _solve_launches],
                         ids=["request", "sub_spans", "launches"])
def test_disabled_overhead_on_cached_solve_many_under_5pct(surface):
    """The reference's gate, on each part of what one request crosses while
    telemetry is off (the reference's surface, the port's sub-spans of a
    solve, the launch counter around its launches): the disabled cost,
    times 3, under 5 % of one cached ``solve_many`` call (here the plain
    backend's on the CPU; on the card ``chip_smoke.py``)."""
    m, _ = _pair()
    f = factorize_window(m)
    B = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (m.grid.padded_n, 4)).astype(np.float32))
    solve_many(f, B)
    times = []
    for _ in range(30):
        t0 = time.perf_counter()
        solve_many(f, B)
        times.append(time.perf_counter() - t0)
    dispatch = float(np.median(times))
    assert not telemetry.enabled()
    n = 5000
    t0 = time.perf_counter()
    for _ in range(n):
        surface(m.grid)
    per_request = (time.perf_counter() - t0) / n
    assert 3 * per_request < 0.05 * dispatch, (
        f"disabled telemetry {per_request * 1e6:.2f}us/request vs call {dispatch * 1e6:.1f}us")
    assert telemetry.snapshot()["spans"] == [] and telemetry.snapshot()["counters"] == {}


def test_span_epoch_on_the_wall_clock():
    """A span's ``epoch_unix_ns + ts_us`` is its start on the wall clock,
    within the wall-clock readings taken around it, before and after a
    reset (a new epoch); the Chrome trace's ``ts`` is the same instant in
    microseconds."""
    reg = Telemetry(enabled=True)
    for _ in range(2):
        w0 = time.time_ns()
        with reg.span("s"):
            pass
        w1 = time.time_ns()
        snap = reg.snapshot()
        (rec,) = snap["spans"]
        start = snap["epoch_unix_ns"] + rec["ts_us"] * 1e3
        # the epoch reads the two clocks one after the other: a microsecond
        assert w0 - 1e3 <= start <= w1 + 1e3
        (ev,) = reg.to_chrome_trace()["traceEvents"]
        assert ev["ts"] == pytest.approx(start / 1e3, abs=1.0)
        assert "dev_us" not in rec and "dev_us" not in ev["args"]
        time.sleep(0.01)
        reg.reset()


def _entry_points(m, B):
    """A θ step's entry points on a batch of two: the factorization and
    its log-determinant, the batched solve, the batched selected inverse
    and its diagonal."""
    f = factorize_window_batched([m, m])
    f.logdet()
    solve_many_batched(f, B)
    selinv_batched(f).diagonal()


def _batch_panels(m, k=1):
    return torch.from_numpy(np.random.default_rng(0).standard_normal(
        (2, m.grid.padded_n, k)).astype(np.float32))


def test_entry_point_sub_spans():
    """Each entry point's sub-spans on one small batch, under the names the
    benchmark reads, each a child of its entry point's span (the
    log-determinant's and the diagonal's their own); no device time on the
    CPU; every span named to a running profiler."""
    m, _ = _pair()
    B = _batch_panels(m)
    telemetry.enable()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        _entry_points(m, B)
    snap = telemetry.snapshot()
    fwb, smb, sb = "factorize.window_batched", "solve.solve_many_batched", "selinv.batched"
    assert tree(snap) == sorted([
        (fwb, None), ("factorize.prepare", fwb), ("factorize.sweep", fwb),
        ("factorize.corner", fwb), ("factorize.logdet", None),
        (smb, None), ("solve.prepare", smb), ("solve.forward", smb), ("solve.corner", smb),
        ("solve.backward", smb), ("solve.assemble", smb),
        (sb, None), ("selinv.prepare", sb), ("selinv.seed", sb), ("selinv.sweep", sb),
        ("selinv.diagonal", None)])
    assert {n for n, parent in tree(snap) if n not in (fwb, smb, sb)} <= PORT_SPANS
    assert not any("dev_us" in s for s in snap["spans"])
    assert all(s["tags"] == {} for s in snap["spans"] if s["name"] in PORT_SPANS)
    assert {n for n, _ in tree(snap)} <= {e.name for e in prof.events()}


def test_disabled_entry_points_record_nothing():
    """With telemetry off the entry points open no span and no
    ``record_function`` (a running profiler sees none of their names) and
    count nothing."""
    m, _ = _pair()
    B = _batch_panels(m)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        _entry_points(m, B)
    assert not [e.name for e in prof.events()
                if e.name.split(".")[0] in ("factorize", "solve", "selinv", "stiles")]
    snap = telemetry.snapshot()
    assert snap["spans"] == [] and snap["counters"] == {} and snap["histograms"] == {}


def test_launch_counter_on_a_stand_in_wrapper():
    """``kernels/_build.py::counted``: ``launches`` counts the calls that
    reached ``check`` (an empty call launches nothing), whatever the
    telemetry; while on, each launch is one ``kernel.launches`` with its
    labels; a recording (a capture's) keeps its block's launches in place
    of telemetry."""
    @_build.counted(lambda x, n: {"t": 8, "n": n})
    def fake_cuda(x, n):
        if n:
            _build.check(None, 0, "fake")
        return x

    assert fake_cuda(7, 3) == 7 and fake_cuda(7, 0) == 7
    assert (fake_cuda.launches, fake_cuda.__name__) == (1, "fake_cuda")
    assert telemetry.snapshot()["counters"] == {}
    telemetry.enable()
    for n in (3, 0, 2, 3):
        fake_cuda(None, n)
    want = {"kernel.launches{kernel=fake,n=2,t=8}": 1.0,
            "kernel.launches{kernel=fake,n=3,t=8}": 2.0}
    assert telemetry.snapshot()["counters"] == want and fake_cuda.launches == 4
    with _build.recording() as log:
        fake_cuda(None, 3)
        fake_cuda(None, 3)
        fake_cuda(None, 0)
    assert log == Counter({("fake_cuda", (("kernel", "fake"), ("n", 3), ("t", 8))): 2})
    assert _build.by_wrapper(log) == Counter(fake_cuda=2)
    assert telemetry.snapshot()["counters"] == want and fake_cuda.launches == 6


def test_graph_replay_counts_its_launches():
    """A graph cache's replay counts the launches its capture recorded,
    labelled, in ``kernel.launches`` while telemetry is on and nothing
    while off, beside the cache's own ``replayed``."""
    class Graph:
        def replay(self):
            pass

    class Entry:
        graph = Graph()
        labelled = Counter({("solve_panel_cuda", (("k", 1), ("kernel", "solve_panel"),
                                                  ("n", 8), ("t", 64))): 4})
        launches = _build.by_wrapper(labelled)

    cache = GraphCache(2)
    entry = cache.add("k", Entry())
    cache.replay(entry)
    assert telemetry.snapshot()["counters"] == {}
    telemetry.enable()
    cache.replay(entry)
    cache.replay(entry)
    assert telemetry.snapshot()["counters"] == {
        "kernel.launches{k=1,kernel=solve_panel,n=8,t=64}": 8.0}
    assert cache.replayed == Counter(solve_panel_cuda=12)


# ---------------------------------------------------------------------------
# Launch reports
# ---------------------------------------------------------------------------

def _bench_problem():
    """The reference's quick problem of ``bench_cholesky.py``."""
    return _pair(1024, 32, 16, 16)


def test_kernel_report_one_launch_per_fused_sweep():
    """Each sweep is one launch: on the CPU one plain call of
    ``kernels/ops.py``, as the reference's trace holds one pallas_call."""
    bm, _ = _bench_problem()
    grid = bm.grid
    t, nat, ndt = grid.t, grid.n_arrow_tiles, grid.n_diag_tiles
    Ac = band_row_to_col(bm.Dr)
    rep_f = kernel_report(lambda a, r: ops.band_cholesky_sweep(a, r, nchunks=8), Ac, bm.R,
                          grid=grid, sweep="cholesky")
    assert rep_f.launches == {"band_cholesky_sweep": 1}
    k = 4
    bd = torch.zeros((ndt, t, k))
    rep_s = kernel_report(lambda d, r, b: ops.band_forward_sweep(d, r, b), bm.Dr, bm.R, bd,
                          grid=grid, sweep="forward", k=k)
    assert rep_s.launches == {"band_forward_sweep": 1}
    sc = torch.eye(nat * t).reshape(nat, t, nat, t).transpose(1, 2).contiguous()
    rep_i = kernel_report(lambda l_, r, s: ops.selinv_sweep(l_, r, s), Ac, bm.R, sc,
                          grid=grid, sweep="selinv")
    assert rep_i.launches == {"selinv_sweep": 1}
    for rep in (rep_f, rep_s, rep_i):
        assert rep.total_launches == 1
        assert rep.flops > 0 and rep.bytes_moved > 0
        assert rep.intensity == pytest.approx(rep.flops / rep.bytes_moved)
        assert rep.t_compute_s == pytest.approx(rep.flops / telemetry.PEAK_FLOPS)
        assert rep.t_memory_s == pytest.approx(rep.bytes_moved / telemetry.HBM_BW)
        assert rep.bound in ("compute", "memory")
    # the whole factorization: one sweep and the corner's nat potrf and trsm
    rep = kernel_report(lambda mm: factorize_window(mm), bm)
    assert rep.launches == {"band_cholesky_sweep": 1, "potrf": nat, "trsm": nat}
    assert rep.flops is None and rep.asdict()["launches"] == rep.launches


def test_count_launches_charges_the_window_route_per_panel():
    """The legacy window route launches a band_update a column, the twin of
    the reference counting a scanned per-panel kernel by its trip count."""
    m, _ = _pair()
    g = m.grid
    got = count_launches(factorize_window, m, options=SolverOptions(sweep="window"))
    assert got["band_update"] == g.n_diag_tiles
    assert got["potrf"] == g.n_diag_tiles + g.n_arrow_tiles
    assert "band_cholesky_sweep" not in got


@pytest.mark.parametrize("n,bw,ar,t", [(96, 8, 4, 8), (120, 18, 8, 8), (1024, 32, 16, 16),
                                       (10200, 200, 200, 64), (300, 0, 40, 16)])
def test_sweep_cost_equals_reference(n, bw, ar, t):
    grid = TileGrid(ArrowheadStructure(n=n, bandwidth=bw, arrow=ar), t)
    jgrid = J.TileGrid(J.ArrowheadStructure(n=n, bandwidth=bw, arrow=ar), t)
    for sweep in ("cholesky", "forward", "backward", "solve", "selinv"):
        for k in (1, 32):
            assert sweep_cost(grid, sweep, k=k) == jtelemetry.sweep_cost(jgrid, sweep, k=k)
    assert telemetry.rung_tag(grid) == jtelemetry.rung_tag(jgrid)


def test_sweep_cost_model_properties():
    grid = _pair()[0].grid
    chol = sweep_cost(grid, "cholesky")
    fwd, bwd = sweep_cost(grid, "forward", k=8), sweep_cost(grid, "backward", k=8)
    slv, sel = sweep_cost(grid, "solve", k=8), sweep_cost(grid, "selinv")
    assert slv["flops"] == fwd["flops"] + bwd["flops"]
    assert slv["bytes"] == fwd["bytes"] + bwd["bytes"]
    assert chol["flops"] > fwd["flops"] and sel["flops"] > fwd["flops"]
    with pytest.raises(ValueError):
        sweep_cost(grid, "nope")


# ---------------------------------------------------------------------------
# Exporters
# ---------------------------------------------------------------------------

_PROM_LINE = re.compile(
    r"^(# TYPE \w+ (counter|gauge|summary)|"
    r"\w+(\{[\w]+=\"[^\"]*\"(,[\w]+=\"[^\"]*\")*\})? -?[\d.e+-]+(inf|nan)?)$")


def test_prometheus_text_parses():
    reg = Telemetry(enabled=True)
    reg.inc("cache.hit", 3, cache="batched_window")
    reg.gauge("queue_depth", 2)
    for v in (1.0, 2.0, 3.0):
        reg.observe("lat_seconds", v, path="solve")
    lines = reg.to_prometheus_text().strip().split("\n")
    for line in lines:
        assert _PROM_LINE.match(line), f"unparseable line: {line!r}"
    assert 'repro_cache_hit{cache="batched_window"} 3' in lines
    assert any(l.startswith("repro_lat_seconds{") and 'quantile="0.99"' in l for l in lines)
    assert 'repro_lat_seconds_count{path="solve"} 3' in lines


def _tree_trace(reg):
    with reg.span("outer"):
        with reg.span("inner", rung="r"):
            pass
        with reg.span("inner2"):
            pass


def test_chrome_trace_round_trip_span_tree(tmp_path):
    reg = Telemetry(enabled=True)
    _tree_trace(reg)
    reg.inc("c", 2)
    trace = json.loads(json.dumps(reg.to_chrome_trace()))
    evs = trace["traceEvents"]
    assert trace["displayTimeUnit"] == "ms"
    assert all(e["ph"] == "X" for e in evs)
    by_name = {e["name"]: e for e in evs}
    outer_id = by_name["outer"]["args"]["span_id"]
    assert by_name["inner"]["args"]["parent_id"] == outer_id
    assert by_name["inner2"]["args"]["parent_id"] == outer_id
    assert by_name["outer"]["args"]["parent_id"] is None
    assert by_name["inner"]["args"]["rung"] == "r"
    o, i = by_name["outer"], by_name["inner"]
    assert o["ts"] <= i["ts"]
    assert i["ts"] + i["dur"] <= o["ts"] + o["dur"] + 1e-3
    # write_trace: the same events and the span-free metrics beside them
    path = tmp_path / "trace.json"
    telemetry.write_trace(str(path), registry=reg)
    written = json.loads(path.read_text())
    assert [e["name"] for e in written["traceEvents"]] == [e["name"] for e in evs]
    assert written["metrics"]["counters"] == {"c": 2.0} and "spans" not in written["metrics"]


# ---------------------------------------------------------------------------
# Instrumented caches
# ---------------------------------------------------------------------------

def _cache_sequence(c):
    c.get("a")
    c.put("a", 1)
    c.get("a")
    c.put("a", 2)                                   # a concurrent miss's double
    c.put("b", 1)
    c.put("c", 1)                                   # evicts "a"
    return c.get_or_create("d", lambda: 42)


def test_lru_cache_stats_and_duplicate_trace():
    c = LRUCache(maxsize=2, name="unit_cache")
    assert _cache_sequence(c) == 42
    jc = JLRUCache(maxsize=2, name="unit_cache")
    _cache_sequence(jc)
    assert c.stats() == jc.stats()
    st = c.stats()
    assert (st["hits"], st["misses"], st["duplicate_traces"], st["evictions"]) == (1, 2, 1, 2)
    assert (st["size"], st["maxsize"]) == (2, 2)


@pytest.mark.parametrize("name", ["emitting", None])
def test_lru_cache_telemetry_matches_reference(name):
    """A named cache emits the reference's counters and build-time
    histogram, with its counts; an anonymous one stays silent."""
    for t, cls in ((telemetry, LRUCache), (jtelemetry, JLRUCache)):
        t.enable()
        _cache_sequence(cls(maxsize=2, name=name))
    snap, jsnap = telemetry.snapshot(), jtelemetry.snapshot()
    assert snap["counters"] == jsnap["counters"]
    assert snap["histograms"].keys() == jsnap["histograms"].keys()
    if name is None:
        assert snap["counters"] == {} and snap["histograms"] == {}
    else:
        assert snap["counters"]["cache.miss{cache=emitting}"] == 2.0
        assert snap["histograms"]["cache.trace_seconds{cache=emitting}"]["count"] == 1


def test_graph_caches_report_to_no_registry():
    """The CUDA-graph caches are the port's own: the reference has no such
    cache, so their lookups emit nothing, while ``stats`` counts them."""
    telemetry.enable()
    c = GraphCache(2, name="corner_graphs")
    assert c.find("k") is None
    c.put("k", 1)
    assert c.find("k") == 1
    assert telemetry.snapshot()["counters"] == {}
    assert (c.stats()["hits"], c.stats()["misses"]) == (1, 1)


# ---------------------------------------------------------------------------
# The hooks of the ported core against the reference's, on one run each
# ---------------------------------------------------------------------------

def _shape(snap):
    """What must agree: counters with their values, histogram keys and
    counts, and each span's name, tags and parent's name."""
    names = {s["id"]: s["name"] for s in snap["spans"]}
    spans = sorted((s["name"], tuple(sorted((k, str(v)) for k, v in s["tags"].items())),
                    names.get(s["parent"])) for s in snap["spans"])
    return (snap["counters"],
            {k: h["count"] for k, h in snap["histograms"].items()}, spans)


def test_mixed_grid_snapshot_matches_reference():
    """The reference's mixed-grid replay (``test_mixed_grid_replay_snapshot
    _and_trace``) in both packages from cold caches."""
    for mod in (jcholesky._BATCHED_WINDOW_CACHE, jselinv._BATCHED_SELINV_CACHE,
                tcholesky._BATCHED_WINDOW_CACHE, tselinv._BATCHED_SELINV_CACHE):
        mod.clear()
    for t in (telemetry, jtelemetry):
        t.enable()
    pol, jpol = GridBucketPolicy(), J.GridBucketPolicy()
    rng = np.random.default_rng(0)
    for (n, bw, ar), seed in [((96, 8, 4), 0), ((120, 14, 6), 1), ((96, 8, 4), 2)]:
        m, jm = _pair(n, bw, ar, seed=seed)
        B = rng.standard_normal((m.grid.padded_n, 3)).astype(np.float32)
        fb = factorize_window_batched([m, m], options=SolverOptions(policy=pol))
        f = factorize_window(m, options=SolverOptions(policy=pol))
        solve_many(f, torch.from_numpy(B))
        selinv_batched(fb)
        jfb = J.factorize_window_batched([jm, jm], options=J.SolverOptions(impl="ref",
                                                                           policy=jpol))
        jf = J.factorize_window(jm, options=J.SolverOptions(impl="ref", policy=jpol))
        jax.block_until_ready(J.solve_many(jf, jax.numpy.asarray(B), options=JREF))
        J.selinv_batched(jfb, options=JREF)
    snap = telemetry.snapshot()
    assert _shape(reference_view(snap)) == _shape(jtelemetry.snapshot())
    assert {s["name"] for s in snap["spans"]} - {s["name"] for s in reference_view(snap)["spans"]} \
        <= PORT_SPANS
    counters = snap["counters"]
    assert counters["cache.miss{cache=batched_window}"] >= 1
    assert counters["cache.hit{cache=batched_window}"] >= 1
    assert sum(v for k, v in counters.items() if k.startswith("gridpolicy.rung_hit")) >= 6
    fwb = next(s for s in snap["spans"] if s["name"] == "factorize.window_batched")
    assert fwb["tags"]["b"] == 2 and "rung" in fwb["tags"]
    trace = json.loads(json.dumps(telemetry.to_chrome_trace()))
    assert len(trace["traceEvents"]) == len(snap["spans"])
    ids = {e["args"]["span_id"] for e in trace["traceEvents"]}
    assert all(e["args"]["parent_id"] in ids | {None} for e in trace["traceEvents"])


@pytest.mark.parametrize("batched", [False, True])
def test_robustness_ladder_counters_match_reference(batched):
    """Clean input: one attempt an element, counted off the ladder's one
    readback; an indefinite element: the ladder's attempts and outcomes;
    the counts equal to the reference's on the same inputs."""
    m, jm = _pair(seed=3)
    bad = m.Dr.clone()
    bad[..., 0, 0, 0, 0] = -50.0                      # break a diagonal
    jbad = J.BandedCTSF(jm.grid, jm.Dr.at[..., 0, 0, 0, 0].set(-50.0), jm.R, jm.C)
    cases = ((m, jm), (BandedCTSF(m.grid, bad, m.R, m.C), jbad))
    for mat, jmat in cases:
        for t in (telemetry, jtelemetry):
            t.reset()
            t.enable()
        if batched:
            factorize_window_batched([m, mat, m], options=SolverOptions(regularize=True))
            J.factorize_window_batched([jm, jmat, jm], options=J.SolverOptions(
                impl="ref", regularize=True))
        else:
            factorize_window(mat, options=SolverOptions(regularize=True))
            J.factorize_window(jmat, options=J.SolverOptions(impl="ref", regularize=True))
        got, want = telemetry.snapshot()["counters"], jtelemetry.snapshot()["counters"]
        ladder = lambda c: {k: v for k, v in c.items() if k.startswith("robustness.")}
        assert ladder(got) == ladder(want) and ladder(got)
    assert got["robustness.attempts"] >= 2.0
    assert "robustness.status{outcome=recovered}" in got
