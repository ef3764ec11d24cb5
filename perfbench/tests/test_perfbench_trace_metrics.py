"""The readers of the metrics that read the program's own spans and
launch counter (``corner_ms.theta``, ``prepare_host_ms.theta``,
``diagonal_host_ms.theta``, ``solve_panel_roofline.theta``), each on a
synthetic traced record: its value, None where the registry dropped spans,
None where the program has nothing to read (as a checkout before the
spans has not), and the roofline None where the counted launches miss
some of the card's; ``solve_panel``'s work count against a brute-force
count of the scalar triangular solve on small tiles."""
import copy
import importlib.util
import json
from pathlib import Path

import numpy as np
import pytest

from perfbench import harness, work

ROOT = Path(__file__).resolve().parents[2]
MANIFEST = json.loads((ROOT / "BENCHMARK.json").read_text())
NEW = ("corner_ms.theta", "prepare_host_ms.theta", "diagonal_host_ms.theta",
       "solve_panel_roofline.theta")
CARD = "NVIDIA H100 80GB HBM3"


def module(name):
    spec = importlib.util.spec_from_file_location(
        f"metric_{name}", ROOT / "perfbench" / "metrics" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reader(name):
    return module(name).read


def span(name, dur_us, dev_us=None):
    s = {"name": name, "id": 0, "parent": None, "ts_us": 0.0, "dur_us": dur_us, "tags": {}}
    return s if dev_us is None else dict(s, dev_us=dev_us)


def record():
    """Two steps of a traced window: each a factorization with its corner
    and the three preparations, a diagonal, and 2 nat = 8 solve_panel
    launches of a batch of 8 at k = 1, all 16 in the trace."""
    spans = []
    for _ in range(2):
        spans += [span("factorize.prepare", 100.0), span("factorize.sweep", 50.0, 4000.0),
                  span("factorize.corner", 300.0, 250.0), span("solve.prepare", 40.0),
                  span("selinv.prepare", 60.0), span("selinv.diagonal", 700.0)]
    return {"telemetry": {"spans": spans, "spans_dropped": 0, "counters": {
                "kernel.launches{k=1,kernel=solve_panel,n=8,t=64}": 16.0,
                "kernel.launches{kernel=potrf,n=32,t=64}": 8.0}},
            "outcome": {"steps": 2}, "device_name": CARD,
            "launch_check": {"solve_panel": (0, 16)},
            "device_kernels": {"void stiles::solve_panel_kernel<64, 1>(float const*)": [0.004] * 16,
                               "void stiles::potrf_kernel<64>(float const*)": [0.009] * 8}}


def test_the_harness_finds_the_readers():
    for name in NEW:
        m = next(m for m in MANIFEST["per_layer"] if m["name"] == name)
        assert m["moves"] == "theta_per_s"
        for cell in m["workloads"]:
            assert callable(harness.metric_readers(MANIFEST, cell, True, ROOT)[name][1])


def test_values():
    rec = record()
    assert reader("corner_ms.theta")(rec) == pytest.approx(0.25)
    assert reader("prepare_host_ms.theta")(rec) == pytest.approx(0.2)
    assert reader("diagonal_host_ms.theta")(rec) == pytest.approx(0.7)
    value, note = reader("solve_panel_roofline.theta")(rec)
    t, k = 64, 1
    least = 8 * (4 * (t * (t + 1) // 2 + 2 * t * k)) / 3.35e12       # bytes bound it
    assert value == pytest.approx(100.0 * 16 * least / (16 * 0.004e-3))
    assert "16 counted launches" in note and "memory" in note


@pytest.mark.parametrize("name", NEW)
def test_none_on_dropped_spans(name):
    rec = record()
    rec["telemetry"]["spans_dropped"] = 1
    assert reader(name)(rec) is None


@pytest.mark.parametrize("name", NEW)
def test_none_without_the_programs_spans(name):
    """A program without the spans and the counter (the parent of the
    change that adds them) gives nothing to read, and the reader says so
    without raising."""
    rec = record()
    rec["telemetry"] = {"spans": [], "spans_dropped": 0, "counters": {}}
    assert reader(name)(rec) is None


def test_corner_none_without_device_time():
    rec = record()
    del rec["telemetry"]["spans"][2]["dev_us"]
    assert reader("corner_ms.theta")(rec) is None


@pytest.mark.parametrize("grown", [0, 15, 17])
def test_roofline_none_on_a_count_mismatch(grown):
    rec = copy.deepcopy(record())
    rec["launch_check"]["solve_panel"] = (0, grown)
    assert reader("solve_panel_roofline.theta")(rec) is None


def brute_panel(L, B, trans):
    """``L X = B`` (``L^T X = B`` with ``trans``) by scalar substitution,
    row by row, each operation counted, and the distinct elements of L and
    B read."""
    t, k = B.shape
    X, ops, read = np.zeros_like(B), 0, set()
    order = range(t - 1, -1, -1) if trans else range(t)
    for c in range(k):
        for i in order:
            acc = B[i, c]
            read.add(("b", i, c))
            for j in (range(i + 1, t) if trans else range(i)):
                a = L[j, i] if trans else L[i, j]
                read.add(("l",) + ((j, i) if trans else (i, j)))
                acc -= a * X[j, c]
                ops += 2
            X[i, c] = acc / L[i, i]
            read.add(("l", i, i))
            ops += 1
    return X, ops, len(read)


@pytest.mark.parametrize("t,k", [(1, 1), (4, 1), (5, 3), (8, 2), (16, 7)])
@pytest.mark.parametrize("trans", [False, True])
def test_solve_panel_work_matches_brute_force(t, k, trans):
    panel = module("solve_panel_roofline.theta")
    rng = np.random.default_rng(t * 31 + k)
    L = np.tril(rng.standard_normal((t, t))) + t * np.eye(t)
    B = rng.standard_normal((t, k))
    X, ops, read = brute_panel(L, B, trans)
    np.testing.assert_allclose(X, np.linalg.solve(L.T if trans else L, B), rtol=1e-10,
                               atol=1e-10)
    assert ops == panel.panel_flops(t, k)
    assert work.BYTES * (read + t * k) == panel.panel_bytes(t, k)
