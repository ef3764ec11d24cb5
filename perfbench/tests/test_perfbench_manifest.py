"""``BENCHMARK.json`` keeps to the benchmark's contract: its keys, names,
units and strings, every cell's files and metrics, and the run length that
fits the check with the full 24 cells."""
import json
import re
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
MANIFEST = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
KEYS = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
CONFIG_KEYS = {"name", "source", "file", "reduced", "why"}
CELL_KEYS = {"name", "config", "traffic", "chips", "why"}
E2E_KEYS = {"name", "unit", "better", "bound", "source", "workloads"}
LAYER_KEYS = {"name", "unit", "better", "source", "layer", "moves", "workloads"}
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def line(s) -> bool:
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def cells_of(metric):
    return metric.get("workloads", [w["name"] for w in MANIFEST["workloads"]])


def test_top_level():
    assert set(MANIFEST) == KEYS
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    assert 1 <= len(MANIFEST["paths"]) <= 16
    for p in MANIFEST["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
        assert (ROOT / p).is_dir() and not p.endswith("_torch")
    cmd = MANIFEST["command"]
    assert 1 <= len(cmd) <= 32 and all(line(w) for w in cmd)
    for w in cmd[1:]:
        assert not w.startswith("/") and ".." not in w
        if "/" in w:
            assert any(w.startswith(p + "/") for p in MANIFEST["paths"])
    rs = MANIFEST["run_seconds"]
    assert isinstance(rs, int) and 1 <= rs <= 51
    # a full check of 24 cells: 2 + 14 runs a cell, run_seconds + 60 each,
    # 2 x 90 s of compiling a cell, 1,200 s spare
    assert (2 + 14 * 24) * (rs + 60) + 24 * 180 + 1200 <= 43200


def test_names_and_units():
    names = [c["name"] for c in MANIFEST["configs"]]
    names += [w["name"] for w in MANIFEST["workloads"]]
    metrics = MANIFEST["end_to_end"] + MANIFEST["per_layer"]
    names += [m["name"] for m in metrics]
    names += [w[k] for w in MANIFEST["workloads"] for k in ("config", "traffic")]
    names += [k for c in MANIFEST["configs"] for k in c["reduced"]]
    for n in names:
        assert NAME.match(n), n
    for kind in ("configs", "workloads"):
        ns = [x["name"] for x in MANIFEST[kind]]
        assert len(ns) == len(set(ns))
    ms = [m["name"] for m in metrics]
    assert len(ms) == len(set(ms))
    for m in metrics:
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES


def test_configs():
    files = [c["file"] for c in MANIFEST["configs"]]
    assert 1 <= len(files) <= 24 and len(files) == len(set(files))
    used = {w["config"] for w in MANIFEST["workloads"]}
    for c in MANIFEST["configs"]:
        assert set(c) == CONFIG_KEYS
        assert line(c["source"]) and line(c["why"]) and len(c["reduced"]) <= 16
        assert any(c["file"].startswith(p + "/") for p in MANIFEST["paths"])
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert {"n", "bandwidth", "arrow", "rho", "t", "precision"} <= set(cfg)
        assert c["name"] in used


def test_cells():
    cells = MANIFEST["workloads"]
    assert 1 <= len(cells) <= 24
    assert len({(w["config"], w["traffic"]) for w in cells}) == len(cells)
    assert sum(w["chips"] == 4 for w in cells) <= max(1, len(cells) // 4)
    e2e = {m["name"]: m for m in MANIFEST["end_to_end"]}
    for w in cells:
        assert set(w) == CELL_KEYS and w["chips"] in (1, 4) and line(w["why"])
        assert (ROOT / "perfbench" / "traffic" / f"{w['traffic']}.json").is_file()
        assert (ROOT / "perfbench" / "limits" / f"{w['name']}.json").is_file()
        reports = [m for m in e2e.values() if w["name"] in cells_of(m)]
        assert "setup_s" in [m["name"] for m in reports] and len(reports) >= 2
        assert any(w["name"] in cells_of(m) for m in MANIFEST["per_layer"])


def test_metrics():
    e2e = {m["name"]: m for m in MANIFEST["end_to_end"]}
    assert 1 <= len(e2e) <= 16 and "setup_s" in e2e
    assert e2e["setup_s"]["bound"] <= 0.25
    for m in e2e.values():
        assert set(m) <= E2E_KEYS and set(m) >= E2E_KEYS - {"workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    cells = {w["name"] for w in MANIFEST["workloads"]}
    layers = MANIFEST["per_layer"]
    assert 1 <= len(layers) <= 128
    for m in layers:
        assert set(m) <= LAYER_KEYS and set(m) >= LAYER_KEYS - {"workloads"}
        assert line(m["layer"]) and m["moves"] in e2e
        assert set(cells_of(m)) <= cells
        for c in cells_of(m):
            assert c in cells_of(e2e[m["moves"]]), (m["name"], c)
        assert (ROOT / "perfbench" / "metrics" / f"{m['name']}.py").is_file()
        if m["name"].endswith("_roofline") or "_roofline." in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"


@pytest.mark.parametrize("cell", [w["name"] for w in MANIFEST["workloads"]])
def test_limits_are_numbers(cell):
    limits = json.loads((ROOT / "perfbench" / "limits" / f"{cell}.json").read_text())
    assert limits and all(isinstance(v, (int, float)) and v >= 0 for v in limits.values())
    assert limits.get("bad_status") == 0
