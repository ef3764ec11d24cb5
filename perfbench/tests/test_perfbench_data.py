"""The harness is driven by data: a configuration, a traffic mix, a cell's
limits and a per-layer metric dropped into a copy of the benchmark, with
their manifest entries, are found by name and run with no other edit."""
import json
import shutil
import time
from pathlib import Path

from perfbench import harness

ROOT = Path(__file__).resolve().parents[2]


def copy_benchmark(dst: Path) -> Path:
    shutil.copy(ROOT / "BENCHMARK.json", dst)
    shutil.copytree(ROOT / "perfbench", dst / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    return dst


def test_new_files_are_found_by_name(tmp_path):
    root = copy_benchmark(tmp_path)
    pb = root / "perfbench"
    (pb / "configs" / "tiny.json").write_text(json.dumps(
        {"n": 300, "bandwidth": 20, "arrow": 12, "rho": 0.7, "t": 8, "precision": "float32"}))
    (pb / "traffic" / "tinymix.json").write_text(json.dumps(
        {"kind": "theta_closed_loop", "batch": 2, "tau": [0.5, 2.0], "delta": [0.0, 0.5],
         "readout": "solve", "k": 2, "warm_steps": 1, "check_steps": 2}))
    (pb / "limits" / "tiny.tinymix.json").write_text(json.dumps(
        {"logdet_rel": 1e-4, "x_rel": 1e-3, "bad_status": 0}))
    (pb / "metrics" / "steps_seen.tiny.py").write_text(
        "def read(rec):\n    return rec['outcome']['steps']\n")
    m = json.loads((root / "BENCHMARK.json").read_text())
    m["configs"].append({"name": "tiny", "source": "https://arxiv.org/abs/2501.02483",
                         "file": "perfbench/configs/tiny.json", "reduced": [], "why": "test"})
    m["workloads"].append({"name": "tiny.tinymix", "config": "tiny", "traffic": "tinymix",
                           "chips": 1, "why": "test"})
    for e in m["end_to_end"]:
        if e["name"] == "theta_per_s":
            e["workloads"].append("tiny.tinymix")
    m["per_layer"].append({"name": "steps_seen.tiny", "unit": "steps", "better": "higher",
                           "source": "host_clock", "layer": "whole theta step",
                           "moves": "theta_per_s", "workloads": ["tiny.tinymix"]})
    (root / "BENCHMARK.json").write_text(json.dumps(m))
    for trace_on, want in ((False, {"setup_s", "theta_per_s"}),
                           (True, {"steps_seen.tiny"})):
        line = harness.run_cell(root, "tiny.tinymix", 2**32 + 5, 0.5, trace_on,
                                time.perf_counter(), device="cpu", log=lambda s: None)
        assert line["correct"] and line["attempted"] > 0
        assert set(line["metrics"]) == want
        assert list(line)[-1] == "checks"
    assert line["metrics"]["steps_seen.tiny"]["value"] >= 1
