"""What the fault tests share: a cell run on the CPU at a small size, with
the timed path broken underneath, and the control in the program's place."""
import json
import time
from pathlib import Path

from perfbench import harness
from perfbench.reference.dense import Control

ROOT = Path(__file__).resolve().parents[2]
SMALL = {"n": 600, "bandwidth": 30, "arrow": 24, "t": 8}


def with_cell(tmp: Path, cell: dict) -> Path:
    """A root whose manifest also has ``cell``, the benchmark's files its
    own: for a mix that no cell of ``BENCHMARK.json`` runs."""
    m = json.loads((ROOT / "BENCHMARK.json").read_text())
    m["workloads"].append(cell)
    (tmp / "BENCHMARK.json").write_text(json.dumps(m))
    (tmp / "perfbench").symlink_to(ROOT / "perfbench")
    return tmp


def run(cell, mix=None, seed=2**32 + 77, root=ROOT):
    """``correct`` and the checks of one run of ``cell`` at the small size."""
    mix = dict({"warm_seconds": 0.0}, **(mix or {}))
    line = harness.run_cell(root, cell, seed, 0.4, False, time.perf_counter(), device="cpu",
                            config_override=SMALL, mix_override=mix, log=lambda s: None)
    return line["correct"], line["checks"]


def control(cell, mix=None, seed=2**32 + 78, root=ROOT):
    """``correct`` of the control (the reference one precision lower) in the
    program's place, on the cell's own comparison."""
    mix = dict({"warm_seconds": 0.0}, **(mix or {}))
    spec, A, _, loop = harness.setup_cell(root, cell, seed, 0.4, False, "cpu", SMALL, mix)
    out = loop.window(0.4)
    nums = harness.compare_cell(A, loop, "cpu", control=Control)
    nums["bad_status"] = out["bad_status"]
    return harness.check.judge(nums, spec["limits"]), nums
