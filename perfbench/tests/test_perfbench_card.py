"""A short run of each cell on the card: correct, and in the traced run the
device busy, every wrapped launch one that ``telemetry.device_counts``
saw, and the rooflines under 100 %.  Skips without a CUDA device:

    PYTHONPATH=src python -m pytest -q -m gpu perfbench/tests/test_perfbench_card.py
"""
import json
import time
from pathlib import Path

import pytest
import torch

from perfbench import harness

ROOT = Path(__file__).resolve().parents[2]
CELLS = [w["name"] for w in json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.mark.parametrize("cell", CELLS)
def test_cell_on_the_card(cuda, cell):
    line = harness.run_cell(ROOT, cell, 2**31 + 4242, 1.0, True, time.perf_counter(),
                            log=lambda s: None)
    assert line["correct"], line["checks"]
    assert 0 < line["device"]["busy_s"] <= line["device"]["window_s"]
    for name, m in line["metrics"].items():
        if "roofline" in name or "mfu" in name:
            assert 0 < m["value"] <= 100, (name, m)
