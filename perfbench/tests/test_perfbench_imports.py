"""The run's check on loaded modules compares whole top-level names: it
catches JAX and the JAX package and passes the port, whose name begins with
the JAX package's.  The reference imports nothing of the program."""
import ast
import subprocess
import sys
import types
from pathlib import Path

import pytest

from perfbench import harness

ROOT = Path(__file__).resolve().parents[2]


@pytest.mark.parametrize("name,caught", [
    ("jax", True), ("jax.numpy", True), ("jaxlib", True), ("flax.linen", True),
    ("repro", True), ("repro.core.cholesky", True), ("repro_torch", False),
    ("repro_torch.core", False), ("jaxtyping", False), ("reprolib", False)])
def test_forbidden_modules(monkeypatch, name, caught):
    monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
    assert (name in harness.forbidden_modules()) is caught


def test_reference_imports_nothing_of_the_program():
    files = sorted((ROOT / "perfbench" / "reference").glob("*.py"))
    files += [ROOT / "perfbench" / f for f in ("check.py", "work.py")]
    files += sorted((ROOT / "perfbench" / "frozen").glob("*.py"))
    for f in files:
        for node in ast.walk(ast.parse(f.read_text())):
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                mods = [node.module or ""] if node.level == 0 else []
            else:
                continue
            for m in mods:
                assert m.split(".")[0] not in ("jax", "repro", "repro_torch", "flax"), (f, m)
    code = ("import sys; import perfbench.reference.dense, perfbench.check, perfbench.work, "
            "perfbench.frozen.gmrf, perfbench.frozen.synthetic; "
            "print(sorted({m.split('.')[0] for m in sys.modules}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, check=True, env={"PYTHONPATH": str(ROOT), "PATH": ""})
    loaded = set(eval(out.stdout))
    assert not loaded & {"jax", "repro", "repro_torch", "flax", "jaxlib"}


def test_a_lone_benchmark_prints_no_result(tmp_path):
    """In a directory that holds only the manifest and the harness, a run
    exits with an error and prints no result line."""
    import shutil
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "perfbench", tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run([sys.executable, "perfbench/run.py", "--workload", "table2-5.optimize",
                          "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=tmp_path,
                         capture_output=True, text=True, env={"PATH": ""}, timeout=120)
    assert out.returncode != 0
    assert '"correct"' not in out.stdout
