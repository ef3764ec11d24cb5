"""One run of one cell: read the manifest and the cell's files by name,
set up, measure the window, judge the answers against the plain reference,
and print the result line.  ``run.py`` is the command line around it."""
from __future__ import annotations

import importlib.util
import json
import math
import subprocess
import sys
import time
from pathlib import Path

import torch

from . import check, tracing
from .loops import LOOPS
from .reference.dense import DenseReference

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")

__all__ = ["load_cell", "metric_readers", "setup_cell", "compare_cell", "run_cell",
           "forbidden_modules", "main"]


def _json(path: Path):
    return json.loads(Path(path).read_text())


def load_cell(root: Path, workload: str, config_override=None) -> dict:
    """The cell ``workload`` of ``root/BENCHMARK.json`` with its
    configuration, traffic mix and limits, each read from its own file
    under ``root/perfbench``."""
    manifest = _json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in manifest["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}; the manifest has {sorted(cells)}")
    cell = cells[workload]
    configs = {c["name"]: c for c in manifest["configs"]}
    cfg = dict(_json(root / configs[cell["config"]]["file"]))
    cfg.update(config_override or {})
    return {"manifest": manifest, "cell": cell, "config": cfg,
            "mix": _json(root / "perfbench" / "traffic" / f"{cell['traffic']}.json"),
            "limits": _json(root / "perfbench" / "limits" / f"{workload}.json")}


def metric_readers(manifest: dict, workload: str, trace_on: bool, root: Path) -> dict:
    """The metrics a run of ``workload`` reports: with ``trace_on`` its
    per-layer metrics, each with the reader ``metrics/<name>.py`` found by
    name; else its end-to-end metrics."""
    out = {}
    kind = "per_layer" if trace_on else "end_to_end"
    for m in manifest[kind]:
        if workload not in m.get("workloads", [workload]):
            continue
        reader = None
        if trace_on:
            spec = importlib.util.spec_from_file_location(
                f"perfbench_metric_{m['name']}", root / "perfbench" / "metrics" / f"{m['name']}.py")
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
            reader = mod.read
        out[m["name"]] = (m, reader)
    return out


def forbidden_modules() -> list:
    """Loaded modules whose whole top-level name is JAX's or the JAX
    package's."""
    return sorted({m for m in list(sys.modules) if m.split(".")[0] in FORBIDDEN})


def card_name(device) -> str:
    if device.type != "cuda":
        return "cpu"
    return torch.cuda.get_device_name(device)


def power_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "not read"


def setup_cell(root: Path, workload: str, seed: int, seconds: float, trace_on: bool,
               device="cuda", config_override=None, mix_override=None, stages=None):
    """The cell's files, its base matrix from the seed, and its loop set up
    for a window of ``seconds``: the kernels built or loaded, the inputs
    made and the shapes warmed.  ``stages``, a dict, gets the seconds of
    each part."""
    stages = {} if stages is None else stages
    t = time.perf_counter()
    spec = load_cell(root, workload, config_override)
    spec["mix"].update(mix_override or {})
    cfg = spec["config"]
    device = torch.device(device)
    from . import program
    from .frozen.gmrf import make_arrowhead
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
        program.build_kernels()
    stages["kernels"], t = time.perf_counter() - t, time.perf_counter()
    A = make_arrowhead(cfg["n"], cfg["bandwidth"], cfg["arrow"], rho=cfg["rho"], seed=seed)
    stages["matrix"], t = time.perf_counter() - t, time.perf_counter()
    tracer = tracing.Tracer(trace_on, device)
    loop = LOOPS[spec["mix"]["kind"]](cfg, spec["mix"], A, seed, device, tracer)
    loop.setup(seconds)
    stages["loop"] = time.perf_counter() - t
    return spec, A, tracer, loop


def compare_cell(A, loop, device, control=None) -> dict:
    """The numbers of the loop's sampled answers against the plain
    reference's, once the program's state is freed; with ``control`` (a
    reference class) that one's answers stand in the program's place."""
    device = torch.device(device)
    answers = loop.answers()
    loop.release()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    want = loop.reference_answers(DenseReference(A, device))
    if control is not None:
        answers = loop.reference_answers(control(A, device))
    return check.compare(answers, want)


def run_cell(root: Path, workload: str, seed: int, seconds: float, trace_on: bool,
             t_start: float, device="cuda", config_override=None, mix_override=None,
             log=print) -> dict:
    """Set up, measure and judge one run; returns the result line's object."""
    device = torch.device(device)
    stages = {"imports": time.perf_counter() - t_start}
    readers = metric_readers(load_cell(root, workload)["manifest"], workload, trace_on, root)
    spec, A, tracer, loop = setup_cell(root, workload, seed, seconds, trace_on, device,
                                       config_override, mix_override, stages)
    cfg, mix, limits = spec["config"], spec["mix"], spec["limits"]
    setup_s = time.perf_counter() - t_start
    tracer.start()
    out = loop.window(seconds)
    rec = tracer.stop(out)
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    t_ref = time.perf_counter()
    nums = compare_cell(A, loop, device)
    nums["bad_status"] = out["bad_status"]
    ref_s = time.perf_counter() - t_ref
    correct = check.judge(nums, limits)
    metrics = {}
    values = {"setup_s": setup_s}
    if mix["kind"] == "served_open_loop":
        values["served_p95_ms"] = out["served_p95_ms"]
    else:
        values["theta_per_s"] = out["completed"] / out["window_s"]
    rec.update(cell=spec["cell"], config=cfg, mix=mix, outcome=out, device_name=card_name(device))
    for name, (m, reader) in readers.items():
        v = reader(rec) if reader is not None else values.get(name)
        if isinstance(v, tuple):
            v, note = v
            log(f"metric {name}: {note}")
        if v is not None:
            metrics[name] = {"value": float(v), "unit": m["unit"]}
    line = {"correct": bool(correct), "attempted": int(out["attempted"]),
            "failed": int(out["failed"]), "metrics": metrics,
            "device": {"platform": "gpu" if device.type == "cuda" else device.type,
                       "kind": card_name(device), "count": 1,
                       "memory_peak_bytes": int(peak)}}
    if trace_on and "busy_s" in rec:
        line["device"].update(busy_s=rec["busy_s"], window_s=rec["window_s"])
        line["breakdown"] = rec["breakdown"]
    line["checks"] = check.format_checks(nums, limits)
    log(f"window {out['window_s']:.3f} s, {out['attempted']} attempted, {out['failed']} failed; "
        f"set-up {setup_s:.3f} s; reference {ref_s:.3f} s; card {power_limit()}")
    log("set-up s: " + ", ".join(f"{k} {v:.3f}" for k, v in stages.items()))
    for k, v in out.items():
        if k.startswith("lag_"):
            log(f"generator {k} {v:.4f}")
    for k, v in rec.get("launch_check", {}).items():
        log(f"launches {k}: wrapped {v[0]}, device_counts growth {v[1]}")
    for k, v in rec.get("spans", {}).items():
        ms = [r["ms"] for r in v if r["ms"] is not None]
        log(f"span {k}: {len(v)} calls, host {sum(r['host_ms'] for r in v) / len(v):.4f} ms, "
            f"device {sum(ms) / len(ms) if ms else float('nan'):.4f} ms a call")
    return line


def _finite(x):
    if isinstance(x, float) and not math.isfinite(x):
        return None
    if isinstance(x, dict):
        return {k: _finite(v) for k, v in x.items()}
    if isinstance(x, list):
        return [_finite(v) for v in x]
    return x


def main(args, t_start: float, root: Path) -> int:
    err = lambda msg: print(msg, file=sys.stderr, flush=True)
    spec = load_cell(root, args.workload)
    chips = spec["cell"]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        err(f"this cell needs {chips} CUDA device(s); found "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 2
    line = run_cell(root, args.workload, args.seed, args.seconds, bool(args.trace), t_start,
                    log=err)
    bad = forbidden_modules()
    if bad:
        err(f"modules of JAX or the JAX package were loaded: {bad}")
        return 3
    for name, (value, limit) in line["checks"].items():
        err(f"check {name} {value!r} limit {limit!r}")
    print(json.dumps(_finite(line)), flush=True)
    return 0
