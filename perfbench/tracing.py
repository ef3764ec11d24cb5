"""The traced run (``--trace 1``): what the per-layer metrics read.

* Spans of the harness's own around each call into a layer: CUDA events on
  the caller's stream and the host clock (wall time, to place them on the
  profiler's timeline).
* Counts of the port's kernel entry points (``kernels/ops.py``), wrapped
  for the window: each call's kernel and the batch and panel width it was
  given, the work the rooflines count.  The wrapped calls are held to the
  growth of ``telemetry.device_counts()`` over the same window.
* The port's telemetry, enabled for the window: its histograms and spans.
* ``torch.profiler``'s device activity (CUDA only, read from its events
  in memory): every kernel, copy and fill on the card, the port's own
  kernels included, on the host's wall clock.  From it: the busy time (the union of their intervals over every
  stream), the device operations that took most time, and the idle gaps
  labelled by the innermost span (the program's, else the harness's) open
  at the gap's middle.

The untraced run (``--trace 0``) does none of this: ``span`` is a shared
no-op and nothing is wrapped.
"""
from __future__ import annotations

import collections
import contextlib
import re
import time

import torch

__all__ = ["Tracer", "KERNELS", "union_length", "merge"]

# the port's kernel entry points and the CUDA kernels (by name in the
# profiler's trace) their launches run
KERNELS = {
    "band_cholesky_sweep": r"stiles::band_cholesky_kernel<",
    "band_cholesky_partitioned_sweep": r"stiles::band_cholesky_kernel<",
    "band_forward_sweep": r"stiles::band_sweep_kernel<\d+, \d+, false>",
    "band_backward_sweep": r"stiles::band_sweep_kernel<\d+, \d+, true>",
    "selinv_sweep": r"stiles::selinv_(prepass|recurrence)_kernel<",
    "potrf": r"stiles::potrf_kernel<",
    "trsm": r"stiles::trsm_kernel<",
    "solve_panel": r"stiles::solve_panel_kernel<",
    "gemm": r"stiles::gemm", "syrk": r"stiles::syrk", "geadd": r"stiles::geadd",
    "band_update": r"stiles::band_update", "selinv_step": r"stiles::selinv_step",
}
_NULL = contextlib.nullcontext()


def merge(intervals):
    """Sorted, merged ``[start, end)`` intervals."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def union_length(intervals) -> float:
    return sum(e - s for s, e in merge(intervals))


def short_name(name: str) -> str:
    """A kernel's name without its return type and arguments."""
    name = re.sub(r"^void ", "", name)
    depth, out = 0, []
    for ch in name:
        if ch == "(" and depth == 0:
            break
        depth += ch == "<"
        depth -= ch == ">"
        out.append(ch)
    return "".join(out)[:120]


class _Span:
    __slots__ = ("tr", "name", "ev", "w0", "h0")

    def __init__(self, tr, name):
        self.tr, self.name = tr, name

    def __enter__(self):
        self.ev = None
        if self.tr.cuda:
            self.ev = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
            self.ev[0].record()
        self.w0, self.h0 = time.time_ns(), time.perf_counter()
        return self

    def __exit__(self, *exc):
        if self.ev is not None:
            self.ev[1].record()
        self.tr.spans[self.name].append((self.ev, time.perf_counter() - self.h0, self.w0,
                                         time.time_ns()))
        return False


class Tracer:
    def __init__(self, on: bool, device):
        self.on = bool(on)
        self.device = torch.device(device)
        self.cuda = self.on and self.device.type == "cuda"
        self.spans = collections.defaultdict(list)
        self.calls = collections.defaultdict(list)
        self._orig = {}

    def span(self, name: str):
        return _Span(self, name) if self.on else _NULL

    def _wrap(self, name, fn):
        calls = self.calls[name]
        panel = name in ("band_forward_sweep", "band_backward_sweep")

        def wrapped(*args, **kwargs):
            # (batch, panel width) of the launch: a sweep's first input
            # carries the batch axis when it has five dimensions
            x = args[0]
            calls.append((x.shape[0] if x.dim() == 5 else 1, args[2].shape[-1] if panel else 0))
            return fn(*args, **kwargs)

        wrapped.__wrapped__ = fn
        return wrapped

    def start(self) -> None:
        if not self.on:
            return
        from repro_torch.kernels import ops
        from repro_torch.runtime import telemetry
        for name in KERNELS:
            self._orig[name] = getattr(ops, name)
            setattr(ops, name, self._wrap(name, self._orig[name]))
        telemetry.reset()
        telemetry.enable()
        # the telemetry spans' clock (perf_counter) against the trace's (wall)
        self.offset_ns = time.time_ns() - time.perf_counter_ns()
        self.epoch_ns = getattr(telemetry.get_registry(), "_epoch", time.perf_counter_ns())
        self.counts0 = telemetry.device_counts() if self.cuda else {}
        self.prof = None
        if self.cuda:
            self.prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA])
            self.prof.__enter__()
        self.w0 = time.time_ns()

    def stop(self, outcome: dict) -> dict:
        if not self.on:
            return {}
        from repro_torch.kernels import ops
        from repro_torch.runtime import telemetry
        if self.cuda:
            torch.cuda.synchronize(self.device)
        w1 = time.time_ns()
        if self.prof is not None:
            self.prof.__exit__(None, None, None)
        counts1 = telemetry.device_counts() if self.cuda else {}
        for name, fn in self._orig.items():
            setattr(ops, name, fn)
        snap = telemetry.snapshot()
        telemetry.disable()
        spans = {}
        for name, recs in self.spans.items():
            spans[name] = [{"ms": ev[0].elapsed_time(ev[1]) if ev is not None else None,
                            "host_ms": h * 1e3, "w0": w0, "w1": w1_}
                           for ev, h, w0, w1_ in recs]
        rec = {"spans": spans, "calls": {k: list(v) for k, v in self.calls.items()},
               "telemetry": snap, "window_s": (w1 - self.w0) / 1e9}
        rec["launch_check"] = {k: (len(self.calls.get(k, [])), counts1[k] - self.counts0[k])
                               for k in KERNELS if k in counts1 and
                               (self.calls.get(k) or counts1[k] != self.counts0[k])}
        if self.prof is not None:
            rec.update(self._device(self.w0, w1, spans, snap))
        return rec

    def _device(self, w0: int, w1: int, spans: dict, snap: dict) -> dict:
        """Busy time, top device operations and labelled idle gaps of the
        window, from the profiler's device events (wall-clock ns)."""
        lo, hi = float(w0), float(w1)
        ivs, by_name, kernels = [], collections.Counter(), collections.defaultdict(list)
        for e in self.prof.profiler.kineto_results.events():
            if e.device_type() != torch.autograd.DeviceType.CUDA:
                continue
            s, d = float(e.start_ns()), float(e.duration_ns())
            s0, s1 = max(s, lo), min(s + d, hi)
            if s1 <= s0:
                continue
            name = e.name()
            ivs.append((s0, s1))
            by_name[short_name(name)] += (s1 - s0) / 1e9
            if "stiles::" in name:
                kernels[name].append(d / 1e6)
        busy = merge(ivs)
        # the host's spans on the same clock: the program's telemetry spans,
        # then the harness's own
        open_spans = []
        for s in snap.get("spans", []):
            t0 = self.epoch_ns + s["ts_us"] * 1e3 + self.offset_ns
            open_spans.append((t0, t0 + s["dur_us"] * 1e3, 0, s["name"]))
        for name, recs in spans.items():
            for r in recs:
                open_spans.append((float(r["w0"]), float(r["w1"]), 1, f"harness.{name}"))
        gaps, prev = [], lo
        for s, e in busy:
            if s > prev:
                gaps.append((prev, s))
            prev = max(prev, e)
        if hi > prev:
            gaps.append((prev, hi))
        labels = collections.Counter()
        open_spans.sort()
        active, j = [], 0
        for g0, g1 in sorted(gaps, key=lambda g: (g[0] + g[1]) / 2):
            mid = (g0 + g1) / 2
            while j < len(open_spans) and open_spans[j][0] <= mid:
                active.append(open_spans[j])
                j += 1
            active = [a for a in active if a[1] >= mid]
            best = min(active, key=lambda a: (a[2], a[1] - a[0]), default=None)
            labels[best[3] if best else "no span open"] += (g1 - g0) / 1e9
        return {"busy_s": union_length(busy) / 1e9, "window_s": (hi - lo) / 1e9,
                "device_kernels": dict(kernels),
                "breakdown": {"device_ops": [[k, v] for k, v in by_name.most_common(10)],
                              "idle_gaps": [[k, v] for k, v in labels.most_common(10)]}}
