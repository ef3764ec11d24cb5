"""What the per-layer metric readers share: means of the harness's spans,
the kernels' rooflines from the traced run's launches and device times,
the device's idle share.  A reader that finds nothing to read returns
None, and the metric is left out of the result line."""
from __future__ import annotations

import re

from . import work
from .tracing import KERNELS

__all__ = ["span_mean", "roofline", "idle_share", "hist_mean"]


def span_mean(rec, name: str, field: str = "ms"):
    vals = [r[field] for r in rec.get("spans", {}).get(name, []) if r[field] is not None]
    return sum(vals) / len(vals) if vals else None


def roofline(rec, kernels, cost):
    """``(percent, note)``: the least time of the window's launches of
    ``kernels`` (the larger of work over the peak rate and bytes over the
    peak bandwidth, per launch, from ``cost(batch, k) -> (flops, bytes)``)
    over their device time in the trace.  None when the card has no peaks
    in the table, nothing launched, or a launch went around the wrappers."""
    peak = work.peaks(rec.get("device_name", ""))
    dev = rec.get("device_kernels")
    if peak is None or dev is None:
        return None
    least, bounds, n_calls = 0.0, set(), 0
    for k in kernels:
        wrapped, grown = rec.get("launch_check", {}).get(k, (0, 0))
        if wrapped != grown:
            return None
        for batch, width in rec["calls"].get(k, []):
            t, bound = work.least_time(*cost(batch, width), peak)
            least += t
            bounds.add(bound)
            n_calls += 1
    pattern = re.compile("|".join(KERNELS[k] for k in kernels))
    times = [ms for name, v in dev.items() if pattern.search(name) for ms in v]
    if not n_calls or not times:
        return None
    return (100.0 * least / (sum(times) / 1e3),
            f"{n_calls} launches, {len(times)} kernels in the trace, bound by "
            f"{'/'.join(sorted(bounds))}, least {least * 1e3:.6f} ms of {sum(times):.6f} ms")


def idle_share(rec):
    if "busy_s" not in rec or not rec.get("window_s"):
        return None
    return 100.0 * (1.0 - rec["busy_s"] / rec["window_s"])


def hist_mean(rec, name: str):
    h = rec.get("telemetry", {}).get("histograms", {}).get(name)
    return h["mean"] if h and h.get("count") else None
