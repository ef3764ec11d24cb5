"""The corner's ``solve_panel`` launches' share of their roofline: the
least time of the window's launches as the program counts them
(``kernel.launches{kernel=solve_panel}``, the CUDA-graph replays
included: each launch ``n`` panels, each a triangular solve of a ``t``-row
lower factor against ``k`` columns, counted at element level) over the
device time of ``stiles::solve_panel_kernel`` in the trace.  None unless
the counted launches equal the window's growth of the launches on the card
(``telemetry.device_counts``), or where the card has no peaks in the
table or the registry dropped spans."""
import re

from perfbench import work
from perfbench.tracing import KERNELS


def panel_flops(t: int, k: int) -> float:
    """One panel: per column, ``t`` divisions and ``t (t - 1) / 2``
    multiply-adds, two operations each."""
    return float(k * t * t)


def panel_bytes(t: int, k: int) -> float:
    """One panel: read the factor's lower triangle and the ``t x k``
    right-hand side, write the ``t x k`` solution."""
    return float(work.BYTES * (t * (t + 1) // 2 + 2 * t * k))


def launches(counters: dict) -> dict:
    """``{(t, k, n): count}`` of the counted ``solve_panel`` launches."""
    out = {}
    for key, count in counters.items():
        name, _, labels = key.partition("{")
        lab = dict(kv.split("=", 1) for kv in labels.rstrip("}").split(",") if kv)
        if name == "kernel.launches" and lab.get("kernel") == "solve_panel":
            tkn = (int(lab["t"]), int(lab["k"]), int(lab["n"]))
            out[tkn] = out.get(tkn, 0) + int(count)
    return out


def read(rec):
    tel = rec.get("telemetry", {})
    peak = work.peaks(rec.get("device_name", ""))
    dev = rec.get("device_kernels")
    if tel.get("spans_dropped", 0) or peak is None or dev is None:
        return None
    counted = launches(tel.get("counters", {}))
    total = sum(counted.values())
    if not total or total != rec.get("launch_check", {}).get("solve_panel", (0, 0))[1]:
        return None
    least, bounds = 0.0, set()
    for (t, k, n), count in counted.items():
        s, bound = work.least_time(n * panel_flops(t, k), n * panel_bytes(t, k), peak)
        least += count * s
        bounds.add(bound)
    pattern = re.compile(KERNELS["solve_panel"])
    times = [ms for name, v in dev.items() if pattern.search(name) for ms in v]
    if not times:
        return None
    return (100.0 * least / (sum(times) / 1e3),
            f"{total} counted launches {sorted(counted.items())}, {len(times)} kernels in the "
            f"trace, bound by {'/'.join(sorted(bounds))}, least {least * 1e3:.6f} ms of "
            f"{sum(times):.6f} ms")
