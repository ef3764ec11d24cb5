"""Process-wide telemetry for the factorize/solve/selinv stack.

The paper's performance story rests on *seeing* the execution: sTiles
analyzes its static scheduler with per-task execution traces and balances
tile size against algorithmic intensity with per-kernel flop/byte counts
(§III-B, Table III).  This module is that layer, in two halves:

**Dynamic half** — a process-wide, thread-safe registry of

* **counters** (monotonic, e.g. cache hits per named cache),
* **gauges** (last-write-wins point-in-time values),
* **histograms** (count/sum/min/max plus p50/p90/p99 over a bounded
  sample reservoir), and
* **nestable wall-clock spans** (per-thread stacks; every finished span
  records its parent, so exporters can rebuild the call tree).

Recording happens in the host code around the kernel launches only.  A
span measures host wall time around its call, as the reference's does
around JAX's asynchronous dispatch: CUDA launches return before the card
finishes, and no span or counter synchronizes the card.  A span opened
with ``device=True`` also records a timing event on the current CUDA
stream at entry and one at exit (on the card, outside a stream capture);
the registry keeps the pairs pending and :meth:`Telemetry.snapshot`
resolves those the card has passed into the span's ``dev_us``, so a
snapshot taken after a synchronize has the device time of every such
span.  What must be observed from the card (the breakdown status word of
``kernels.ops.band_cholesky_sweep``) is recorded after the host has read
it back for its own reasons (the jitter ladder's readback).
``inc``/``observe``/``gauge`` refuse a ``torch.Tensor`` with
``TypeError``: a ``float()`` of a CUDA tensor is a hidden device sync,
so passing one fails at the call site, the counterpart of the reference
failing loudly on a JAX tracer.

Every span and every CUDA kernel launch (``kernel.launches``, labelled
``kernel``, ``t``, ``n`` and, for a panel, ``k``: ``kernels/_build.py::
counted``) is named to ``torch.profiler`` through ``record_function``
while telemetry is on and a profiler runs, so a profile shows the
program's spans beside the card's kernels.  A launch inside a CUDA-graph
capture (the task list's and the solves' corner's) counts nothing when
it is recorded; the graph cache's entry keeps it, and each replay counts
it (``core/cholesky.py::GraphCache.replay``).  Span times are kept on the
host's monotonic clock from an epoch taken with the wall clock beside it
(``epoch_unix_ns``), so the spans and the profiler's device events share
one timeline.

Telemetry is **disabled by default** (enable with :func:`enable`, the
``REPRO_TELEMETRY=1`` environment variable, or the :func:`capture`
context manager).  Every recording function bails on one flag check when
disabled, and :func:`span` returns a shared no-op context manager: the
disabled surface of one request costs well under 5 % of a cached
``solve_many`` call (``tests/test_torch_telemetry.py``, and on the card
``chip_smoke.py``).

**Static half** — :func:`kernel_report` runs ``fn(*args)`` once and
counts the kernel launches it made by kernel name
(:func:`count_launches`), and — given a
:class:`~repro_torch.core.structure.TileGrid` and a sweep — attaches the
analytic per-sweep FLOP / bytes-moved estimates of :func:`sweep_cost` and
the roofline terms of the H100 model (:data:`PEAK_FLOPS`,
:data:`HBM_BW`).  The reference reads its launch count off the jaxpr
without running anything; PyTorch has no jaxpr, so the port runs the
function and counts what launched.  On the card a launch is one of a CUDA
wrapper's (:func:`device_counts`: its calls, less those a CUDA-graph
capture recorded, plus those the graphs' replays made); on the CPU it is
one ``kernels/ops.py`` call of a plain version (``ops.plain_calls``), so
a fused sweep counts one there too.  Counts are per process: on a rank of
a distributed run they are that rank's.

Exporters:

* :func:`snapshot` — plain nested dict (counters, gauges, histogram
  summaries, finished spans);
* :func:`to_prometheus_text` — Prometheus text exposition (counters,
  gauges, histograms as summaries with quantile labels);
* :func:`to_chrome_trace` — spans as Chrome trace-event JSON ("X"
  complete events on the Unix epoch in µs, ``torch.profiler``'s), viewable
  in Perfetto / ``chrome://tracing`` over a profiler's trace;
  :func:`write_trace` writes it with the metrics beside.

Port of the JAX package's ``runtime/telemetry.py``; the registry and the
exporters are the reference's, with three additions of the port's own:
device-timed spans, the wall-clock epoch, and the Chrome trace on the Unix
epoch (the reference's starts at the registry's epoch).
"""
from __future__ import annotations

import contextlib
import dataclasses
import itertools
import json
import os
import re
import threading
import time
from collections import Counter
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

__all__ = [
    "Telemetry", "KernelReport", "get_registry", "enable", "disable",
    "enabled", "reset", "inc", "gauge", "observe", "span", "capture",
    "hist_summary", "snapshot", "to_prometheus_text", "to_chrome_trace",
    "write_trace", "rung_tag", "cuda_kernels", "graph_caches", "device_counts",
    "count_launches", "sweep_cost", "kernel_report",
    "PEAK_FLOPS", "HBM_BW", "NVLINK_BW",
]

# Hardware model: one H100 SXM (NVIDIA data sheet), the roofline terms'
# denominators.  float32 outside the tensor cores, as the kernels compute.
PEAK_FLOPS = 67e12           # fp32 FLOP/s per card
HBM_BW = 3.35e12             # HBM3 bytes/s per card
# the card's NVLink total (18 links of 50 GB/s), the counterpart of the
# reference's per-link ICI bandwidth for the collectives' byte footprints
NVLINK_BW = 900e9


def rung_tag(grid) -> str:
    """Canonical label for a tile grid — the rung/grid tag spans and the
    rung-hit counters share, so traces and metrics join on one string."""
    return (f"ndt{grid.n_diag_tiles}.bt{grid.band_tiles}."
            f"nat{grid.n_arrow_tiles}.t{grid.t}")


def _number(name: str, value) -> float:
    """``value`` as a float; a tensor is refused (see the module note)."""
    if isinstance(value, torch.Tensor):
        raise TypeError(
            f"telemetry {name!r}: got a torch.Tensor; record a Python number read where "
            "the host already waits (float() of a CUDA tensor is a hidden device sync)")
    return float(value)


# ---------------------------------------------------------------------------
# Spans
# ---------------------------------------------------------------------------

class _NoopSpan:
    """Shared do-nothing span returned while telemetry is disabled."""
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def tag(self, **tags):
        return self


_NOOP_SPAN = _NoopSpan()


class _Span:
    """A live span: context manager that pushes onto the per-thread stack
    on entry (capturing its parent) and records itself on exit; with
    ``device`` it also records a timing event on the current CUDA stream
    at entry and at exit (see :meth:`Telemetry.span`)."""
    __slots__ = ("_reg", "name", "tags", "id", "parent", "t0", "device", "events", "rf")

    def __init__(self, reg: "Telemetry", name: str, tags: Dict[str, Any],
                 device: bool = False):
        self._reg = reg
        self.name = name
        self.tags = tags
        self.id = None
        self.parent = None
        self.t0 = None
        self.device = device
        self.events = None
        self.rf = None

    def tag(self, **tags) -> "_Span":
        """Attach tags discovered mid-span (e.g. the canonical rung after
        policy resolution)."""
        self.tags.update(tags)
        return self

    def __enter__(self) -> "_Span":
        stack = self._reg._span_stack()
        self.parent = stack[-1].id if stack else None
        self.id = next(self._reg._ids)
        stack.append(self)
        # the span's own cost (the profiler's name, the events) is inside it
        self.t0 = time.perf_counter_ns()
        if torch.autograd._profiler_enabled():
            self.rf = torch.autograd.profiler.record_function(self.name)
            self.rf.__enter__()
        if (self.device and torch.cuda.is_initialized()
                and not torch.cuda.is_current_stream_capturing()):
            stream = torch.cuda.current_stream()
            self.events = (stream,) + self._reg._take_events(stream.device_index)
            self.events[1].record(stream)
        return self

    def __exit__(self, *exc):
        if self.events is not None:
            self.events[2].record(self.events[0])
            self._reg._reap()
        if self.rf is not None:
            self.rf.__exit__(*exc)
        t1 = time.perf_counter_ns()
        stack = self._reg._span_stack()
        if stack and stack[-1] is self:
            stack.pop()
        self._reg._finish_span(self, t1)
        return False


# ---------------------------------------------------------------------------
# Histograms
# ---------------------------------------------------------------------------

class _Hist:
    """Count/sum/min/max plus a bounded sample reservoir for quantiles.

    Samples beyond ``cap`` are counted (in ``count``/``sum``/extrema) but
    not stored; quantiles then describe the first ``cap`` observations and
    the summary carries ``samples_dropped`` so readers know."""
    __slots__ = ("count", "total", "vmin", "vmax", "samples", "dropped",
                 "cap")

    def __init__(self, cap: int):
        self.count = 0
        self.total = 0.0
        self.vmin = float("inf")
        self.vmax = float("-inf")
        self.samples: List[float] = []
        self.dropped = 0
        self.cap = cap

    def add(self, v: float):
        self.count += 1
        self.total += v
        self.vmin = v if v < self.vmin else self.vmin
        self.vmax = v if v > self.vmax else self.vmax
        if len(self.samples) < self.cap:
            self.samples.append(v)
        else:
            self.dropped += 1

    def quantile(self, q: float) -> float:
        """Nearest-rank quantile over the stored samples: the value at
        rank ``ceil(q * n)`` (1-based), so p50 of [1..100] is 50 and p99
        is 99 — exact and deterministic for test-sized data."""
        if not self.samples:
            return float("nan")
        s = sorted(self.samples)
        idx = max(int(-(-q * len(s) // 1)) - 1, 0)      # ceil(q*n) - 1
        return s[min(idx, len(s) - 1)]

    def summary(self) -> Dict[str, float]:
        out = {"count": self.count, "sum": self.total,
               "min": self.vmin if self.count else float("nan"),
               "max": self.vmax if self.count else float("nan"),
               "mean": self.total / self.count if self.count else float("nan"),
               "p50": self.quantile(0.50),
               "p90": self.quantile(0.90),
               "p99": self.quantile(0.99)}
        if self.dropped:
            out["samples_dropped"] = self.dropped
        return out


def _labels_key(labels: Dict[str, Any]) -> Tuple[Tuple[str, str], ...]:
    return tuple(sorted((k, str(v)) for k, v in labels.items()))


def _render_key(name: str, labels: Tuple[Tuple[str, str], ...]) -> str:
    if not labels:
        return name
    return name + "{" + ",".join(f"{k}={v}" for k, v in labels) + "}"


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------

# finished device spans kept pending before the registry resolves those the
# card has passed (a query of each event, no synchronize)
_RESOLVE_EVERY = 256


def _clock_anchor() -> Tuple[int, int]:
    """``(time.time_ns(), time.perf_counter_ns())`` read together: the wall
    clock's reading at the monotonic clock's."""
    return time.time_ns(), time.perf_counter_ns()


class Telemetry:
    """Thread-safe metric + span registry.

    One instance (:func:`get_registry`) backs the module-level functions;
    independent instances are constructible for tests.  All mutation is
    guarded by one lock held only for the bookkeeping (never across user
    code or a kernel launch); span stacks are per-thread so concurrent
    threads nest independently.
    """

    def __init__(self, enabled: bool = False, max_spans: int = 100_000,
                 max_samples: int = 8192):
        if max_spans <= 0 or max_samples <= 0:
            raise ValueError("max_spans and max_samples must be positive")
        self._enabled = bool(enabled)
        self.max_spans = max_spans
        self.max_samples = max_samples
        self._lock = threading.Lock()
        self._counters: Dict[Tuple[str, tuple], float] = {}
        self._gauges: Dict[Tuple[str, tuple], float] = {}
        self._hists: Dict[Tuple[str, tuple], _Hist] = {}
        self._spans: List[Dict[str, Any]] = []
        self._spans_dropped = 0
        self._pending: List[tuple] = []     # (record, device, start event, end event)
        self._free: Dict[int, list] = {}    # the resolved spans' event pairs, by device
        self._local = threading.local()
        self._ids = itertools.count(1)
        self._epoch_unix, self._epoch = _clock_anchor()

    # -- lifecycle ----------------------------------------------------------

    def enable(self):
        self._enabled = True

    def disable(self):
        self._enabled = False

    def enabled(self) -> bool:
        return self._enabled

    def reset(self):
        """Drop all recorded metrics and finished spans (the enabled flag
        and the span-id counter are untouched; live spans finish into the
        cleared buffers) and take a new clock epoch."""
        with self._lock:
            self._counters.clear()
            self._gauges.clear()
            self._hists.clear()
            self._spans.clear()
            self._spans_dropped = 0
            self._pending.clear()
            self._epoch_unix, self._epoch = _clock_anchor()

    # -- recording ----------------------------------------------------------

    def inc(self, name: str, value: float = 1.0, **labels):
        if not self._enabled:
            return
        v = _number(name, value)
        key = (name, _labels_key(labels))
        with self._lock:
            self._counters[key] = self._counters.get(key, 0.0) + v

    def gauge(self, name: str, value: float, **labels):
        if not self._enabled:
            return
        v = _number(name, value)
        key = (name, _labels_key(labels))
        with self._lock:
            self._gauges[key] = v

    def observe(self, name: str, value: float, **labels):
        if not self._enabled:
            return
        v = _number(name, value)
        key = (name, _labels_key(labels))
        with self._lock:
            h = self._hists.get(key)
            if h is None:
                h = self._hists[key] = _Hist(self.max_samples)
            h.add(v)

    def span(self, name: str, device: bool = False, **tags):
        """Open a nestable wall-clock span (use as a context manager).
        With ``device`` the span is also timed on the card: on a CUDA
        device outside a stream capture it records a timing event on the
        current stream at entry and at exit, and :meth:`snapshot` gives
        the time between them as ``dev_us`` once the card has passed the
        second.  Returns the shared no-op span while disabled."""
        if not self._enabled:
            return _NOOP_SPAN
        return _Span(self, name, tags, device)

    def hist_summary(self, name: str, **labels) -> Optional[Dict[str, float]]:
        """Summary (count/sum/min/max/mean/p50/p90/p99) of one histogram
        by exact name + labels, or None if never observed: the typed
        accessor to read a percentile through, instead of string-matching
        rendered ``snapshot()`` keys."""
        key = (name, _labels_key(labels))
        with self._lock:
            h = self._hists.get(key)
            return h.summary() if h is not None else None

    def _span_stack(self) -> list:
        st = getattr(self._local, "stack", None)
        if st is None:
            st = self._local.stack = []
        return st

    def _finish_span(self, span: _Span, t1: int):
        rec = {"name": span.name, "id": span.id, "parent": span.parent,
               "ts_us": (span.t0 - self._epoch) / 1e3,
               "dur_us": (t1 - span.t0) / 1e3,
               "tid": threading.get_ident(), "tags": dict(span.tags)}
        with self._lock:
            if len(self._spans) < self.max_spans:
                self._spans.append(rec)
                if span.events is not None:
                    stream, e0, e1 = span.events
                    self._pending.append((rec, stream.device_index, e0, e1))
            else:
                self._spans_dropped += 1

    def _take_events(self, device: int) -> tuple:
        """Two timing events for a device span on the card ``device``: a
        resolved span's pair (an event may be recorded again), else new."""
        with self._lock:
            free = self._free.get(device)
            if free:
                return free.pop()
        return torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)

    def _reap(self):
        """Resolve the pending device spans the card has passed, oldest
        first up to the first it has not (all of them past
        ``_RESOLVE_EVERY``), at a device span's exit: within its own time."""
        with self._lock:
            if len(self._pending) >= _RESOLVE_EVERY:
                self._resolve()
            n = 0
            while n < len(self._pending) and self._pending[n][3].query():
                rec, device, e0, e1 = self._pending[n]
                rec["dev_us"] = e0.elapsed_time(e1) * 1e3
                self._free.setdefault(device, []).append((e0, e1))
                n += 1
            del self._pending[:n]

    def _resolve(self):
        """Give each pending device span whose end event the card has
        passed its ``dev_us`` and keep its events for reuse; the rest stay
        pending.  Never waits on the card.  Called with the lock held."""
        left = []
        for rec, device, e0, e1 in self._pending:
            if e1.query():
                rec["dev_us"] = e0.elapsed_time(e1) * 1e3
                self._free.setdefault(device, []).append((e0, e1))
            else:
                left.append((rec, device, e0, e1))
        self._pending = left

    # -- exporters ----------------------------------------------------------

    def snapshot(self, include_spans: bool = True) -> Dict[str, Any]:
        """Plain-dict view of everything recorded so far: ``counters`` and
        ``gauges`` keyed ``name{label=value,...}``, ``histograms`` mapped
        to their summaries (count/sum/min/max/mean/p50/p90/p99), and (by
        default) the finished ``spans`` with parent ids intact.  A span
        starts ``ts_us`` after the epoch, which is ``epoch_unix_ns`` on the
        wall clock, and lasts ``dur_us`` on the host; a device span the
        card has passed (after a synchronize: all of them) carries its
        device time as ``dev_us``."""
        with self._lock:
            self._resolve()
            out: Dict[str, Any] = {
                "enabled": self._enabled,
                "epoch_unix_ns": self._epoch_unix,
                "counters": {_render_key(*k): v
                             for k, v in sorted(self._counters.items())},
                "gauges": {_render_key(*k): v
                           for k, v in sorted(self._gauges.items())},
                "histograms": {_render_key(*k): h.summary()
                               for k, h in sorted(self._hists.items())},
            }
            if include_spans:
                out["spans"] = [dict(s, tags=dict(s["tags"]))
                                for s in self._spans]
                out["spans_dropped"] = self._spans_dropped
        return out

    def to_prometheus_text(self) -> str:
        """Prometheus text exposition: counters and gauges verbatim,
        histograms as summaries (``quantile`` labels + ``_sum``/``_count``
        series).  Metric names are prefixed ``repro_`` and sanitized."""
        lines: List[str] = []
        with self._lock:
            counters = dict(self._counters)
            gauges = dict(self._gauges)
            hists = {k: h.summary() for k, h in self._hists.items()}
        for kind, data in (("counter", counters), ("gauge", gauges)):
            seen = set()
            for (name, labels), v in sorted(data.items()):
                pname = _prom_name(name)
                if pname not in seen:
                    lines.append(f"# TYPE {pname} {kind}")
                    seen.add(pname)
                lines.append(f"{pname}{_prom_labels(labels)} {_prom_num(v)}")
        seen = set()
        for (name, labels), s in sorted(hists.items()):
            pname = _prom_name(name)
            if pname not in seen:
                lines.append(f"# TYPE {pname} summary")
                seen.add(pname)
            for q in ("0.5", "0.9", "0.99"):
                ql = labels + (("quantile", q),)
                val = s[{"0.5": "p50", "0.9": "p90", "0.99": "p99"}[q]]
                lines.append(f"{pname}{_prom_labels(ql)} {_prom_num(val)}")
            lines.append(f"{pname}_sum{_prom_labels(labels)} "
                         f"{_prom_num(s['sum'])}")
            lines.append(f"{pname}_count{_prom_labels(labels)} "
                         f"{_prom_num(s['count'])}")
        return "\n".join(lines) + ("\n" if lines else "")

    def to_chrome_trace(self) -> Dict[str, Any]:
        """Spans as Chrome trace-event JSON (``ph="X"`` complete events,
        ``ts`` in microseconds on the Unix epoch, as ``torch.profiler``'s
        events are, so the two files overlay) — ``json.dump`` the result and
        open it in Perfetto (ui.perfetto.dev) or ``chrome://tracing``.
        Span/parent ids and a device span's ``dev_us`` ride in ``args`` so
        the tree survives the export."""
        pid = os.getpid()
        with self._lock:
            self._resolve()
            epoch_us = self._epoch_unix / 1e3
            spans = [dict(s, tags=dict(s["tags"])) for s in self._spans]
        events = [{
            "name": s["name"],
            "cat": s["name"].split(".", 1)[0],
            "ph": "X",
            "ts": epoch_us + s["ts_us"],
            "dur": s["dur_us"],
            "pid": pid,
            "tid": s["tid"],
            "args": {**s["tags"], "span_id": s["id"],
                     "parent_id": s["parent"],
                     **({"dev_us": s["dev_us"]} if "dev_us" in s else {})},
        } for s in spans]
        return {"traceEvents": events, "displayTimeUnit": "ms"}


def _prom_name(name: str) -> str:
    return "repro_" + re.sub(r"[^a-zA-Z0-9_]", "_", name)


def _prom_labels(labels: Tuple[Tuple[str, str], ...]) -> str:
    if not labels:
        return ""
    esc = lambda v: str(v).replace("\\", r"\\").replace('"', r"\"")
    body = ",".join(
        f'{re.sub(r"[^a-zA-Z0-9_]", "_", k)}="{esc(v)}"' for k, v in labels)
    return "{" + body + "}"


def _prom_num(v: float) -> str:
    f = float(v)
    return repr(int(f)) if f == int(f) and abs(f) < 1e15 else repr(f)


# ---------------------------------------------------------------------------
# Default registry + module-level API
# ---------------------------------------------------------------------------

_DEFAULT = Telemetry(
    enabled=os.environ.get("REPRO_TELEMETRY", "") not in ("", "0"))


def get_registry() -> Telemetry:
    return _DEFAULT


def enable():
    _DEFAULT.enable()


def disable():
    _DEFAULT.disable()


def enabled() -> bool:
    return _DEFAULT._enabled


def reset():
    _DEFAULT.reset()


def inc(name: str, value: float = 1.0, **labels):
    if _DEFAULT._enabled:
        _DEFAULT.inc(name, value, **labels)


def gauge(name: str, value: float, **labels):
    if _DEFAULT._enabled:
        _DEFAULT.gauge(name, value, **labels)


def observe(name: str, value: float, **labels):
    if _DEFAULT._enabled:
        _DEFAULT.observe(name, value, **labels)


def span(name: str, device: bool = False, **tags):
    if not _DEFAULT._enabled:
        return _NOOP_SPAN
    return _Span(_DEFAULT, name, tags, device)


def hist_summary(name: str, **labels) -> Optional[Dict[str, float]]:
    return _DEFAULT.hist_summary(name, **labels)


def snapshot(include_spans: bool = True) -> Dict[str, Any]:
    return _DEFAULT.snapshot(include_spans=include_spans)


def to_prometheus_text() -> str:
    return _DEFAULT.to_prometheus_text()


def to_chrome_trace() -> Dict[str, Any]:
    return _DEFAULT.to_chrome_trace()


@contextlib.contextmanager
def capture():
    """Enable the default registry for the duration of a block, yielding
    it; the previous enabled state is restored on exit (recorded data is
    kept — call :func:`reset` to drop it)."""
    prev = _DEFAULT._enabled
    _DEFAULT.enable()
    try:
        yield _DEFAULT
    finally:
        _DEFAULT._enabled = prev


def write_trace(path: str, registry: Optional[Telemetry] = None):
    """Dump the registry's Chrome trace (plus a ``metrics`` key holding
    the span-free snapshot — Perfetto ignores unknown top-level keys) to
    ``path`` as JSON."""
    reg = registry or _DEFAULT
    trace = reg.to_chrome_trace()
    trace["metrics"] = reg.snapshot(include_spans=False)
    with open(path, "w") as f:
        json.dump(trace, f, indent=1)


# ---------------------------------------------------------------------------
# Kernel launches: counting + analytic sweep costs
# ---------------------------------------------------------------------------

def cuda_kernels() -> Dict[str, Callable]:
    """The CUDA kernel wrappers by kernel name; each counts its launches in
    its ``launches`` attribute (``kernels/_build.py::counted``)."""
    from repro_torch.kernels.band_cholesky import (band_cholesky_partitioned_sweep_cuda,
                                                   band_cholesky_sweep_cuda)
    from repro_torch.kernels.band_solve import band_backward_sweep_cuda, band_forward_sweep_cuda
    from repro_torch.kernels.band_update import band_update_cuda
    from repro_torch.kernels.gemm import geadd_cuda, gemm_cuda, syrk_cuda
    from repro_torch.kernels.potrf import potrf_cuda
    from repro_torch.kernels.selinv import (selinv_prepass_cuda, selinv_step_cuda,
                                            selinv_sweep_cuda)
    from repro_torch.kernels.trsm import solve_panel_cuda, trsm_cuda
    return {"potrf": potrf_cuda, "trsm": trsm_cuda, "band_cholesky_sweep": band_cholesky_sweep_cuda,
            "solve_panel": solve_panel_cuda, "band_forward_sweep": band_forward_sweep_cuda,
            "band_backward_sweep": band_backward_sweep_cuda, "selinv_sweep": selinv_sweep_cuda,
            "gemm": gemm_cuda, "syrk": syrk_cuda, "geadd": geadd_cuda,
            "band_cholesky_partitioned_sweep": band_cholesky_partitioned_sweep_cuda,
            "band_update": band_update_cuda, "selinv_step": selinv_step_cuda,
            "selinv_prepass": selinv_prepass_cuda}


def graph_caches() -> tuple:
    """The port's CUDA-graph caches: the task list's and the solves' corner's."""
    from repro_torch.core.cholesky import tasklist_graphs
    from repro_torch.core.solve import corner_graphs
    return (tasklist_graphs, corner_graphs)


def device_counts(kern: Optional[Dict[str, Callable]] = None) -> Dict[str, int]:
    """Launches on the card by kernel name (``kern``: name -> wrapper,
    :func:`cuda_kernels` by default): each wrapper's count of its calls,
    less the launches the captures of the task list and of the solves'
    corner recorded into their CUDA graphs (calls of the wrappers that ran
    nothing), plus those the graphs' replays made."""
    kern = cuda_kernels() if kern is None else kern
    caches = graph_caches()
    return {k: f.launches + sum(g.replayed[f.__name__] - g.recorded[f.__name__] for g in caches)
            for k, f in kern.items()}


def _launch_totals() -> Counter:
    from repro_torch.kernels import ops
    total = Counter(device_counts())
    total.update(ops.plain_calls)
    return total


def count_launches(fn: Callable, *args, **kwargs) -> Dict[str, int]:
    """Run ``fn(*args, **kwargs)`` once and return the kernel launches it
    made, by kernel name: on the card the CUDA kernels' launches
    (:func:`device_counts`), on the CPU the plain versions'
    ``kernels/ops.py`` calls, one a sweep.  Counts are this process's."""
    before = _launch_totals()
    fn(*args, **kwargs)
    return dict(sorted((_launch_totals() - before).items()))


def sweep_cost(grid, sweep: str, k: int = 1,
               dtype_bytes: int = 4) -> Dict[str, float]:
    """Analytic FLOP / bytes-moved estimate of one banded-arrowhead sweep
    on ``grid`` — the tile-granular model the paper tunes tile size with
    (flops from tile-matmul counts, bytes from CTSF array traffic).

    Sweeps: ``"cholesky"`` (band+arrow factorization incl. the dense
    corner), ``"forward"`` / ``"backward"`` (one triangular band solve of
    a width-``k`` RHS panel), ``"solve"`` (forward + backward), and
    ``"selinv"`` (the blocked Takahashi recurrence).

    The FLOP side of the cholesky model is shared with
    ``core.gridpolicy.padded_flop_overhead`` (same tile-matmul counter),
    so the padding-overhead metric and these absolute estimates cannot
    drift apart.  Bytes assume each CTSF array crosses HBM once per read
    and once per write, the fused single-launch kernels' traffic.
    Returns ``{"flops", "bytes", "intensity"}`` (intensity in
    flops/byte); the reference's formulas, unchanged."""
    t, ndt = grid.t, grid.n_diag_tiles
    bt, nat = grid.band_tiles, grid.n_arrow_tiles
    mm = 2.0 * t ** 3                    # one (t,t)@(t,t) tile matmul
    pmm = 2.0 * t * t * k                # one (t,t)@(t,k) panel matmul
    factor_bytes = float((ndt * (bt + 1) + ndt * nat + nat * nat)
                         * t * t * dtype_bytes)
    panel_bytes = float((ndt + nat) * t * k * dtype_bytes)
    corner_n = nat * t
    if sweep == "cholesky":
        from repro_torch.core.gridpolicy import _sweep_tile_matmuls
        flops = _sweep_tile_matmuls(ndt, bt, nat) * mm \
            + corner_n ** 3 / 3.0        # dense corner Cholesky
        byts = 2.0 * factor_bytes        # read A tiles, write L tiles
    elif sweep in ("forward", "backward"):
        panel_ops = max(ndt, 0) * (bt + nat + 1) + nat * (nat + 1) / 2.0
        flops = panel_ops * pmm
        byts = factor_bytes + 2.0 * panel_bytes
    elif sweep == "solve":
        f = sweep_cost(grid, "forward", k, dtype_bytes)
        b = sweep_cost(grid, "backward", k, dtype_bytes)
        flops = f["flops"] + b["flops"]
        byts = f["bytes"] + b["bytes"]
    elif sweep == "selinv":
        # per column: (bt+1) band panels + nat arrow rows, each contracting
        # over the (bt + nat)-deep trailing ring, plus the diagonal seed
        tiles = max(ndt, 0) * ((bt + 1 + nat) * (bt + nat) + 1)
        flops = tiles * mm + float(corner_n) ** 3   # corner seed L^-1, L^-T L^-1
        byts = 2.0 * factor_bytes        # read L tiles, write Sigma tiles
    else:
        raise ValueError(f"unknown sweep {sweep!r} (want 'cholesky', "
                         "'forward', 'backward', 'solve' or 'selinv')")
    return {"flops": float(flops), "bytes": float(byts),
            "intensity": float(flops) / max(byts, 1.0)}


@dataclasses.dataclass(frozen=True)
class KernelReport:
    """Result of :func:`kernel_report`.

    ``launches`` is exact: the kernel launches of one run by kernel name
    (:func:`count_launches`); the cost fields are the analytic
    :func:`sweep_cost` estimates (``None`` without a grid), with
    ``t_compute_s`` / ``t_memory_s`` the roofline terms under the module's
    hardware model and ``bound`` naming the larger one."""
    launches: Dict[str, int]
    sweep: Optional[str] = None
    flops: Optional[float] = None
    bytes_moved: Optional[float] = None
    intensity: Optional[float] = None
    t_compute_s: Optional[float] = None
    t_memory_s: Optional[float] = None
    bound: Optional[str] = None

    @property
    def total_launches(self) -> int:
        return sum(self.launches.values())

    def asdict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)


def kernel_report(fn: Callable, *args, grid=None, sweep: Optional[str] = None,
                  k: int = 1, dtype_bytes: int = 4) -> KernelReport:
    """Run ``fn(*args)`` once, count its kernel launches by kernel name,
    and (when ``grid`` and ``sweep`` are given) attach the analytic
    per-sweep FLOP / bytes-moved estimates and roofline terms.  This is
    how tests gate launch/intensity regressions without a benchmark::

        rep = kernel_report(lambda a, r: ops.band_cholesky_sweep(a, r),
                            Ac, R, grid=grid, sweep="cholesky")
        assert rep.launches == {"band_cholesky_sweep": 1}

    The reference traces ``fn`` to a jaxpr without running it; the port
    has no jaxpr to read, so ``fn`` runs once here."""
    launches = count_launches(fn, *args)
    if grid is None or sweep is None:
        return KernelReport(launches=launches, sweep=sweep)
    cost = sweep_cost(grid, sweep, k=k, dtype_bytes=dtype_bytes)
    t_c = cost["flops"] / PEAK_FLOPS
    t_m = cost["bytes"] / HBM_BW
    return KernelReport(
        launches=launches, sweep=sweep, flops=cost["flops"],
        bytes_moved=cost["bytes"], intensity=cost["intensity"],
        t_compute_s=t_c, t_memory_s=t_m,
        bound="compute" if t_c >= t_m else "memory")
