"""Shared batching utilities for the batched entry points.

The batched paths — ``cholesky.factorize_window_batched``,
``solve.solve_many_batched`` and ``selinv.selinv_batched`` — dispatch a
per-grid bound callable with the same two tricks as the reference's:

* **pow2 bucketing** (:func:`bucketed_batched_call`): pad the leading
  batch axis (repeating the last element) up to the next power of two,
  call, drop the padding results.  PyTorch compiles nothing per batch
  size, but the solves' corner is captured into a CUDA graph a batch
  shape (``solve.corner_graph_key``): bucketing bounds those captures at
  log2(max batch) a grid, as it bounds XLA compiles in the reference.
* **a bounded cache of what is built once a key** (:class:`LRUCache`): the
  batched entry points keep their bound callables and launch plans a
  (grid, options, ...) key, and the CUDA graphs of the task list and the
  solves' corner are kept in LRU caches too (``cholesky.GraphCache``).
  The cache is LRU-bounded so a long-running process cycling through many
  distinct grids cannot grow it without limit.

A named cache reports to the telemetry registry
(``runtime/telemetry.py``): hits, misses, evictions, duplicate builds and
the build time of :meth:`LRUCache.get_or_create` under
``cache.*{cache=<name>}``, as the reference's do.  :meth:`LRUCache.stats`
has the same counts whether telemetry is enabled or not.

Port of the JAX package's ``core/batching.py``.
"""
from __future__ import annotations

import threading
import time
from collections import OrderedDict
from typing import Any, Callable, Hashable, Optional, Tuple

import torch

from repro_torch.runtime import telemetry

__all__ = ["LRUCache", "RungQueue", "RungQueueFull", "bucketed_batched_call", "pad_batch",
           "cut_batch", "next_pow2"]


class RungQueueFull(RuntimeError):
    """Raised by :meth:`RungQueue.push` when the queue is at ``maxlen``:
    the low-level half of serving admission control (a scheduler turns it
    into backpressure, or sheds the lowest-slack queued request)."""

    def __init__(self, depth: int, maxlen: int):
        super().__init__(f"rung queue full ({depth}/{maxlen})")
        self.depth = depth
        self.maxlen = maxlen


class LRUCache:
    """Small recency-ordered cache of what is built once a key.

    ``get`` refreshes recency; ``put`` evicts the least recently used
    entry beyond ``maxsize``.  Thread-safe: a torn ``move_to_end`` /
    ``popitem`` under concurrent mutation corrupts the OrderedDict, so a
    lock covers the bookkeeping.  The lock does not cover building: a miss
    in two threads may build the same entry twice, which wastes a build
    but stays correct (``put`` is last-writer-wins), and the wasted build
    is counted (``stats()["duplicate_traces"]``).

    A ``name`` (``batched_window``, ...) makes the cache visible to
    telemetry: hits, misses, evictions, duplicate builds and the build
    times of :meth:`get_or_create` are emitted under
    ``cache.*{cache=<name>}``.  An anonymous cache keeps its local
    :meth:`stats` only."""

    def __init__(self, maxsize: int = 64, name: Optional[str] = None):
        if maxsize <= 0:
            raise ValueError("maxsize must be positive")
        self.maxsize = maxsize
        self.name = name
        self._entries: "OrderedDict[Hashable, Any]" = OrderedDict()
        self._lock = threading.RLock()
        self._hits = 0
        self._misses = 0
        self._evictions = 0
        self._duplicate_traces = 0

    def _emit(self, record: Callable, metric: str, value: float = 1.0) -> None:
        """Report to telemetry (``record``: ``telemetry.inc`` or
        ``telemetry.observe``) when the cache is named and telemetry on."""
        if self.name is not None and telemetry.enabled():
            record(metric, value, cache=self.name)

    def get(self, key: Hashable) -> Optional[Any]:
        with self._lock:
            hit = key in self._entries
            if hit:
                self._entries.move_to_end(key)
                self._hits += 1
                value = self._entries[key]
            else:
                self._misses += 1
        self._emit(telemetry.inc, "cache.hit" if hit else "cache.miss")
        return value if hit else None

    def put(self, key: Hashable, value: Any) -> None:
        with self._lock:
            duplicate = key in self._entries
            if duplicate:
                # another thread raced through the same miss and built it
                self._duplicate_traces += 1
            self._entries[key] = value
            self._entries.move_to_end(key)
            evicted = 0
            while len(self._entries) > self.maxsize:
                self._entries.popitem(last=False)
                evicted += 1
            self._evictions += evicted
        if duplicate:
            self._emit(telemetry.inc, "cache.duplicate_trace")
        if evicted:
            self._emit(telemetry.inc, "cache.eviction", evicted)

    def get_or_create(self, key: Hashable, factory: Callable[[], Any]) -> Any:
        """``get``, or build by ``factory`` and ``put``, the build timed
        into ``cache.trace_seconds``; the factory runs outside the lock
        (see the class note on concurrent misses)."""
        value = LRUCache.get(self, key)
        if value is not None:
            return value
        t0 = time.perf_counter()
        value = factory()
        self._emit(telemetry.observe, "cache.trace_seconds", time.perf_counter() - t0)
        LRUCache.put(self, key, value)
        return value

    def stats(self) -> dict:
        """Counters since construction (hits, misses, evictions,
        duplicate_traces) and the current size and maxsize, read under the
        lock, so they agree with each other."""
        with self._lock:
            return {"hits": self._hits, "misses": self._misses,
                    "evictions": self._evictions,
                    "duplicate_traces": self._duplicate_traces,
                    "size": len(self._entries), "maxsize": self.maxsize}

    def clear(self) -> None:
        """Drop every entry; the counters are kept (clearing is not an
        eviction)."""
        with self._lock:
            self._entries.clear()

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    def __contains__(self, key: Hashable) -> bool:
        with self._lock:
            return key in self._entries

    def keys(self):
        """The current keys, least to most recently used: each is one
        built entry, so a test counts builds by diffing two snapshots."""
        with self._lock:
            return list(self._entries.keys())


class RungQueue:
    """Host-side FIFO of pending requests for one canonical rung.

    Items are appended in arrival order, each with the absolute
    ``flush_by`` time by which it must leave the queue.  Deliberately
    neither thread-safe nor clock-aware: the scheduler serializes access
    and injects every timestamp, which keeps the flush state machine
    replayable without threads or sleeps.  ``maxlen`` bounds the queue
    (``push`` beyond it raises :class:`RungQueueFull`); ``remove_if`` and
    ``evict_min`` are the shedding primitives."""

    def __init__(self, maxlen: Optional[int] = None):
        if maxlen is not None and maxlen < 1:
            raise ValueError(f"maxlen must be >= 1 or None, got {maxlen}")
        self.maxlen = maxlen
        self._items: list = []          # (item, flush_by) in arrival order

    @property
    def full(self) -> bool:
        return self.maxlen is not None and len(self._items) >= self.maxlen

    def push(self, item: Any, flush_by: float) -> None:
        if self.full:
            raise RungQueueFull(len(self._items), self.maxlen)
        self._items.append((item, flush_by))

    def earliest_flush_by(self) -> float:
        """The earliest ``flush_by`` pending (``inf`` when empty); arrival
        order does not order deadlines, hence the min over all items."""
        if not self._items:
            return float("inf")
        return min(fb for _, fb in self._items)

    def pop(self, n: Optional[int] = None) -> list:
        """Remove and return the ``n`` oldest items (all when None), in
        arrival order: one flushed batch."""
        if n is None or n >= len(self._items):
            taken, self._items = self._items, []
        else:
            taken, self._items = self._items[:n], self._items[n:]
        return [item for item, _ in taken]

    def remove_if(self, pred: Callable[[Any], bool]) -> list:
        """Remove and return every item with ``pred(item)`` true, arrival
        order kept among the removed and the kept."""
        taken = [(it, fb) for it, fb in self._items if pred(it)]
        if taken:
            self._items = [(it, fb) for it, fb in self._items if not pred(it)]
        return [item for item, _ in taken]

    def evict_min(self, keyfn: Callable[[Any], float]) -> Any:
        """Remove and return the item minimizing ``keyfn(item)``, the first
        in arrival order on ties; raises on an empty queue."""
        if not self._items:
            raise IndexError("evict_min on empty RungQueue")
        idx = min(range(len(self._items)), key=lambda i: keyfn(self._items[i][0]))
        item, _ = self._items.pop(idx)
        return item

    def __len__(self) -> int:
        return len(self._items)


def next_pow2(b: int) -> int:
    return 1 << max(b - 1, 0).bit_length()


def pad_batch(arrays: Tuple[torch.Tensor, ...], bucket: bool):
    """``(padded, b)``: ``arrays`` with their leading batch axis of ``b``
    padded to a power of two by repeating the last element (as they are
    with ``bucket=False`` or a batch already a power of two), and the batch
    size :func:`cut_batch` cuts results back to."""
    b = arrays[0].shape[0]
    nb = next_pow2(b) if bucket else b
    if nb == b:
        return tuple(arrays), b
    pad = nb - b
    return tuple(torch.cat([a, a[-1:].expand((pad,) + tuple(a.shape[1:]))])
                 for a in arrays), b


def cut_batch(outs, b: int):
    """Outputs of a padded batch (a tensor or a tuple of them, each with
    the batch axis leading) cut back to its first ``b`` elements; an
    output of ``b`` elements is returned as it is."""
    if torch.is_tensor(outs):
        return outs if outs.shape[0] == b else outs[:b]
    return tuple(o if o.shape[0] == b else o[:b] for o in outs)


def bucketed_batched_call(fn: Callable, arrays: Tuple[torch.Tensor, ...], bucket: bool):
    """Call ``fn(*arrays)`` on a batch padded to a power of two: the leading
    batch axis of every array is padded by repeating its last element, and
    every output (a tensor or a tuple of them, each with the batch axis
    leading) is cut back to the batch.  ``bucket=False`` calls ``fn`` as
    it is."""
    padded, b = pad_batch(arrays, bucket)
    return cut_batch(fn(*padded), b)
