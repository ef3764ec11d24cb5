"""The port's ``core/batching.py`` against the JAX package's, on the CPU:
one sequence of operations through both ``LRUCache``s and both
``RungQueue``s, with equal ``stats()``, ``keys()`` and results after each
step; ``next_pow2`` and ``bucketed_batched_call`` on the same inputs
(numpy from a seed), the padded call's outputs equal to the reference's;
and the port's CUDA-graph caches as ``LRUCache``s."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import batching as jbatching
from repro_torch.core import batching
from repro_torch.core.cholesky import GraphCache, tasklist_graphs
from repro_torch.core.solve import corner_graphs

# (operation, key, value): the sequence both caches are put through
LRU_STEPS = [("get", "a", None), ("put", "a", 1), ("put", "b", 2), ("get", "a", None),
             ("put", "c", 3), ("get", "b", None), ("put", "a", 10), ("create", "d", 4),
             ("create", "a", 99), ("get", "c", None), ("put", "e", 5), ("create", "b", 6),
             ("clear", None, None), ("get", "a", None), ("create", "f", 7)]


def _apply(cache, op, key, value):
    if op == "get":
        return cache.get(key)
    if op == "put":
        return cache.put(key, value)
    if op == "create":
        return cache.get_or_create(key, lambda: value)
    return cache.clear()


@pytest.mark.parametrize("maxsize", [1, 2, 3, 64])
def test_lru_cache_matches_reference(maxsize):
    port = batching.LRUCache(maxsize=maxsize, name="batched_window")
    ref = jbatching.LRUCache(maxsize=maxsize, name="batched_window")
    for step in LRU_STEPS:
        assert _apply(port, *step) == _apply(ref, *step), step
        assert port.stats() == ref.stats(), step
        assert port.keys() == ref.keys(), step
        assert len(port) == len(ref) and all((k in port) == (k in ref) for k in "abcdef")
    assert port.name == ref.name == "batched_window"


def test_lru_cache_refuses_what_the_reference_refuses():
    for cls in (batching.LRUCache, jbatching.LRUCache):
        with pytest.raises(ValueError, match="maxsize"):
            cls(maxsize=0)


def test_lru_cache_counts_a_duplicate_build():
    """Two threads through one miss build the key twice; the second put is
    counted, as in the reference."""
    for cls in (batching.LRUCache, jbatching.LRUCache):
        cache = cls(maxsize=4)
        assert cache.get("k") is None
        cache.put("k", 1)
        cache.put("k", 2)
        assert cache.stats()["duplicate_traces"] == 1 and cache.get("k") == 2


def _queue_steps(q):
    """One sequence of RungQueue operations; returns what each step gave."""
    out = []
    for i, fb in enumerate([5.0, 3.0, 9.0, 1.0]):
        q.push(f"r{i}", fb)
    out.append(("len", len(q), q.full, q.earliest_flush_by()))
    try:
        q.push("r4", 2.0)
        out.append(("push", "accepted"))
    except RuntimeError as err:
        out.append(("push", type(err).__name__, err.depth, err.maxlen))
    out.append(("remove_if", q.remove_if(lambda it: it in ("r1", "r3"))))
    out.append(("evict_min", q.evict_min(lambda it: -int(it[1:]))))
    q.push("r5", 7.0)
    out.append(("pop", q.pop(1), len(q)))
    out.append(("pop_all", q.pop(), len(q), q.earliest_flush_by()))
    try:
        q.evict_min(len)
    except IndexError as err:
        out.append(("evict_empty", str(err)))
    return out


@pytest.mark.parametrize("maxlen", [None, 4, 10])
def test_rung_queue_matches_reference(maxlen):
    assert _queue_steps(batching.RungQueue(maxlen)) == _queue_steps(jbatching.RungQueue(maxlen))


def test_rung_queue_full_and_refusals():
    for mod in (batching, jbatching):
        q = mod.RungQueue(maxlen=1)
        q.push("a", 1.0)
        with pytest.raises(mod.RungQueueFull, match=r"rung queue full \(1/1\)"):
            q.push("b", 2.0)
        with pytest.raises(ValueError, match="maxlen"):
            mod.RungQueue(maxlen=0)
    assert issubclass(batching.RungQueueFull, RuntimeError)


@pytest.mark.parametrize("b", [0, 1, 2, 3, 5, 8, 9, 1000])
def test_next_pow2_matches_reference(b):
    assert batching.next_pow2(b) == jbatching.next_pow2(b)


@pytest.mark.parametrize("b", [1, 3, 5, 8])
@pytest.mark.parametrize("bucket", [False, True])
def test_bucketed_batched_call_matches_reference(b, bucket):
    rng = np.random.default_rng(b)
    x = rng.standard_normal((b, 3, 2)).astype(np.float32)
    y = rng.standard_normal((b, 4)).astype(np.float32)
    seen, jseen = [], []

    def fn(p, q):
        seen.append(p.shape[0])
        return p * 2.0, q.sum(dim=-1), p[:, 0] - q[:, :2]

    def jfn(p, q):
        jseen.append(p.shape[0])
        return p * 2.0, q.sum(axis=-1), p[:, 0] - q[:, :2]

    got = batching.bucketed_batched_call(fn, (torch.from_numpy(x), torch.from_numpy(y)), bucket)
    want = jbatching.bucketed_batched_call(jfn, (jnp.asarray(x), jnp.asarray(y)), bucket)
    assert seen == jseen == [batching.next_pow2(b) if bucket else b]
    for g, w in zip(got, want):
        assert g.shape[0] == b
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_bucketed_batched_call_pads_with_the_last_element():
    x = torch.arange(3.0)[:, None]
    seen = []
    batching.bucketed_batched_call(lambda p: (seen.append(p.clone()), p)[1:], (x,), True)
    assert torch.equal(seen[0][:, 0], torch.tensor([0.0, 1.0, 2.0, 2.0]))


def test_graph_caches_are_lru_caches():
    """The CUDA-graph caches of the task list and the solves' corner are
    ``LRUCache``s: ``find`` counts a hit or a miss, ``add`` a capture, and
    evictions show in ``stats()``."""
    assert isinstance(tasklist_graphs, batching.LRUCache)
    assert isinstance(corner_graphs, batching.LRUCache)
    assert (tasklist_graphs.name, corner_graphs.name) == ("tasklist_graphs", "corner_graphs")

    class Entry:
        launches = {}

    cache = GraphCache(2, name="test")
    assert cache.find("a") is None
    for key in "abc":
        cache.add(key, Entry())
    assert cache.find("a") is None and cache.find("c") is not None
    assert cache.stats() == {"hits": 1, "misses": 2, "evictions": 1, "duplicate_traces": 0,
                             "size": 2, "maxsize": 2}
    assert cache.captures == 3 and cache.max_entries == 2
