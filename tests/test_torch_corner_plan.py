"""The solves' corner as the card runs it, held on the CPU.

``csrc/solve_panel.cu`` cannot run here, so this file keeps a model of its
arithmetic: the panel in chunks of columns (``kernels/trsm.py::
solve_panel_chunk``), each chunk padded with zero columns and transposed, the
pivots' reciprocals computed once, and ``tile.cuh::solve_few_rows``'s panels
of 16 rows (a pass a column, then the update of the rows a panel feeds, each
element's products in order).  The model is held to ``repro``'s
``solve_panel_pallas`` in interpret mode and to ``ref.solve_panel_ref``, and
every chunk width to the same bits; the card tests
(``tests/test_torch_gpu.py``) hold the kernel itself.  Then the corner
graph of ``core/solve.py``: its key (the shapes and the device, never the
factor or ``impl``), the graph cache's bookkeeping with a stand-in capture,
and that the CPU solve captures nothing.
"""
from collections import Counter

import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.trsm import solve_panel_pallas
from repro_torch.core import (BandedCTSF, SolverOptions, TileGrid, factorize_window,
                              marginal_variances, sample_gmrf_many, solve_many)
from repro_torch.core.cholesky import GraphCache
from repro_torch.core.solve import (CORNER_GRAPH_CACHE, _corner_on_graph, corner_graph_key,
                                    corner_graphs)
from repro_torch.data import make_arrowhead
from repro_torch.kernels import ref
from repro_torch.kernels.trsm import PANEL_CHUNKS, solve_panel_chunk

TILES = [8, 16, 32, 64]
KS = [1, 7, 8, 9, 32, 33, 64]
TOL = dict(rtol=2e-4, atol=2e-4)
SMS = 132   # an H100's SMs: the card's `at_once` for the chunk plan


def _fma(a, b, c):
    """fmaf(a, b, c) in float32: a * b is exact in float64."""
    return (a.astype(np.float64) * b + c).astype(np.float32)


def _solve_rows(X, L, dinv, back):
    """``tile.cuh::solve_few_rows`` on the rows of X (one right-hand-side
    column each): panels of NB = min(t, 16) columns, left to right (forward,
    ``X L^T = A``) or right to left (``X L = A``); a row's pass multiplies
    by the pivot's reciprocal and updates the panel's later (earlier)
    entries; then every element the panel feeds takes the panel's NB
    products in order."""
    t = L.shape[0]
    nb = min(t, 16)
    for s in range(0, t, nb):
        j0 = t - nb - s if back else s
        for u in range(nb):
            c = nb - 1 - u if back else u
            X[:, j0 + c] = X[:, j0 + c] * dinv[j0 + c]
            for m in (range(c) if back else range(c + 1, nb)):
                lv = L[j0 + c, j0 + m] if back else L[j0 + m, j0 + c]
                X[:, j0 + m] = _fma(-X[:, j0 + c], np.float32(lv), X[:, j0 + m])
        fed = range(0, j0) if back else range(j0 + nb, t)
        for i in fed:
            acc = X[:, i].copy()
            for c in range(nb):
                lv = L[j0 + c, i] if back else L[i, j0 + c]
                acc = _fma(-X[:, j0 + c], np.float32(lv), acc)
            X[:, i] = acc
    return X


def emulate_solve_panel(l, b, trans, chunk):
    """The kernel's result for one (t, k) panel ``b`` in chunks of ``chunk``
    columns, each a block: the chunk transposed (a row a column), zero
    columns past k, solved by :func:`_solve_rows`, the real columns
    stored."""
    t, k = b.shape
    _, chunks = solve_panel_chunk(1, k, SMS, chunk)
    dinv = (np.float32(1.0) / np.diagonal(l)).astype(np.float32)
    out = np.empty_like(b)
    for q in range(chunks):
        c0 = q * chunk
        X = np.zeros((chunk, t), np.float32)
        X[:min(chunk, k - c0)] = b[:, c0:c0 + chunk].T
        _solve_rows(X, l, dinv, trans)
        out[:, c0:c0 + chunk] = X[:min(chunk, k - c0)].T
    return out


def _lower(rng, t):
    return (np.tril(rng.standard_normal((t, t))) + t * np.eye(t)).astype(np.float32)


@pytest.mark.parametrize("t", TILES)
@pytest.mark.parametrize("k", KS)
@pytest.mark.parametrize("trans", [False, True])
def test_solve_panel_model_matches_reference(t, k, trans):
    """The modelled kernel at every chunk width against repro's Pallas
    kernel in interpret mode, its plain version and the port's, and every
    width the same bits."""
    rng = np.random.default_rng(10 * t + k)
    l, b = _lower(rng, t), rng.standard_normal((t, k)).astype(np.float32)
    pallas = np.asarray(solve_panel_pallas(l, b[None], trans=trans, interpret=True))[0]
    want = np.asarray(jref.solve_panel_ref(l, b, trans=trans))
    port = ref.solve_panel_ref(torch.from_numpy(l), torch.from_numpy(b), trans=trans).numpy()
    first = None
    for chunk in PANEL_CHUNKS:
        got = emulate_solve_panel(l, b, trans, chunk)
        for other in (pallas, want, port):
            np.testing.assert_allclose(got, other, **TOL)
        first = got if first is None else first
        np.testing.assert_array_equal(got, first)


@pytest.mark.parametrize("nb,k", [(1, 1), (1, 32), (1, 132), (1, 133), (1, 1056), (1, 4096),
                                  (3, 44), (3, 45), (200, 1), (0, 5)])
def test_solve_panel_chunk_plan(nb, k):
    """The default chunk is one column while a block a column fits on the
    card at once, else the widest of PANEL_CHUNKS; the chunks cover every
    column once, the last one padded; a given chunk is kept."""
    chunk, chunks = solve_panel_chunk(nb, k, SMS)
    assert chunk in PANEL_CHUNKS and chunks == -(-k // chunk)
    assert chunks * chunk >= k > (chunks - 1) * chunk or k == 0
    assert chunk == (1 if nb * k <= SMS else PANEL_CHUNKS[-1])
    for w in PANEL_CHUNKS:
        assert solve_panel_chunk(nb, k, SMS, w) == (w, -(-k // w))


@pytest.mark.parametrize("chunk", [0, 3, 16])
def test_solve_panel_chunk_refuses_a_width_not_built(chunk):
    with pytest.raises(ValueError, match="chunk"):
        solve_panel_chunk(1, 32, SMS, chunk)


def _ctsf(t=16, scale=1.0, n=120, bw=20, ar=24, seed=0):
    A, st = make_arrowhead(n, bw, ar, rho=0.6, seed=seed)
    return BandedCTSF.from_sparse(scale * A, TileGrid(st, t=t), device="cpu")


def test_corner_graph_key_is_the_shape_and_device():
    """Two factors of one grid (another θ step, other values) share a key;
    the key holds shapes, the direction and the device only: nothing of the
    factor's values or identity, and no impl."""
    f1, f2 = factorize_window(_ctsf()), factorize_window(_ctsf(scale=1.5))
    c1, c2 = f1.ctsf.C, f2.ctsf.C
    nat, t = c1.shape[0], c1.shape[-1]
    panel = torch.zeros((nat, t, 5))
    assert not torch.equal(c1, c2)
    key = corner_graph_key(c1, panel, False)
    assert key == corner_graph_key(c2, panel.clone(), False) == (t, nat, 5, False, "cpu")
    assert all(isinstance(x, (int, bool, str)) for x in key)


@pytest.mark.parametrize("what", ["t", "nat", "k", "direction"])
def test_corner_graph_key_tells_what_changes_the_graph(what):
    """Another tile size, corner, panel width or direction is another key."""
    C, panel = torch.zeros((2, 2, 16, 16)), torch.zeros((2, 16, 4))
    base = corner_graph_key(C, panel, False)
    other = {"t": lambda: corner_graph_key(torch.zeros((2, 2, 8, 8)), torch.zeros((2, 8, 4)),
                                           False),
             "nat": lambda: corner_graph_key(C[:1, :1], panel[:1], False),
             "k": lambda: corner_graph_key(C, panel[..., :3], False),
             "direction": lambda: corner_graph_key(C, panel, True)}[what]()
    assert other != base


def test_graph_cache_keeps_and_counts():
    """The generalised cache's bookkeeping, with stand-in graphs: one
    capture a key, the least recently used out first past max_entries, and
    the launches each capture recorded and each replay made."""
    class Graph:
        replays = 0

        def replay(self):
            Graph.replays += 1

    class Entry:
        def __init__(self, n):
            self.graph, self.launches = Graph(), Counter(solve_panel_cuda=n)

    cache = GraphCache(2)
    assert cache.find("a") is None
    a = cache.add("a", Entry(4))
    b = cache.add("b", Entry(1))
    assert cache.find("a") is a             # "a" is now the most recently used
    cache.replay(a)
    cache.replay(b)                         # a replay does not count as a use
    cache.add("c", Entry(2))                # "a" was used after "b": "b" goes
    assert cache.find("b") is None and cache.find("a") is a and len(cache) == 2
    assert cache.captures == 3 and cache.recorded == Counter(solve_panel_cuda=7)
    assert cache.replayed == Counter(solve_panel_cuda=5) and Graph.replays == 2
    cache.clear()
    assert len(cache) == 0 and cache.captures == 3


def test_cpu_solves_capture_nothing():
    """On the CPU (and with impl="ref") the corner runs eagerly: no solve
    entry point captures or replays a graph."""
    m = _ctsf()
    f = factorize_window(m)
    g = m.grid
    captures, kept = corner_graphs.captures, len(corner_graphs)
    replayed = sum(corner_graphs.replayed.values())
    B = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (g.padded_n, 3)).astype(np.float32))
    for opts in (None, SolverOptions(impl="ref")):
        solve_many(f, B, options=opts)
        sample_gmrf_many(f, num=3, z=B, options=opts)
        marginal_variances(f, [0, g.structure.n - 1],
                           options=SolverOptions(method="panels",
                                                 impl=opts.impl if opts else None))
        assert not _corner_on_graph(f.ctsf.C, B, None if opts is None else opts.impl)
    assert (corner_graphs.captures, len(corner_graphs)) == (captures, kept)
    assert sum(corner_graphs.replayed.values()) == replayed
    assert corner_graphs.max_entries == CORNER_GRAPH_CACHE
