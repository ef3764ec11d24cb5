"""The split of the task list's GEMM/SYRK kernel and the cache key of the
task list's CUDA graphs, on the CPU.

``csrc/gemm.cu`` splits each output tile into ``split`` pieces of ``sub x
sub`` (``kernels/gemm.py::gemm_split``), a block each, and gives each
thread of a block a ``rows x cols`` set of the piece's elements (its
``Piece``).  :class:`PieceModel` below is a model of that layout, read off
the kernel: every element of every tile must be some thread's, once, at
every split.  A plain emulation of the modelled kernel (each element
summed over k in order in float32 by its thread, then subtracted from C) is
held to ``repro``'s ``gemm_ref``/``syrk_ref`` at rtol = atol = 2e-4, and
every split to the same bits; the gpu-marked tests hold the kernel itself.
``core/cholesky.py::tasklist_graph_key`` keys a captured factorization on
the sparsity pattern, ``t``, the device and the tree workers, never on the
values.
"""
import dataclasses
import math

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from repro.kernels import ref as jref
from repro_torch.core import TileGrid, TileMatrix
from repro_torch.core.cholesky import tasklist_graph_key
from repro_torch.data import make_arrowhead
from repro_torch.kernels.gemm import GEMM_SPLITS, gemm_split

TOL = dict(rtol=2e-4, atol=2e-4)
CASES = [(t, s) for t in sorted(GEMM_SPLITS) for s in GEMM_SPLITS[t]]
# a piece's (rows, columns) a thread, by its edge: csrc/gemm.cu's Piece<S>::TR, TC
PIECE_LAYOUT = {64: (4, 4), 32: (2, 4), 16: (1, 2), 8: (1, 1)}


@dataclasses.dataclass(frozen=True)
class PieceModel:
    """A model of ``csrc/gemm.cu``'s launch on tiles of ``t x t``: ``split``
    blocks a tile, block ``blockIdx.y`` the ``sub x sub`` piece at ``(r0,
    c0)`` of :meth:`pieces`; thread ``(ty, tx) = (tid // (sub // cols), tid
    % (sub // cols))`` holds the ``rows x cols`` elements of
    :meth:`elements`."""

    t: int
    split: int

    @property
    def sub(self) -> int:
        return gemm_split(self.t, self.split)[1]

    @property
    def rows(self) -> int:
        return PIECE_LAYOUT[self.sub][0]

    @property
    def cols(self) -> int:
        return PIECE_LAYOUT[self.sub][1]

    @property
    def threads(self) -> int:
        return (self.sub // self.rows) * (self.sub // self.cols)

    def pieces(self):
        per = self.t // self.sub
        for p in range(self.split):
            yield p // per * self.sub, p % per * self.sub

    def elements(self, tid):
        nty, ntx = self.sub // self.rows, self.sub // self.cols
        ty, tx = divmod(tid, ntx)
        for r in range(self.rows):
            for s in range(self.cols):
                yield ty + nty * r, tx + ntx * s


@pytest.mark.parametrize("t,split", CASES)
def test_gemm_plan_covers_every_element_once(t, split):
    """Every (row, column) of a tile belongs to exactly one thread of one
    piece; the pieces tile the output without overlap."""
    plan = PieceModel(t, split)
    assert plan.sub * plan.sub * split == t * t
    seen = np.zeros((t, t), dtype=np.int64)
    pieces = list(plan.pieces())
    assert len(pieces) == split == len(set(pieces))
    for r0, c0 in pieces:
        for tid in range(plan.threads):
            elems = list(plan.elements(tid))
            assert len(elems) == plan.rows * plan.cols
            for i, j in elems:
                assert 0 <= i < plan.sub and 0 <= j < plan.sub
                seen[r0 + i, c0 + j] += 1
    assert (seen == 1).all()


@pytest.mark.parametrize("t,split", CASES)
def test_gemm_plan_block_shape(t, split):
    """At least four warps a block, except the 8 x 8 piece (two); the lanes
    of a quarter warp hold 8 distinct columns (rows of B) and one row."""
    plan = PieceModel(t, split)
    assert plan.threads % 32 == 0 and plan.threads <= 1024
    assert plan.threads >= (64 if plan.sub == 8 else 128)
    ntx = plan.sub // plan.cols
    assert ntx >= 8
    for q in range(0, plan.threads, 8):
        rows, cols = zip(*(next(plan.elements(tid)) for tid in range(q, q + 8)))
        assert len(set(rows)) == 1 and len(set(cols)) == 8


@pytest.mark.parametrize("t", sorted(GEMM_SPLITS))
def test_gemm_plan_default_split(t):
    """The default is the largest split, pieces of 8 x 8; an explicit split
    gives its own piece size."""
    assert gemm_split(t) == (GEMM_SPLITS[t][-1], 8) == ((t // 8) ** 2, 8)
    for split in GEMM_SPLITS[t]:
        assert gemm_split(t, split) == (split, t // math.isqrt(split))


@pytest.mark.parametrize("t,split", [(64, 2), (64, 256), (32, 64), (16, 16), (8, 4), (12, 1)])
def test_gemm_plan_refuses(t, split):
    with pytest.raises(ValueError):
        gemm_split(t, split)


def _emulate(plan, c, a, b):
    """The planned kernel's arithmetic in float32: each thread's elements of
    each piece summed over k = 0..t-1 in order, then subtracted from C."""
    out = np.empty_like(c)
    for q in range(c.shape[0]):
        for r0, c0 in plan.pieces():
            for tid in range(plan.threads):
                ij = list(plan.elements(tid))
                rows = np.array([r0 + i for i, _ in ij])
                cols = np.array([c0 + j for _, j in ij])
                acc = np.zeros(len(ij), np.float32)
                for k in range(plan.t):
                    acc = (acc + a[q, rows, k] * b[q, cols, k]).astype(np.float32)
                out[q, rows, cols] = c[q, rows, cols] - acc
    return out


@pytest.mark.parametrize("t", sorted(GEMM_SPLITS))
def test_gemm_plan_emulation_matches_reference(t):
    """The emulated kernel against repro's gemm_ref and syrk_ref, and every
    split bit for bit the same."""
    rng = np.random.default_rng(t)
    c, a, b = (rng.standard_normal((2, t, t)).astype(np.float32) for _ in range(3))
    want_gemm = np.stack([np.asarray(jref.gemm_ref(c[q], a[q], b[q])) for q in range(2)])
    want_syrk = np.stack([np.asarray(jref.syrk_ref(c[q], a[q])) for q in range(2)])
    first = {}
    for split in GEMM_SPLITS[t]:
        plan = PieceModel(t, split)
        for name, bb, want in (("gemm", b, want_gemm), ("syrk", a, want_syrk)):
            got = _emulate(plan, c, a, bb)
            np.testing.assert_allclose(got, want, **TOL)
            first.setdefault(name, got)
            np.testing.assert_array_equal(got, first[name])


def _tile_matrix(t=16, scale=1.0, shift=0.0, n=200, bw=24, ar=16, seed=0):
    A, st = make_arrowhead(n, bw, ar, rho=0.6, seed=seed)
    A = (scale * A + shift * sp.identity(A.shape[0])).tocsr()
    return TileMatrix.from_sparse(A, TileGrid(st, t=t), device="cpu")


def test_graph_key_ignores_the_values():
    """Two TileMatrix of one pattern with other values share a key, computed
    once a TileMatrix."""
    tm1, tm2 = _tile_matrix(), _tile_matrix(scale=1.5, shift=0.25)
    assert not torch.equal(tm1.tiles, tm2.tiles)
    assert tasklist_graph_key(tm1, 0) == tasklist_graph_key(tm2, 0)
    assert tm1.pattern_key == tm2.pattern_key is not None
    tm1.pattern_key = "cached"
    assert tasklist_graph_key(tm1, 0)[0] == "cached"


@pytest.mark.parametrize("what", ["pattern", "t", "workers"])
def test_graph_key_tells_what_changes_the_graph(what):
    """Another pattern, tile size or worker count is another key."""
    tm = _tile_matrix()
    base = tasklist_graph_key(tm, 0)
    other = {"pattern": lambda: tasklist_graph_key(_tile_matrix(bw=12), 0),
             "t": lambda: tasklist_graph_key(_tile_matrix(t=8), 0),
             "workers": lambda: tasklist_graph_key(tm, 4)}[what]()
    assert other != base


def test_graph_cache_keeps_and_counts(monkeypatch):
    """The cache's bookkeeping, with a stand-in for the capture: one capture
    a key (a new TileMatrix of the pattern included), the least recently
    used out first, and the launches each capture recorded and each replay
    made, by kernel wrapper; nothing written into the wrappers' counts."""
    from collections import Counter

    from repro_torch.core import cholesky
    from repro_torch.kernels.gemm import gemm_cuda

    class Graph:
        def replay(self):
            pass

    launches = Counter(gemm_cuda=5, potrf_cuda=2)
    monkeypatch.setattr(cholesky, "_capture_tasklist", lambda tm, workers: cholesky._TasklistGraph(
        Graph(), tm.tiles, tm.tiles, [], launches))
    graphs, before = cholesky.TasklistGraphs(2), gemm_cuda.launches
    tm1, tm2 = _tile_matrix(), _tile_matrix(scale=1.5, shift=0.25)
    assert graphs.get(tm1, 0) is graphs.get(tm2, 0)
    graphs.replay(graphs.get(tm2, 0))
    graphs.replay(graphs.get(tm1, 0))
    assert graphs.captures == 1 and graphs.recorded == launches
    assert graphs.replayed == Counter(gemm_cuda=10, potrf_cuda=4)
    graphs.get(tm1, 4)
    graphs.get(tm1, 0)
    graphs.get(tm1, 8)                  # workers 4 goes: least recently used
    assert (graphs.captures, len(graphs)) == (3, 2)
    graphs.get(tm1, 0)
    assert graphs.captures == 3
    graphs.get(tm1, 4)
    assert graphs.captures == 4 and gemm_cuda.launches == before
