"""The port's task-list backend against the JAX package, on the CPU:
``TileMatrix.from_sparse`` (slot map and tile buffer exactly the
reference's), ``core.tree_reduction`` and ``factorize_tasklist`` with the
Alg. 3 tree off and on, held to ``repro``'s ``factorize_tasklist`` with
``impl="ref"`` at rtol = atol = 2e-4 (float32 on both sides, different
summation orders) and to ``numpy.linalg.cholesky`` of the dense matrix;
then the quickstart twin at a small size."""
import importlib.util
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import TileGrid as JTileGrid
from repro.core import TileMatrix as JTileMatrix
from repro.core import factorize_tasklist as jfactorize_tasklist
from repro.core import tree_reduction as jtree
from repro.data import make_arrowhead as jmake_arrowhead
from repro.kernels import ref as jref
from repro_torch.core import (BandedCTSF, SolverOptions, TileGrid, TileMatrix,
                              chunked_tree_sum, factorize_tasklist, factorize_window,
                              should_use_tree, tree_combine)
from repro_torch.core.cholesky import tasklist_graphs
from repro_torch.data import make_arrowhead
from repro_torch.kernels import ops

TOL = dict(rtol=2e-4, atol=2e-4)
ROOT = Path(__file__).resolve().parents[1]
# (n, bandwidth, arrow, rho, seed, t): the matrices of test_structure_ordering.py
STRUCTURE_CASES = [(300, 20, 12, 0.7, 0, 16), (200, 24, 16, 0.7, 1, 16),
                   (150, 16, 8, 0.7, 2, 16), (120, 12, 6, 0.7, 3, 8),
                   (272, 16, 16, 0.0, 4, 16), (200, 24, 8, 0.7, 5, 16),
                   (240, 12, 0, 0.7, 6, 16)]
# (n, bandwidth, arrow, t, rho): test_cholesky.py's CASES, then its
# DEGENERATE_CASES (rho 0.6)
CHOLESKY_CASES = [(200, 24, 16, 16, 0.7), (200, 24, 16, 16, 0.0), (160, 8, 0, 16, 0.5),
                  (130, 40, 30, 16, 0.6), (96, 90, 0, 32, 0.4),
                  (16, 4, 0, 16, 0.6), (30, 6, 14, 16, 0.6), (64, 7, 0, 16, 0.6),
                  (48, 30, 12, 16, 0.6)]


def _pair(n, bw, ar, t, rho, seed=0):
    """The same matrix as a TileMatrix of each package."""
    A, st = make_arrowhead(n, bw, ar, rho=rho, seed=seed)
    jA, jst = jmake_arrowhead(n, bw, ar, rho=rho, seed=seed)
    return (JTileMatrix.from_sparse(jA, JTileGrid(jst, t=t)),
            TileMatrix.from_sparse(A, TileGrid(st, t=t), device="cpu"), A)


@pytest.mark.parametrize("case", STRUCTURE_CASES)
def test_tile_matrix_from_sparse_exact(case):
    """Filling the tiles straight from COO gives the reference's slot map
    and, bit for bit, the tile buffer it slices out of its dense padded
    matrix."""
    n, bw, ar, rho, seed, t = case
    jtm, tm, _ = _pair(n, bw, ar, t, rho, seed)
    assert tm.slot == jtm.slot
    assert tm.n_alloc == jtm.n_alloc and tm.nbytes() == jtm.nbytes()
    np.testing.assert_array_equal(tm.tiles.numpy(), np.asarray(jtm.tiles))
    np.testing.assert_array_equal(tm.symbolic.l_pattern, jtm.symbolic.l_pattern)
    np.testing.assert_array_equal(tm.to_dense(lower_only=False),
                                  jtm.to_dense(lower_only=False))


def test_tile_matrix_from_arrays():
    """The reference's buffer carried over gives the same matrix and factor;
    a buffer that does not fit the pattern is refused."""
    jtm, tm, _ = _pair(200, 24, 16, 16, 0.7)
    s = jtm.grid.structure
    cm = TileMatrix.from_arrays((s.n, s.bandwidth, s.arrow, 16), tm.symbolic, jtm.slot,
                                np.asarray(jtm.tiles), device="cpu")
    assert cm.grid == tm.grid and cm.slot == tm.slot
    torch.testing.assert_close(factorize_tasklist(cm), factorize_tasklist(tm), rtol=0, atol=0)
    with pytest.raises(ValueError, match="pattern"):
        TileMatrix.from_arrays(tm.grid, tm.symbolic, jtm.slot, np.asarray(jtm.tiles)[1:],
                               device="cpu")


def test_tree_reduction_matches_reference(monkeypatch):
    rng = np.random.default_rng(0)
    for n, w in [(0, 8), (1, 8), (15, 8), (16, 8), (3, 1), (7, 2)]:
        assert should_use_tree(n, w) == jtree.should_use_tree(n, w)
    for k, chunks in [(16, 8), (17, 4), (5, 8), (9, 3), (1, 8)]:
        terms = rng.standard_normal((k, 2, 8, 8)).astype(np.float32)
        got = chunked_tree_sum(torch.from_numpy(terms), chunks)
        want = jtree.chunked_tree_sum(jnp.asarray(terms), chunks, add=jref.geadd_ref)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
        np.testing.assert_allclose(got.numpy(), terms.sum(0), rtol=1e-5, atol=1e-5)
    for c in (1, 2, 5, 7, 8):
        leaves = rng.standard_normal((c, 3, 8, 8)).astype(np.float32)
        got = tree_combine(torch.from_numpy(leaves))
        want = jtree.tree_combine(jnp.asarray(leaves), add=jref.geadd_ref)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    calls = []
    geadd = ops.geadd
    monkeypatch.setattr(ops, "geadd", lambda a, b, **k: calls.append(a.shape[0]) or geadd(a, b, **k))
    tree_combine(torch.zeros(7, 8, 8))
    assert calls == [3, 2, 1]


@pytest.mark.parametrize("n,bw,ar,t,rho", CHOLESKY_CASES)
@pytest.mark.parametrize("tree", [False, True])
def test_factorize_tasklist_matches_reference(n, bw, ar, t, rho, tree):
    jtm, tm, _ = _pair(n, bw, ar, t, rho)
    captures, kept = tasklist_graphs.captures, len(tasklist_graphs)
    got = factorize_tasklist(tm, tree_reduction=tree, tree_workers=4)
    # on the CPU the tasks run from the host: no CUDA graph is captured
    assert (tasklist_graphs.captures, len(tasklist_graphs)) == (captures, kept)
    want = jfactorize_tasklist(jtm, impl="ref", tree_reduction=tree, tree_workers=4)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_array_equal(tm.tiles.numpy(), np.asarray(jtm.tiles))   # input kept
    dense = tm.to_dense(lower_only=False).astype(np.float64)
    L = np.linalg.cholesky(dense)
    np.testing.assert_allclose(np.tril(tm.to_dense(got)), L, **TOL)
    # the window backend's factor, the reference's backend agreement
    fw = factorize_window(BandedCTSF.from_sparse(make_arrowhead(n, bw, ar, rho=rho, seed=0)[0],
                                                 tm.grid, device="cpu"))
    assert np.abs(np.tril(tm.to_dense(got)) - fw.ctsf.to_dense()).max() <= 5e-4


def test_factorize_tasklist_dispatch_on_the_cpu():
    """On CPU tensors the plain versions run; impl="cuda" is refused."""
    _, tm, _ = _pair(130, 40, 30, 16, 0.6)
    torch.testing.assert_close(factorize_tasklist(tm),
                               factorize_tasklist(tm, options=SolverOptions(impl="ref")),
                               rtol=0, atol=0)
    with pytest.raises(ValueError, match="CUDA"):
        factorize_tasklist(tm, options=SolverOptions(impl="cuda"))


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("workers", [0, 4])
def test_chip_smoke_derives_tasklist_launches(monkeypatch, workers):
    """chip_smoke.py's launch counts of the task list, derived from the
    symbolic task list and should_use_tree, are the calls factorize_tasklist
    makes: one per task, or a geadd per tree level for a long chain."""
    _, tm, _ = _pair(200, 24, 16, 16, 0.7)
    calls = dict(potrf=0, trsm=0, syrk=0, gemm=0, geadd=0)
    for name in calls:
        def counted(*a, _f=getattr(ops, name), _n=name, **k):
            calls[_n] += 1
            return _f(*a, **k)
        monkeypatch.setattr(ops, name, counted)
    factorize_tasklist(tm, tree_reduction=bool(workers), tree_workers=workers or 8)
    want = _chip_smoke().tasklist_launches(tm, workers)
    assert calls == want
    assert (want["geadd"] > 0) == bool(workers)


def test_chip_smoke_takes_geadd_operands_from_the_tree(monkeypatch):
    """The operands chip_smoke.py holds geadd to on the main path are the
    ones the task list's first tree gives it: its first geadd call."""
    _, tm, _ = _pair(200, 24, 16, 16, 0.7)
    seen = []
    geadd = ops.geadd
    monkeypatch.setattr(ops, "geadd", lambda a, b, **k: seen.append((a, b)) or geadd(a, b, **k))
    L = factorize_tasklist(tm, tree_reduction=True, tree_workers=4)
    a, b, _ = _chip_smoke().first_tree_operands(torch, tm, L, 4)
    assert a.shape == seen[0][0].shape == (2, 16, 16) and a.stride() == seen[0][0].stride()
    torch.testing.assert_close(a, seen[0][0], rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(b, seen[0][1], rtol=1e-6, atol=1e-6)
    assert min(a.abs().max(), b.abs().max()) > 0


def test_chip_smoke_holds_gemm_and_syrk_on_the_largest_band_products():
    """chip_smoke.py holds gemm and syrk on the band task with the largest
    product, a real task of the list whose product is not zero."""
    from repro_torch.core import TaskType
    _, tm, _ = _pair(200, 24, 16, 16, 0.7)
    L = factorize_tasklist(tm)
    ndt = tm.grid.n_diag_tiles
    for ty in (TaskType.GEMM, TaskType.SYRK):
        x = _chip_smoke().largest_band_task(torch, tm, L, ty)
        row = x.m if ty == TaskType.GEMM else x.k
        assert x in tm.symbolic.tasks and x.type == ty and row < ndt
        prod = L[tm.slot[(row, x.n)]] @ L[tm.slot[(x.k, x.n)]].mT
        assert prod.abs().max() > 0.01


def test_quickstart_twin_on_the_cpu(capsys):
    """The quickstart twin runs every step at a small size on the CPU, and
    its task-list factor agrees with the window factor."""
    from repro_torch.quickstart import main
    out = main(["--device", "cpu"], n=256, bandwidth=12, arrow=8, t=16)
    printed = capsys.readouterr().out
    for step in ("ordering:", "symbolic:", "window backend:", "tasklist backend agrees",
                 "solve:", "logdet:", "sample:", "marginal variances"):
        assert step in printed
    assert out["device"] == "cpu" and out["tasklist_agreement"] <= 5e-4
    assert out["solve_residual"] <= 1e-3 and np.isfinite(out["logdet"])
    assert len(out["marginal_variances"]) == 3 and min(out["marginal_variances"]) > 0
