"""The port's solve slice against the JAX package, on the CPU: the
forward / backward / full solves, GMRF sampling and both marginal-variance
methods.

The reference factor (``repro``'s ``factorize_window`` with ``impl="ref"``)
is carried into the port with ``CholeskyFactor.from_arrays``, so each
comparison measures the solve alone: rtol = atol = 2e-4, float32 on both
sides in different summation orders.  The whole chain from each package's
own ``from_sparse`` and ``factorize_window`` is held to ``numpy.linalg``
on the dense matrix at the reference tests' tolerance (rtol 2e-3, atol
2e-4, test_solve_batched.py)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as J
from repro.data import make_arrowhead as jmake_arrowhead
from repro_torch.core import (BandedCTSF, CholeskyFactor, SolverOptions, TileGrid,
                              backward_solve, backward_solve_many, factorize_window,
                              forward_solve, forward_solve_many, marginal_variances,
                              sample_gmrf, sample_gmrf_many, solve, solve_many)
from repro_torch.data import make_arrowhead
from repro_torch.kernels.band_solve import band_backward_sweep_cuda, band_forward_sweep_cuda
from repro_torch.kernels.trsm import solve_panel_cuda

TOL = dict(rtol=2e-4, atol=2e-4)
JREF = J.SolverOptions(impl="ref")
# (n, bandwidth, arrow, t): single tile, bt=0 with an arrow, nat=0, thick
# arrow and wide band, a deep band of small tiles, t = 32 and 64 (the
# GRIDS of test_torch_cholesky.py), and the quickstart's own size
GRIDS = [(16, 4, 0, 16), (30, 6, 14, 16), (160, 8, 0, 16), (130, 40, 30, 16),
         (96, 40, 16, 8), (200, 40, 40, 32), (300, 70, 70, 64)]
QUICKSTART = (2048, 48, 32, 32)
# the parity of the panel solves: bt = 0 with an arrow, nat = 0, a deep
# band of small tiles, t = 64 (test_solve_chain_matches_dense runs all GRIDS)
PANEL_GRIDS = [(30, 6, 14, 16), (160, 8, 0, 16), (96, 40, 16, 8), (300, 70, 70, 64)]


def _factors(n, bw, ar, t, seed=0):
    """The reference factor and the same arrays in the port."""
    A, st = jmake_arrowhead(n, bw, ar, rho=0.6, seed=seed)
    grid = J.TileGrid(st, t=t)
    jf = J.factorize_window(J.BandedCTSF.from_sparse(A, grid), options=JREF)
    s = grid.structure
    tf = CholeskyFactor.from_arrays((s.n, s.bandwidth, s.arrow, t),
                                    *(np.asarray(x) for x in jf.ctsf.arrays()), device="cpu")
    return jf, tf, grid


def _rhs(grid, k, seed=1):
    """A (padded_n, k) panel, zero in the band padding."""
    B = np.random.default_rng(seed).standard_normal((grid.padded_n, k)).astype(np.float32)
    s = grid.structure
    B[s.n_diag:grid.n_diag_tiles * grid.t] = 0.0
    B[grid.n_diag_tiles * grid.t + s.arrow:] = 0.0
    return B


@pytest.mark.parametrize("n,bw,ar,t", PANEL_GRIDS)
def test_panel_solves_match_reference(n, bw, ar, t):
    jf, tf, grid = _factors(n, bw, ar, t)
    B = _rhs(grid, 5)
    for name, port in (("forward_solve_many", forward_solve_many),
                       ("backward_solve_many", backward_solve_many),
                       ("solve_many", solve_many)):
        want = np.asarray(getattr(J, name)(jf, jnp.asarray(B), options=JREF))
        np.testing.assert_allclose(port(tf, torch.from_numpy(B)).numpy(), want,
                                   err_msg=name, **TOL)
    b = B[:, 0]
    for name, port in (("forward_solve", forward_solve), ("backward_solve", backward_solve),
                       ("solve", solve)):
        want = np.asarray(getattr(J, name)(jf, jnp.asarray(b), options=JREF))
        got = port(tf, torch.from_numpy(b))
        assert got.shape == (grid.padded_n,)
        np.testing.assert_allclose(got.numpy(), want, err_msg=name, **TOL)


@pytest.mark.parametrize("start_tile", [1, 3])
def test_forward_solve_many_start_tile(start_tile):
    """A panel that is zero above band tile start_tile solves the same from
    there, and Y is zero above it, as in the reference."""
    jf, tf, grid = _factors(130, 40, 30, 16)
    B = _rhs(grid, 4)
    B[:start_tile * grid.t] = 0.0
    got = forward_solve_many(tf, torch.from_numpy(B), start_tile=start_tile).numpy()
    want = np.asarray(J.forward_solve_many(jf, jnp.asarray(B), start_tile=start_tile,
                                           options=JREF))
    np.testing.assert_allclose(got, want, **TOL)
    assert np.abs(got[:start_tile * grid.t]).max() == 0.0
    np.testing.assert_allclose(got, forward_solve_many(tf, torch.from_numpy(B)).numpy(), **TOL)


@pytest.mark.parametrize("n,bw,ar,t", [(130, 40, 30, 16), (160, 8, 0, 16)])
def test_sampling_matches_reference(n, bw, ar, t):
    """Torch cannot draw jax.random's numbers, so the reference's z is
    passed in; a seeded torch.Generator draws reproducibly."""
    jf, tf, grid = _factors(n, bw, ar, t)
    key = jax.random.PRNGKey(7)
    z1 = np.array(jax.random.normal(key, (grid.padded_n,), dtype=jnp.float32))
    np.testing.assert_allclose(sample_gmrf(tf, z=torch.from_numpy(z1)).numpy(),
                               np.asarray(J.sample_gmrf(jf, key, options=JREF)), **TOL)
    zk = np.array(jax.random.normal(key, (grid.padded_n, 6), dtype=jnp.float32))
    np.testing.assert_allclose(sample_gmrf_many(tf, num=6, z=torch.from_numpy(zk)).numpy(),
                               np.asarray(J.sample_gmrf_many(jf, key, 6, options=JREF)), **TOL)
    x1 = sample_gmrf_many(tf, num=3, generator=torch.Generator().manual_seed(0))
    x2 = sample_gmrf_many(tf, num=3, generator=torch.Generator().manual_seed(0))
    assert x1.shape == (grid.padded_n, 3) and torch.equal(x1, x2)
    assert sample_gmrf(tf, generator=torch.Generator().manual_seed(1)).shape == (grid.padded_n,)


@pytest.mark.parametrize("n,bw,ar,t", [(130, 40, 30, 16), (96, 40, 16, 8), (160, 8, 0, 16),
                                       (300, 70, 70, 64)])
@pytest.mark.parametrize("method", ["selinv", "panels"])
def test_marginal_variances_match_reference(n, bw, ar, t, method):
    jf, tf, grid = _factors(n, bw, ar, t)
    idx = np.array([0, 7, n // 2, n - max(ar, 1), n - 1])
    got = marginal_variances(tf, idx, options=SolverOptions(method=method))
    want = np.asarray(J.marginal_variances(jf, jnp.asarray(idx),
                                           options=J.SolverOptions(impl="ref", method=method)))
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("n,bw,ar,t", GRIDS + [QUICKSTART])
def test_solve_chain_matches_dense(n, bw, ar, t):
    """from_sparse -> factorize_window -> solve / sample / marginal variances
    in each package from its own factorization, against numpy.linalg on
    the dense matrix."""
    A, st = make_arrowhead(n, bw, ar, rho=0.6, seed=2)
    m = BandedCTSF.from_sparse(A, TileGrid(st, t=t), device="cpu")
    f = factorize_window(m)
    g = m.grid
    dense = m.to_dense(lower_only=False).astype(np.float64)
    B = _rhs(g, 3, seed=3)
    X = solve_many(f, torch.from_numpy(B)).numpy()
    np.testing.assert_allclose(X, np.linalg.solve(dense, B), rtol=2e-3, atol=2e-4)
    ja, jst = jmake_arrowhead(n, bw, ar, rho=0.6, seed=2)
    jf = J.factorize_window(J.BandedCTSF.from_sparse(ja, J.TileGrid(jst, t=t)), options=JREF)
    np.testing.assert_allclose(X, np.asarray(J.solve_many(jf, jnp.asarray(B), options=JREF)),
                               **TOL)
    # a sample solves L^T x = z with the float64 factor
    z = np.random.default_rng(4).standard_normal((g.padded_n, 2)).astype(np.float32)
    x = sample_gmrf_many(f, num=2, z=torch.from_numpy(z)).numpy()
    L = np.linalg.cholesky(dense)
    np.testing.assert_allclose(L.T @ x, z, rtol=2e-3, atol=2e-3)
    idx = np.array([0, n // 2, n - 1])
    pidx = [g.padded_index(i) for i in idx]
    want = np.diag(np.linalg.inv(dense))[pidx]
    for method in ("selinv", "panels"):
        got = marginal_variances(f, idx, options=SolverOptions(method=method)).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-6, err_msg=method)


def test_validation_and_dispatch_on_the_cpu():
    """Wrong panel shapes, out-of-range indices and unknown methods raise;
    on the CPU the plain versions run and no kernel is launched, and
    impl="cuda" on CPU tensors is refused, not worked around."""
    _, tf, grid = _factors(130, 40, 30, 16)
    with pytest.raises(ValueError, match="padded_n"):
        solve_many(tf, torch.zeros(grid.padded_n + 1, 2))
    with pytest.raises(ValueError, match="out of range"):
        marginal_variances(tf, np.array([0, 130]))
    with pytest.raises(ValueError, match="1-D"):
        marginal_variances(tf, np.zeros((2, 2), dtype=int))
    with pytest.raises(ValueError, match="method"):
        SolverOptions(method="dense")
    counts = lambda: (band_forward_sweep_cuda.launches, band_backward_sweep_cuda.launches,
                      solve_panel_cuda.launches)
    before = counts()
    B = torch.from_numpy(_rhs(grid, 2))
    X = solve_many(tf, B)
    torch.testing.assert_close(X, solve_many(tf, B, options=SolverOptions(impl="ref")),
                               rtol=0, atol=0)
    assert counts() == before
    with pytest.raises(ValueError, match="CUDA"):
        solve_many(tf, B, options=SolverOptions(impl="cuda"))
    # k = 0 panels round-trip
    assert solve_many(tf, torch.zeros(grid.padded_n, 0)).shape == (grid.padded_n, 0)
