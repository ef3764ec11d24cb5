"""The port's selected inversion against the JAX package, on the CPU.

``selected_inverse`` of the reference factor carried in with
``CholeskyFactor.from_arrays`` is held to ``repro``'s at rtol = atol =
2e-4 (float32 on both sides, different summation orders), its accessors
included.  The chain from each package's own factorization is held to
``numpy.linalg.inv`` of the dense matrix on every stored band + arrow
entry at the reference's bound (5e-6 of max(1, max|inv|),
test_selinv.py)."""
import numpy as np
import pytest
import torch

import repro.core as J
from repro.data import make_arrowhead as jmake_arrowhead
from repro_torch.core import (BandedCTSF, CholeskyFactor, SelectedInverse, SolverOptions,
                              TileGrid, factorize_window, selected_inverse)
from repro_torch.data import make_arrowhead
from repro_torch.kernels.selinv import selinv_sweep_cuda

TOL = dict(rtol=2e-4, atol=2e-4)
JREF = J.SolverOptions(impl="ref")
GRIDS = [(16, 4, 0, 16), (30, 6, 14, 16), (160, 8, 0, 16), (130, 40, 30, 16),
         (96, 40, 16, 8), (200, 40, 40, 32), (300, 70, 70, 64)]
QUICKSTART = (2048, 48, 32, 32)


def _factors(n, bw, ar, t, seed=0):
    A, st = jmake_arrowhead(n, bw, ar, rho=0.6, seed=seed)
    grid = J.TileGrid(st, t=t)
    jf = J.factorize_window(J.BandedCTSF.from_sparse(A, grid), options=JREF)
    s = grid.structure
    tf = CholeskyFactor.from_arrays((s.n, s.bandwidth, s.arrow, t),
                                    *(np.asarray(x) for x in jf.ctsf.arrays()), device="cpu")
    return jf, tf, grid


def _pattern(grid):
    """Dense mask of the stored band + arrow pattern (where Σ is kept)."""
    ones = BandedCTSF.eye(grid, device="cpu")
    full = BandedCTSF(grid, torch.ones_like(ones.Dr), torch.ones_like(ones.R),
                      torch.ones_like(ones.C))
    return full.to_dense(lower_only=False) > 0


@pytest.mark.parametrize("n,bw,ar,t", GRIDS)
def test_selected_inverse_matches_reference(n, bw, ar, t):
    jf, tf, grid = _factors(n, bw, ar, t)
    got = selected_inverse(tf)
    want = J.selected_inverse(jf, options=JREF)
    for name in ("Dr", "R", "C"):
        np.testing.assert_allclose(getattr(got, name).numpy(), np.asarray(getattr(want, name)),
                                   err_msg=name, **TOL)
    np.testing.assert_allclose(got.diagonal().numpy(), np.asarray(want.diagonal()), **TOL)
    np.testing.assert_allclose(got.diagonal(padded=True).numpy(),
                               np.asarray(want.diagonal(padded=True)), **TOL)
    pairs = [(0, 0), (1, 0), (n - 1, n - 1), (n // 2, n // 2 - 1)] + ([(n - 1, 0)] if ar else [])
    for i, j in pairs:
        np.testing.assert_allclose(float(got.covariance(i, j)),
                                   float(want.covariance(i, j)), **TOL)
    np.testing.assert_allclose(got.to_dense_band(), want.to_dense_band(), **TOL)
    assert got.nbytes() == want.nbytes()


@pytest.mark.parametrize("n,bw,ar,t", GRIDS + [QUICKSTART])
def test_selected_inverse_chain_matches_dense_inverse(n, bw, ar, t):
    """from_sparse -> factorize_window -> selected_inverse in the port
    reproduces every stored entry of numpy.linalg.inv(A)."""
    A, st = make_arrowhead(n, bw, ar, rho=0.6, seed=1)
    m = BandedCTSF.from_sparse(A, TileGrid(st, t=t), device="cpu")
    sigma = selected_inverse(factorize_window(m))
    inv = np.linalg.inv(m.to_dense(lower_only=False).astype(np.float64))
    err = np.abs(np.where(_pattern(m.grid), sigma.to_dense_band() - inv, 0.0)).max()
    assert err < 5e-6 * max(1.0, np.abs(inv).max())


def test_accessors_and_from_arrays():
    jf, tf, grid = _factors(160, 16, 16, 16)
    want = J.selected_inverse(jf, options=JREF)
    s = grid.structure
    carried = SelectedInverse.from_arrays((s.n, s.bandwidth, s.arrow, grid.t),
                                          *(np.asarray(x) for x in want.arrays()), device="cpu")
    got = selected_inverse(tf)
    for a, b in zip(carried.arrays(), got.arrays()):
        torch.testing.assert_close(a, b, **TOL)
    assert got.diagonal().shape == (s.n,)
    with pytest.raises(ValueError, match="outside the stored band"):
        got.covariance(0, 120)
    with pytest.raises(ValueError, match="out of range"):
        got.covariance(0, 200)
    np.testing.assert_allclose(float(got.covariance(3, 159)), float(got.covariance(159, 3)))


def test_selected_inverse_dispatch_on_the_cpu():
    """CPU tensors take the plain sweep and launch nothing; impl="cuda"
    on them raises."""
    _, tf, _ = _factors(130, 40, 30, 16)
    before = selinv_sweep_cuda.launches
    a = selected_inverse(tf)
    b = selected_inverse(tf, options=SolverOptions(impl="ref"))
    for x, y in zip(a.arrays(), b.arrays()):
        torch.testing.assert_close(x, y, rtol=0, atol=0)
    assert selinv_sweep_cuda.launches == before
    with pytest.raises(ValueError, match="CUDA"):
        selected_inverse(tf, options=SolverOptions(impl="cuda"))
