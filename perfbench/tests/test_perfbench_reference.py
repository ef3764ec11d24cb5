"""The plain reference against ``numpy.linalg`` at a tiny size, the frozen
θ arithmetic and row layout against the port's own, and the control one
precision lower."""
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from perfbench.frozen.gmrf import make_arrowhead, table2_matrix
from perfbench.frozen.theta import Candidates, Layout, theta_draws
from perfbench.reference.dense import Control, DenseReference, tf32


@pytest.mark.parametrize("n,w,a", [(300, 20, 12), (250, 16, 1), (200, 9, 0)])
def test_reference_against_numpy(n, w, a):
    A = make_arrowhead(n, w, a, seed=2**33 + 1)
    ref = DenseReference(A, "cpu")
    M = (1.4 * A + 0.3 * sp.eye(n)).toarray()
    L = ref.factor(1.4, 0.3)
    assert abs(ref.logdet(L) - np.linalg.slogdet(M)[1]) <= 1e-10 * abs(np.linalg.slogdet(M)[1])
    b = np.random.default_rng(0).standard_normal((n, 3))
    np.testing.assert_allclose(ref.solve(L, b), np.linalg.solve(M, b), rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(ref.variances(L, block=64), np.diag(np.linalg.inv(M)),
                               rtol=1e-10)


def test_control_is_tf32():
    x = torch.tensor([1.0 + 2.0 ** -11, 1.0 + 2.0 ** -12, -(1.0 + 3 * 2.0 ** -12), 3.0])
    assert tf32(x).tolist() == [1.0 + 2.0 ** -10, 1.0, -(1.0 + 2.0 ** -10), 3.0]
    A = make_arrowhead(600, 30, 24, seed=4)
    ref, ctl = DenseReference(A, "cpu"), Control(A, "cpu")
    L, Lc = ref.factor(1.1, 0.1), ctl.factor(1.1, 0.1)
    assert Lc.dtype == torch.float32
    M32 = torch.as_tensor((1.1 * A + 0.1 * sp.eye(600)).toarray(), dtype=torch.float32)
    b = np.random.default_rng(2).standard_normal((600, 1))
    x = ref.solve(L, b)
    err = lambda y: np.abs(y - x).max() / np.abs(x).max()
    # the control's solutions miss by far more than a float32 Cholesky's
    assert 10 * err(ctl.solve(torch.linalg.cholesky(M32), b)) < err(ctl.solve(Lc, b)) < 1e-2


def test_table2_rows():
    A = table2_matrix(2, seed=3)
    assert A.shape == (10010, 10010)
    assert (abs(A - A.T)).max() == 0


def test_layout_and_candidates_match_the_port():
    from repro_torch.core import BandedCTSF, TileGrid
    from repro_torch.core.structure import ArrowheadStructure
    n, w, a, t = 300, 20, 12, 8
    grid = TileGrid(ArrowheadStructure(n, w, a), t=t)
    lay = Layout(n, a, t)
    assert (lay.ndt, lay.nat, lay.padded_n) == (grid.n_diag_tiles, grid.n_arrow_tiles,
                                                grid.padded_n)
    np.testing.assert_array_equal(lay.rows(), grid.padded_indices(np.arange(n)))
    A = make_arrowhead(n, w, a, seed=9)
    base = BandedCTSF.from_sparse(A, grid, device="cpu")
    tau, delta = theta_draws(2**40, 3, 2, (0.5, 2.0), (0.0, 0.5))
    make = Candidates(lay, "cpu")
    Dr, R, C = make.make(base.Dr, base.R, base.C, tau, delta)
    for i in range(2):
        want = BandedCTSF.from_sparse(tau[i] * A + delta[i] * sp.eye(n), grid, device="cpu")
        for got, exp in zip((Dr[i], R[i], C[i]), want.arrays()):
            torch.testing.assert_close(got, exp, rtol=1e-6, atol=1e-6)
    Dr1, R1, C1 = make.make(base.Dr, base.R, base.C, tau[1:], delta[1:])
    for got, exp in zip((Dr1[0], R1[0], C1[0]), (Dr[1], R[1], C[1])):
        torch.testing.assert_close(got, exp, rtol=1e-6, atol=1e-6)
    B = make.rhs(2, 3, 11)
    assert B.shape == (2, lay.padded_n, 3)
    assert torch.all(B[:, torch.as_tensor(lay.padding())] == 0)
    assert torch.equal(B, make.rhs(2, 3, 11))
