"""The port on the card: each CUDA kernel against its plain version, and
``factorize_window``, the solves and the selected inverse on the card
against the CPU path, at rtol = atol = 2e-4 (float32 on both sides,
different summation orders).

Every test here needs a CUDA device and skips without one.  The file
imports nothing of jax or of the JAX package, so it runs where only
PyTorch is installed:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py
"""
import numpy as np
import pytest
import torch

from repro_torch.core import (BandedCTSF, SolverOptions, TileGrid, factorize_window, logdet,
                              marginal_variances, sample_gmrf_many, selected_inverse,
                              solve_many)
from repro_torch.data import make_arrowhead
from repro_torch.kernels import ref
from repro_torch.kernels.band_cholesky import band_cholesky_sweep_cuda
from repro_torch.kernels.band_solve import band_backward_sweep_cuda, band_forward_sweep_cuda
from repro_torch.kernels.potrf import potrf_cuda
from repro_torch.kernels.ring import band_row_to_col
from repro_torch.kernels.selinv import selinv_sweep_cuda
from repro_torch.kernels.trsm import solve_panel_cuda, trsm_cuda

pytestmark = pytest.mark.gpu

TILES = [8, 16, 32, 64]
TOL = dict(rtol=2e-4, atol=2e-4)
# (n, bandwidth, arrow) per tile size: a deep band of small tiles, a thick
# arrow and wide band, and nat = 2 at t = 32 and 64
GRIDS = {8: (96, 40, 16), 16: (130, 40, 30), 32: (200, 40, 40), 64: (300, 70, 70)}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


def _matrix(t, device, seed=0):
    n, bw, ar = GRIDS[t]
    A, st = make_arrowhead(n, bw, ar, rho=0.6, seed=seed)
    return BandedCTSF.from_sparse(A, TileGrid(st, t=t), device=device)


def _counts():
    return (potrf_cuda.launches, trsm_cuda.launches, band_cholesky_sweep_cuda.launches)


@pytest.mark.parametrize("t", TILES)
def test_potrf_and_trsm_kernels(cuda, t):
    rng = np.random.default_rng(t)
    x = rng.standard_normal((3, t, t)).astype(np.float32)
    a = torch.from_numpy(x @ x.transpose(0, 2, 1) + t * np.eye(t, dtype=np.float32)).to(cuda)
    torch.testing.assert_close(potrf_cuda(a), ref.potrf_ref(a), **TOL)
    l = ref.potrf_ref(a)
    b = torch.from_numpy(rng.standard_normal((3, t, t)).astype(np.float32)).to(cuda)
    torch.testing.assert_close(trsm_cuda(l[0], b), ref.trsm_ref(l[0], b), **TOL)
    torch.testing.assert_close(trsm_cuda(l, b), ref.trsm_ref(l, b), **TOL)


@pytest.mark.parametrize("t", TILES)
@pytest.mark.parametrize("start_tile", [0, 2])
def test_sweep_kernel(cuda, t, start_tile):
    m = _matrix(t, cuda)
    Ac = band_row_to_col(m.Dr)
    got = band_cholesky_sweep_cuda(Ac, m.R, nchunks=3, start_tile=start_tile)
    want = ref.band_cholesky_sweep_ref(Ac, m.R, nchunks=3, start_tile=start_tile)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, **TOL)


def test_sweep_kernel_breakdown_status(cuda):
    """An indefinite diagonal tile gives the plain version's status word:
    the same nonfinite bit and first failing column."""
    m = _matrix(16, cuda)
    Dr = m.Dr.clone()
    Dr[3, 0] -= 1e3 * torch.eye(16, device=cuda)
    Ac = band_row_to_col(Dr)
    got = band_cholesky_sweep_cuda(Ac, m.R)[3].tolist()
    want = ref.band_cholesky_sweep_ref(Ac, m.R)[3].tolist()
    assert got[1:] == want[1:] == [1.0, 3.0]
    assert got[0] == pytest.approx(want[0], rel=2e-4)


@pytest.mark.parametrize("t", TILES)
def test_factorize_window_on_the_card(cuda, t):
    """Without a device the matrix lands on the card; the factorization is
    one sweep launch plus nat potrf and nat trsm launches, and agrees with
    the CPU path."""
    m = _matrix(t, None)
    assert m.device == cuda
    nat = m.grid.n_arrow_tiles
    before = _counts()
    f = factorize_window(m)
    ld = float(logdet(f))
    after = _counts()
    assert tuple(a - b for a, b in zip(after, before)) == (nat, nat, 1)
    fc = factorize_window(_matrix(t, "cpu"))
    for g, w in zip(f.ctsf.arrays(), fc.ctsf.arrays()):
        torch.testing.assert_close(g.cpu(), w, **TOL)
    want = float(logdet(fc))
    assert abs(ld - want) <= 1e-5 * abs(want)
    assert f.status.device == cuda
    assert f.status[1:].tolist() == fc.status[1:].tolist() == [0.0, -1.0]


def test_factorize_window_breakdown_status_on_the_card(cuda):
    """A breakdown on the card is reported on the factor, as on the CPU:
    the band column of the bad tile, or ``ndt`` for the corner."""
    for where in ("band", "corner"):
        m = _matrix(16, cuda)
        Dr, C = m.Dr.clone(), m.C.clone()
        if where == "band":
            Dr[3, 0] -= 1e3 * torch.eye(16, device=cuda)
        else:
            C[1, 1] -= 1e3 * torch.eye(16, device=cuda)
        f = factorize_window(BandedCTSF(m.grid, Dr, m.R, C))
        fc = factorize_window(BandedCTSF(m.grid, Dr.cpu(), m.R.cpu(), C.cpu()))
        want = 3.0 if where == "band" else float(m.grid.n_diag_tiles)
        assert f.status[1:].tolist() == fc.status[1:].tolist() == [1.0, want], where


def _lower(rng, nb, t):
    """Well-conditioned lower-triangular tiles."""
    x = np.tril(rng.standard_normal((nb, t, t))) + t * np.eye(t)
    return x.astype(np.float32)


def _band_factor(rng, ndt, bt, nat, t, device):
    """Random row-band factor tiles with the BandedCTSF conventions (zero
    above the band) and arrow rows, as the reference's kernel tests make."""
    Dr = rng.standard_normal((ndt, bt + 1, t, t)).astype(np.float32)
    Dr[:, 0] = _lower(rng, ndt, t)
    for m in range(ndt):
        Dr[m, min(m, bt) + 1:] = 0.0
    R = rng.standard_normal((ndt, nat, t, t)).astype(np.float32)
    return torch.from_numpy(Dr).to(device), torch.from_numpy(R).to(device)


@pytest.mark.parametrize("t", TILES)
@pytest.mark.parametrize("trans", [False, True])
@pytest.mark.parametrize("k", [1, 7, 64, 65])
def test_solve_panel_kernel(cuda, t, trans, k):
    rng = np.random.default_rng(t + k)
    l = torch.from_numpy(_lower(rng, 3, t)).to(cuda)
    b = torch.from_numpy(rng.standard_normal((3, t, k)).astype(np.float32)).to(cuda)
    torch.testing.assert_close(solve_panel_cuda(l[0], b, trans=trans),
                               ref.solve_panel_ref(l[0], b, trans=trans), **TOL)
    with pytest.raises(ValueError, match="one"):
        solve_panel_cuda(l, b, trans=trans)
    assert solve_panel_cuda(l[0], b[..., :0], trans=trans).shape == (3, t, 0)


# (ndt, bt, nat): one tile (bt = 0), no arrow, a wider band, a deep band
SWEEP_GRIDS = [(1, 0, 0), (5, 1, 0), (6, 2, 2), (9, 4, 1)]


@pytest.mark.parametrize("t", TILES)
@pytest.mark.parametrize("ndt,bt,nat", SWEEP_GRIDS)
@pytest.mark.parametrize("k", [1, 33])
@pytest.mark.parametrize("start_tile", [0, 2])
def test_band_sweep_kernels(cuda, t, ndt, bt, nat, k, start_tile):
    start_tile = min(start_tile, ndt - 1)
    rng = np.random.default_rng(ndt * 100 + k)
    Dr, R = _band_factor(rng, ndt, bt, nat, t, cuda)
    bd = torch.from_numpy(rng.standard_normal((ndt, t, k)).astype(np.float32)).to(cuda)
    bd[:start_tile] = 0.0
    for g, w in zip(band_forward_sweep_cuda(Dr, R, bd, start_tile),
                    ref.band_forward_sweep_ref(Dr, R, bd, start_tile)):
        torch.testing.assert_close(g, w, **TOL)
    xa = torch.from_numpy(rng.standard_normal((nat, t, k)).astype(np.float32)).to(cuda)
    torch.testing.assert_close(band_backward_sweep_cuda(Dr, R, bd, xa, start_tile),
                               ref.band_backward_sweep_ref(Dr, R, bd, xa, start_tile), **TOL)


def _selinv_inputs(t, bt, nat, ndt, device, seed=0):
    """A real factor's column view, arrow rows and corner Σ, from the dense
    float64 Cholesky factor of a random diagonally dominant
    banded-arrowhead matrix."""
    rng = np.random.default_rng(seed)
    n = (ndt + nat) * t
    tile = np.arange(n) // t
    ti, tj = tile[:, None], tile[None, :]
    mask = ((ti < ndt) & (tj < ndt) & (np.abs(ti - tj) <= bt)) | (ti >= ndt) | (tj >= ndt)
    a = np.where(mask, rng.standard_normal((n, n)), 0.0)
    a = np.tril(a) + np.tril(a, -1).T
    a[np.diag_indices(n)] = np.abs(a).sum(axis=1) + 1.0
    L = np.linalg.cholesky(a / a.diagonal().mean())    # Σ of order one
    tl = lambda i, j: L[i * t:(i + 1) * t, j * t:(j + 1) * t]
    lcol = np.zeros((ndt, bt + 1, t, t))
    R = np.zeros((ndt, nat, t, t))
    for j in range(ndt):
        for d in range(bt + 1):
            if j + d < ndt:
                lcol[j, d] = tl(j + d, j)
        for i in range(nat):
            R[j, i] = tl(ndt + i, j)
    w = np.linalg.inv(L[ndt * t:, ndt * t:])
    sc = (w.T @ w).reshape(nat, t, nat, t).transpose(0, 2, 1, 3)
    return tuple(torch.from_numpy(np.ascontiguousarray(x, dtype=np.float32)).to(device)
                 for x in (lcol, R, sc))


@pytest.mark.parametrize("t", [16, 64])
@pytest.mark.parametrize("bt", [0, 1, 4])
@pytest.mark.parametrize("nat", [0, 1, 4])
def test_selinv_sweep_kernel(cuda, t, bt, nat):
    lcol, R, sc = _selinv_inputs(t, bt, nat, 6, cuda)
    for start in (0, 2):
        got = selinv_sweep_cuda(lcol, R, sc, start)
        want = ref.selinv_sweep_ref(lcol, R, sc, start)
        for g, w in zip(got, want):
            torch.testing.assert_close(g, w, **TOL)


def _scounts():
    return (band_forward_sweep_cuda.launches, band_backward_sweep_cuda.launches,
            solve_panel_cuda.launches, selinv_sweep_cuda.launches)


@pytest.mark.parametrize("t", TILES)
def test_solves_and_selected_inverse_on_the_card(cuda, t):
    """solve_many, sample_gmrf_many, selected_inverse and both
    marginal_variances methods on the card agree with the CPU path, each
    through its kernels only: per solve_many one forward and one backward
    sweep launch and 2 nat solve_panel launches, one selinv sweep launch
    per selected_inverse."""
    m = _matrix(t, cuda)
    g = m.grid
    nat = g.n_arrow_tiles
    f = factorize_window(m)
    fc = factorize_window(_matrix(t, "cpu"))
    rng = np.random.default_rng(t)
    B = torch.from_numpy(rng.standard_normal((g.padded_n, 5)).astype(np.float32))
    before = _scounts()
    X = solve_many(f, B.to(cuda))
    assert tuple(a - b for a, b in zip(_scounts(), before)) == (1, 1, 2 * nat, 0)
    torch.testing.assert_close(X.cpu(), solve_many(fc, B), **TOL)
    z = torch.from_numpy(rng.standard_normal((g.padded_n, 3)).astype(np.float32))
    torch.testing.assert_close(sample_gmrf_many(f, 3, z=z.to(cuda)).cpu(),
                               sample_gmrf_many(fc, 3, z=z), **TOL)
    before = _scounts()
    s = selected_inverse(f)
    assert tuple(a - b for a, b in zip(_scounts(), before)) == (0, 0, 0, 1)
    for a, b in zip(s.arrays(), selected_inverse(fc).arrays()):
        torch.testing.assert_close(a.cpu(), b, **TOL)
    n = g.structure.n
    idx = np.array([0, n // 2, n - max(g.structure.arrow, 1), n - 1])
    for method in ("selinv", "panels"):
        got = marginal_variances(f, idx, options=SolverOptions(method=method))
        want = marginal_variances(fc, idx, options=SolverOptions(method=method))
        torch.testing.assert_close(got.cpu(), want, **TOL)
