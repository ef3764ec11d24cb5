"""The port on the card: each CUDA kernel against its plain version, and
``factorize_window`` on the card against the CPU path, at rtol = atol =
2e-4 (float32 on both sides, different summation orders).

Every test here needs a CUDA device and skips without one.  The file
imports nothing of jax or of the JAX package, so it runs where only
PyTorch is installed:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py
"""
import numpy as np
import pytest
import torch

from repro_torch.core import BandedCTSF, TileGrid, factorize_window, logdet
from repro_torch.data import make_arrowhead
from repro_torch.kernels import ref
from repro_torch.kernels.band_cholesky import band_cholesky_sweep_cuda
from repro_torch.kernels.potrf import potrf_cuda
from repro_torch.kernels.ring import band_row_to_col
from repro_torch.kernels.trsm import trsm_cuda

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
