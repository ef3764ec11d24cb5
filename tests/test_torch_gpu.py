"""The port on the card: each CUDA kernel against its plain version, and
``factorize_window`` (fused, partitioned and window routes),
``factorize_window_batched`` (with and without ``regularize=``),
``factorize_tasklist``, the solves, ``solve_many_batched``, the selected
inverse and ``selinv_batched`` on the card against the CPU path, at rtol =
atol = 2e-4 (float32 on both sides, different summation orders).  The
partitioned sweep is also held bit for bit to the fused one on
block-separable input, and each element of a batched kernel launch (the
sweeps, the band solves, ``solve_panel`` with one L a panel, the selinv
pre-pass and recurrence) to its unbatched launch.  The distributed path
runs on the card as a world of one NCCL rank and as worlds of 2 and 4 gloo
ranks sharing it (spawned by ``launch/mesh.py::run_local``), telemetry
is checked around the card's calls (the solves' corner still captured),
the corner's capture completes beside threads that allocate on the card,
and the rung server serves on the card (its executor's own stream, the CPU
server's results, a threaded run whose clients build on the card).

Every test here needs a CUDA device and skips without one.  The file
imports nothing of jax or of the JAX package, so it runs where only
PyTorch is installed:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py
"""
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from repro_torch.core import (STATUS_FAILED, STATUS_OK, STATUS_RECOVERED, BandedCTSF,
                              PartitionPlan, SolverOptions, TileGrid, TileMatrix,
                              factorize_tasklist, factorize_window, factorize_window_batched,
                              logdet, marginal_variances, sample_gmrf_many, selected_inverse,
                              selinv_batched, solve_many, solve_many_batched)
from repro_torch.data import block_separable_arrowhead, make_arrowhead
from repro_torch.kernels import ops, ref
from repro_torch.kernels.band_cholesky import (MAX_SWEEP_CLUSTER,
                                               band_cholesky_partitioned_sweep_cuda,
                                               band_cholesky_sweep_cuda, sweep_plan)
from repro_torch.kernels.band_solve import (band_backward_sweep_cuda, band_forward_sweep_cuda,
                                           card_solve_plan)
from repro_torch.kernels.band_update import band_update_cuda
from repro_torch.kernels.gemm import (GEMM_SPLITS, geadd_cuda, geadd_floor_cuda, gemm_cuda,
                                      syrk_cuda)
from repro_torch.kernels.potrf import potrf_cuda
from repro_torch.kernels.ring import band_row_to_col
from repro_torch.kernels.selinv import (MAX_SELINV_CLUSTER, selinv_plan, selinv_prepass_cuda,
                                        selinv_step_cuda, selinv_sweep_cuda)
from repro_torch.kernels.trsm import PANEL_CHUNKS, solve_panel_cuda, trsm_cuda
from repro_torch.runtime.telemetry import device_counts

pytestmark = pytest.mark.gpu

TILES = [8, 16, 32, 64]
SWEEP_CLUSTERS = [1, 2, 4, 8, 16]
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
    # in place, with one L and with one L a tile: the tile is read whole
    # before any of it is written
    for lk in (l[0], l):
        x = b.clone()
        assert trsm_cuda(lk, x, out=x) is x
        torch.testing.assert_close(x, ref.trsm_ref(lk, b), **TOL)


@pytest.mark.parametrize("t", TILES)
@pytest.mark.parametrize("start_tile", [0, 2])
@pytest.mark.parametrize("max_cluster", SWEEP_CLUSTERS)
def test_sweep_kernel(cuda, t, start_tile, max_cluster):
    """The cluster sweep at every cluster size against its plain version;
    two launches, and every cluster size, give the same bits (no sum is
    split across ranks)."""
    m = _matrix(t, cuda)
    Ac = band_row_to_col(m.Dr)
    got = band_cholesky_sweep_cuda(Ac, m.R, nchunks=3, start_tile=start_tile,
                                   max_cluster=max_cluster)
    want = ref.band_cholesky_sweep_ref(Ac, m.R, nchunks=3, start_tile=start_tile)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, **TOL)
    again = band_cholesky_sweep_cuda(Ac, m.R, nchunks=3, start_tile=start_tile,
                                     max_cluster=max_cluster)
    one = band_cholesky_sweep_cuda(Ac, m.R, nchunks=3, start_tile=start_tile, max_cluster=1)
    for g, a, o in zip(got, again, one):
        assert torch.equal(g, a) and torch.equal(g, o)


@pytest.mark.parametrize("max_cluster", SWEEP_CLUSTERS)
def test_sweep_kernel_breakdown_status(cuda, max_cluster):
    """An indefinite diagonal tile gives the plain version's status word:
    the same nonfinite bit and first failing column."""
    m = _matrix(16, cuda)
    Dr = m.Dr.clone()
    Dr[3, 0] -= 1e3 * torch.eye(16, device=cuda)
    Ac = band_row_to_col(Dr)
    got = band_cholesky_sweep_cuda(Ac, m.R, max_cluster=max_cluster)[3].tolist()
    want = ref.band_cholesky_sweep_ref(Ac, m.R)[3].tolist()
    assert got[1:] == want[1:] == [1.0, 3.0]
    assert got[0] == pytest.approx(want[0], rel=2e-4)


def test_sweep_kernel_refuses_a_bad_cluster(cuda):
    """A cluster outside 1..16 is refused by the plan, and by the C entry
    point, whose error the wrapper's check raises: no quiet fallback."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.band_cholesky import _plan_table
    m = _matrix(64, cuda)
    Ac = band_row_to_col(m.Dr)
    for bad in (0, MAX_SWEEP_CLUSTER + 1):
        with pytest.raises(ValueError, match="max_cluster"):
            band_cholesky_sweep_cuda(Ac, m.R, max_cluster=bad)
        with pytest.raises(ValueError, match="max_cluster"):
            band_cholesky_partitioned_sweep_cuda(Ac, m.R, (0, Ac.shape[0]), max_cluster=bad)
    ndt, b1 = Ac.shape[:2]
    nat = m.R.shape[1]
    table = _plan_table(sweep_plan(64, b1 - 1, nat), Ac.device)
    outs = (torch.empty_like(Ac), torch.empty_like(m.R),
            torch.empty((1, nat, nat, 64, 64), device=cuda), torch.empty(3, device=cuda))
    lib = _build.load("band_cholesky")
    for cluster in (0, MAX_SWEEP_CLUSTER + 1):
        with pytest.raises(RuntimeError, match="CUDA error"):
            _build.check(lib, lib.stiles_band_cholesky_sweep_f32(
                Ac.data_ptr(), m.R.data_ptr(), *(x.data_ptr() for x in outs),
                table.data_ptr(), cluster, ndt, b1 - 1, nat, 64, ndt, 0, 1,
                torch.cuda.current_stream().cuda_stream), "band_cholesky_sweep")


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
    # one L a panel is taken (test_solve_panel_kernel_one_l_per_panel);
    # any other stack of Ls is refused
    with pytest.raises(ValueError, match="one"):
        solve_panel_cuda(l[:2], b, trans=trans)
    assert solve_panel_cuda(l[0], b[..., :0], trans=trans).shape == (3, t, 0)


# (ndt, bt, nat): one tile (bt = 0), no arrow, a wider band, a deep band
SWEEP_GRIDS = [(1, 0, 0), (5, 1, 0), (6, 2, 2), (9, 4, 1)]
# the band sweeps' grids add Table II matrix 5's band and arrow (clusters
# of 8 blocks, the widest chunks at k = 64)
SOLVE_GRIDS = SWEEP_GRIDS + [(6, 4, 4)]


@pytest.mark.parametrize("t", TILES)
@pytest.mark.parametrize("ndt,bt,nat", SOLVE_GRIDS)
@pytest.mark.parametrize("k", [1, 7, 32, 33, 64])
@pytest.mark.parametrize("start_tile", [0, 2])
@pytest.mark.parametrize("max_cluster", SWEEP_CLUSTERS)
def test_band_sweep_kernels(cuda, t, ndt, bt, nat, k, start_tile, max_cluster):
    """Both band sweeps on the plan of each cluster cap against their plain
    versions, bit for bit the same as the default cap's and as a second
    launch; one launch a call."""
    start_tile = min(start_tile, ndt - 1)
    rng = np.random.default_rng(ndt * 100 + k)
    Dr, R = _band_factor(rng, ndt, bt, nat, t, cuda)
    bd = torch.from_numpy(rng.standard_normal((ndt, t, k)).astype(np.float32)).to(cuda)
    bd[:start_tile] = 0.0
    xa = torch.from_numpy(rng.standard_normal((nat, t, k)).astype(np.float32)).to(cuda)
    fwd = lambda cap: band_forward_sweep_cuda(Dr, R, bd, start_tile, max_cluster=cap)
    bwd = lambda cap: band_backward_sweep_cuda(Dr, R, bd, xa, start_tile, max_cluster=cap)
    launches = (band_forward_sweep_cuda.launches, band_backward_sweep_cuda.launches)
    got = fwd(max_cluster) + (bwd(max_cluster),)
    assert (band_forward_sweep_cuda.launches, band_backward_sweep_cuda.launches) == (
        launches[0] + 1, launches[1] + 1)
    want = ref.band_forward_sweep_ref(Dr, R, bd, start_tile) + (
        ref.band_backward_sweep_ref(Dr, R, bd, xa, start_tile),)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, **TOL)
    for again in (fwd(max_cluster) + (bwd(max_cluster),), fwd(16) + (bwd(16),)):
        assert all(torch.equal(g, a) for g, a in zip(got, again))


def test_band_sweep_kernels_refuse_a_bad_cluster(cuda):
    rng = np.random.default_rng(3)
    Dr, R = _band_factor(rng, 4, 2, 1, 16, cuda)
    bd = torch.zeros((4, 16, 3), device=cuda)
    for cap in (0, 17):
        with pytest.raises(ValueError, match="max_cluster"):
            band_forward_sweep_cuda(Dr, R, bd, max_cluster=cap)
        with pytest.raises(ValueError, match="max_cluster"):
            band_backward_sweep_cuda(Dr, R, bd, bd[:1], max_cluster=cap)


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
            solve_panel_cuda.launches, selinv_sweep_cuda.launches, selinv_prepass_cuda.launches)


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
    # launches on the card, as chip_smoke.py counts them: the corner's first
    # call of a shape runs eagerly and captures its graph, which records
    # its launches without running them
    kern = dict(band_forward_sweep=band_forward_sweep_cuda,
                band_backward_sweep=band_backward_sweep_cuda, solve_panel=solve_panel_cuda)
    before = device_counts(kern)
    X = solve_many(f, B.to(cuda))
    after = device_counts(kern)
    assert {k: after[k] - before[k] for k in kern} == dict(
        band_forward_sweep=1, band_backward_sweep=1, solve_panel=2 * nat)
    before = _scounts()
    torch.testing.assert_close(X.cpu(), solve_many(fc, B), **TOL)
    z = torch.from_numpy(rng.standard_normal((g.padded_n, 3)).astype(np.float32))
    torch.testing.assert_close(sample_gmrf_many(f, num=3, z=z.to(cuda)).cpu(),
                               sample_gmrf_many(fc, num=3, z=z), **TOL)
    before = _scounts()
    s = selected_inverse(f)
    assert tuple(a - b for a, b in zip(_scounts(), before)) == (0, 0, 0, 1, 1)
    for a, b in zip(s.arrays(), selected_inverse(fc).arrays()):
        torch.testing.assert_close(a.cpu(), b, **TOL)
    n = g.structure.n
    idx = np.array([0, n // 2, n - max(g.structure.arrow, 1), n - 1])
    for method in ("selinv", "panels"):
        got = marginal_variances(f, idx, options=SolverOptions(method=method))
        want = marginal_variances(fc, idx, options=SolverOptions(method=method))
        torch.testing.assert_close(got.cpu(), want, **TOL)


@pytest.mark.parametrize("t", TILES)
def test_gemm_syrk_geadd_kernels(cuda, t):
    """C - A B^T with A and B batched or one broadcast tile, in place into C,
    SYRK over the full tile, and A + B on the strided even and odd halves of
    a batch (how the tree reduction calls it)."""
    rng = np.random.default_rng(t)
    x = lambda *shape: torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(cuda)
    c, a, b = x(3, t, t), x(3, t, t), x(3, t, t)
    torch.testing.assert_close(gemm_cuda(c, a, b), ref.gemm_ref(c, a, b), **TOL)
    torch.testing.assert_close(gemm_cuda(c, a[0], b), ref.gemm_ref(c, a[0], b), **TOL)
    torch.testing.assert_close(gemm_cuda(c, a, b[1]), ref.gemm_ref(c, a, b[1]), **TOL)
    c4, a4 = x(2, 3, t, t), x(2, 1, t, t)
    torch.testing.assert_close(gemm_cuda(c4, a4, c4[0, 0]), ref.gemm_ref(c4, a4, c4[0, 0]), **TOL)
    torch.testing.assert_close(syrk_cuda(c, a), ref.syrk_ref(c, a), **TOL)
    want = ref.gemm_ref(c[1], a[0], b[2])
    assert gemm_cuda(c[1], a[0], b[2], out=c[1]).data_ptr() == c[1].data_ptr()
    torch.testing.assert_close(c[1], want, **TOL)
    for shape in ((5, t, t), (7, 2, 3, t, t), (t, t)):
        p = x(*shape)
        if p.dim() > 2:
            ev, od = p[0:p.shape[0] - 1:2], p[1::2]
            torch.testing.assert_close(geadd_cuda(ev, od), ref.geadd_ref(ev, od), rtol=0, atol=0)
        torch.testing.assert_close(geadd_cuda(p, p), ref.geadd_ref(p, p), rtol=0, atol=0)


def _separable_band(t, ndt, bt, nat, bounds, seed=0):
    """Column-band tiles and arrow rows of a random diagonally dominant
    banded-arrowhead matrix whose band tiles across the cuts ``bounds`` are
    zero (block-separable)."""
    rng = np.random.default_rng(seed)
    n = (ndt + nat) * t
    tile = np.arange(n) // t
    part = np.searchsorted(np.asarray(bounds), np.minimum(tile, ndt - 1), side="right")
    ti, tj = tile[:, None], tile[None, :]
    band = (ti < ndt) & (tj < ndt) & (np.abs(ti - tj) <= bt) & (part[:, None] == part[None, :])
    a = np.where(band | (ti >= ndt) | (tj >= ndt), rng.standard_normal((n, n)), 0.0)
    a = np.tril(a) + np.tril(a, -1).T
    a[np.diag_indices(n)] = np.abs(a).sum(axis=1) + 1.0
    Ac = np.zeros((ndt, bt + 1, t, t), np.float32)
    R = np.zeros((ndt, nat, t, t), np.float32)
    for k in range(ndt):
        for e in range(min(bt, ndt - 1 - k) + 1):
            Ac[k, e] = a[(k + e) * t:(k + e + 1) * t, k * t:(k + 1) * t]
        for i in range(nat):
            R[k, i] = a[(ndt + i) * t:(ndt + i + 1) * t, k * t:(k + 1) * t]
    return torch.from_numpy(Ac), torch.from_numpy(R)


# (ndt, bt, nat, bounds): one partition, bt = 0 over three, nat = 0 over
# two, four partitions, four with a ragged last one, and seven (odd) with a
# ragged last one
PARTITIONS = [(5, 2, 1, (0, 5)), (6, 0, 2, (0, 2, 4, 6)), (8, 2, 0, (0, 4, 8)),
              (9, 3, 2, (0, 3, 5, 7, 9)), (11, 2, 1, (0, 4, 8, 10, 11)),
              (15, 1, 3, (0, 3, 6, 8, 10, 12, 14, 15))]


@pytest.mark.parametrize("t", TILES)
@pytest.mark.parametrize("ndt,bt,nat,bounds", PARTITIONS)
@pytest.mark.parametrize("max_cluster", [1, 4, 16])
def test_partitioned_sweep_kernel(cuda, t, ndt, bt, nat, bounds, max_cluster):
    """The partitioned kernel against its plain version, and bit for bit
    against the fused kernel in panels, arrow rows and status, both on the
    plan of clusters of at most ``max_cluster``."""
    Ac, R = (x.to(cuda) for x in _separable_band(t, ndt, bt, nat, bounds, seed=ndt + t))
    for start in (0, 3):
        got = band_cholesky_partitioned_sweep_cuda(Ac, R, bounds, start_tile=start,
                                                   max_cluster=max_cluster)
        want = ref.band_cholesky_partitioned_sweep_ref(Ac, R, bounds, start_tile=start)
        assert got[2].shape == (len(bounds) - 1, nat, nat, t, t)
        for g, w in zip(got, want):
            torch.testing.assert_close(g, w, **TOL)
        fused = band_cholesky_sweep_cuda(Ac, R, nchunks=1, start_tile=start,
                                         max_cluster=max_cluster)
        for g, w in zip(got[:2], fused[:2]):
            assert torch.equal(g, w)
        assert got[3].tolist() == fused[3].tolist()
        torch.testing.assert_close(got[2].sum(0), fused[2][0], **TOL)


def test_tasklist_on_the_card(cuda):
    """factorize_tasklist on the card: one kernel launch per task (or per
    tree level) a call, launches on the card as chip_smoke.py counts them
    (the first call also makes the warm-up's), and the CPU path's factor."""
    from repro_torch.core.cholesky import tasklist_graphs
    smoke = _chip_smoke()
    A, st = make_arrowhead(200, 24, 16, rho=0.6, seed=0)
    grid = TileGrid(st, t=16)
    tm, tc = (TileMatrix.from_sparse(A, grid, device=d) for d in (cuda, "cpu"))
    kinds = {}
    for task in tm.symbolic.tasks:
        kinds[task.type.name] = kinds.get(task.type.name, 0) + 1
    names = ("potrf", "trsm", "syrk", "gemm", "geadd")
    kern = dict(zip(names, (potrf_cuda, trsm_cuda, syrk_cuda, gemm_cuda, geadd_cuda)))
    tasklist_graphs.clear()
    for tree in (False, True):
        calls = []
        for _ in range(2):
            before = device_counts(kern)
            got = factorize_tasklist(tm, tree_reduction=tree, tree_workers=4)
            after = device_counts(kern)
            calls.append([after[k] - before[k] for k in names])
        first, launches = calls
        warm = smoke.tasklist_warmup_launches(dict(geadd=launches[4]), 4 if tree else 0)
        assert first == [n + warm[k] for k, n in zip(names, launches)]
        torch.testing.assert_close(got.cpu(), factorize_tasklist(tc, tree_reduction=tree,
                                                                 tree_workers=4), **TOL)
        assert launches[:2] == [kinds["POTRF"], kinds["TRSM"]]
        if not tree:
            assert launches[2:] == [kinds["SYRK"], kinds["GEMM"], 0]
        else:
            assert launches[2] < kinds["SYRK"] and launches[4] > 0
    assert torch.equal(tm.tiles.cpu(), tc.tiles)


def test_partitioned_factorize_window_on_the_card(cuda):
    """A plan of four partitions: one partitioned launch and no fused one,
    two geadd levels before the corner, and the fused route's factor."""
    A, st, bounds = block_separable_arrowhead(200, 12, 24, 8, n_parts=4, seed=2)
    m = BandedCTSF.from_sparse(A, TileGrid(st, t=8), device=cuda)
    plan = PartitionPlan(boundaries=bounds, sep_tiles=m.grid.n_arrow_tiles)
    kern = (band_cholesky_partitioned_sweep_cuda, band_cholesky_sweep_cuda, geadd_cuda,
            potrf_cuda, trsm_cuda)
    before = [k.launches for k in kern]
    f = factorize_window(m, options=SolverOptions(partition_plan=plan))
    nat = m.grid.n_arrow_tiles
    assert [k.launches - b for k, b in zip(kern, before)] == [1, 0, 2, nat, nat]
    fused = factorize_window(m)
    for name in ("Dr", "R"):
        assert torch.equal(getattr(f.ctsf, name), getattr(fused.ctsf, name)), name
    torch.testing.assert_close(f.ctsf.C, fused.ctsf.C, **TOL)
    assert f.status[1:].tolist() == [0.0, -1.0]
    fc = factorize_window(BandedCTSF(m.grid, m.Dr.cpu(), m.R.cpu(), m.C.cpu()),
                          options=SolverOptions(partition_plan=plan))
    for g, w in zip(f.ctsf.arrays(), fc.ctsf.arrays()):
        torch.testing.assert_close(g.cpu(), w, **TOL)


@pytest.mark.parametrize("t", TILES)
@pytest.mark.parametrize("b1", [1, 2, 3, 5, 6, 9])
def test_band_update_kernel(cuda, t, b1):
    """One window, and a batch of windows sliced out of padded band rows
    (strided along the batch, read in place), against both plain versions;
    b + 1 = 1 has no pairs, 2 one pair a target, 3 fewer pairs than the
    cluster's four ranks, 6 a count that is not a multiple of them.  Each
    call is one launch."""
    rng = np.random.default_rng(10 * t + b1)
    w = torch.from_numpy(rng.standard_normal((b1, b1, t, t)).astype(np.float32)).to(cuda)
    before = band_update_cuda.launches
    got = band_update_cuda(w)
    assert band_update_cuda.launches == before + 1
    torch.testing.assert_close(got, ref.band_update_unrolled_ref(w), **TOL)
    torch.testing.assert_close(got, ref.band_update_ref(w), **TOL)
    rows = torch.from_numpy(rng.standard_normal((3, 7 + b1, b1, t, t)).astype(np.float32))
    win = rows.to(cuda)[:, 4:4 + b1]
    assert not win.is_contiguous()
    torch.testing.assert_close(band_update_cuda(win), ref.band_update_unrolled_ref(win), **TOL)
    assert band_update_cuda.launches == before + 2


@pytest.mark.parametrize("t", TILES)
@pytest.mark.parametrize("b1", [2, 5, 9])
def test_band_update_kernel_is_deterministic(cuda, t, b1):
    """Two launches on the same windows give the same bits, and each
    element of a strided batch the bits of its unbatched launch: the
    cluster's partials are added in a fixed order and only pointers differ
    between the elements."""
    rng = np.random.default_rng(20 * t + b1)
    rows = torch.from_numpy(rng.standard_normal((4, 6 + b1, b1, t, t)).astype(np.float32))
    win = rows.to(cuda)[:, 3:3 + b1]
    got = band_update_cuda(win)
    assert torch.equal(got, band_update_cuda(win))
    for i in range(win.shape[0]):
        assert torch.equal(got[i], band_update_cuda(win[i]))


@pytest.mark.parametrize("t", TILES)
def test_selinv_step_kernel(cuda, t):
    """j_n below the cluster's four ranks (1, 2, 3), not a multiple of them
    (5, 17), one row (e_n = 1), and the empty shapes, which launch
    nothing; every other call is one launch."""
    rng = np.random.default_rng(t)
    for e_n, j_n in ((1, 1), (1, 2), (4, 3), (3, 5), (8, 8), (2, 17), (1, 17)):
        s_row = torch.from_numpy(rng.standard_normal((e_n, j_n, t, t)).astype(np.float32)).to(cuda)
        g_col = torch.from_numpy(rng.standard_normal((j_n, t, t)).astype(np.float32)).to(cuda)
        before = selinv_step_cuda.launches
        got = selinv_step_cuda(s_row, g_col)
        assert selinv_step_cuda.launches == before + 1
        torch.testing.assert_close(got, ref.selinv_step_ref(s_row, g_col), **TOL)
    before = selinv_step_cuda.launches
    empty = selinv_step_cuda(torch.zeros((0, 3, t, t), device=cuda), torch.zeros((3, t, t),
                                                                                device=cuda))
    zero = selinv_step_cuda(torch.zeros((2, 0, t, t), device=cuda), torch.zeros((0, t, t),
                                                                               device=cuda))
    assert empty.shape == (0, t, t) and zero.shape == (2, t, t) and not zero.any()
    assert selinv_step_cuda.launches == before


@pytest.mark.parametrize("t", TILES)
@pytest.mark.parametrize("e_n,j_n", [(8, 8), (2, 17)])
def test_selinv_step_kernel_is_deterministic(cuda, t, e_n, j_n):
    """Two launches on the same operands give the same bits."""
    rng = np.random.default_rng(30 * t + j_n)
    s_row = torch.from_numpy(rng.standard_normal((e_n, j_n, t, t)).astype(np.float32)).to(cuda)
    g_col = torch.from_numpy(rng.standard_normal((j_n, t, t)).astype(np.float32)).to(cuda)
    assert torch.equal(selinv_step_cuda(s_row, g_col), selinv_step_cuda(s_row, g_col))


@pytest.mark.parametrize("t", TILES)
def test_trsm_kernel_one_l_per_group(cuda, t):
    rng = np.random.default_rng(t)
    x = rng.standard_normal((4, t, t))
    a = torch.from_numpy((x @ x.transpose(0, 2, 1) + t * np.eye(t)).astype(np.float32)).to(cuda)
    l = ref.potrf_ref(a)[:, None]
    b = torch.from_numpy(rng.standard_normal((4, 3, t, t)).astype(np.float32)).to(cuda)
    torch.testing.assert_close(trsm_cuda(l, b), ref.trsm_ref(l, b), **TOL)
    x = b.clone()
    trsm_cuda(l, x, out=x)
    torch.testing.assert_close(x, ref.trsm_ref(l, b), **TOL)
    with pytest.raises(ValueError, match="group"):
        trsm_cuda(l[:2], b)


@pytest.mark.parametrize("t", [16, 64])
@pytest.mark.parametrize("max_cluster", [2, 16])
def test_batched_sweep_kernels_bit_identical_per_element(cuda, t, max_cluster):
    """The fused and partitioned sweeps on a batch of three: one launch
    each, every element's outputs bit for bit the unbatched launch's, and
    the plain versions' to fp32 tolerance."""
    bounds = (0, 2, 5, 7)
    els = [_separable_band(t, 7, 2, 2, bounds, seed=s) for s in range(3)]
    Ac = torch.stack([e[0] for e in els]).to(cuda)
    R = torch.stack([e[1] for e in els]).to(cuda)
    for sweep, args in ((band_cholesky_sweep_cuda, dict(nchunks=3, start_tile=1)),
                        (band_cholesky_partitioned_sweep_cuda, dict(boundaries=bounds,
                                                                    start_tile=1))):
        before = sweep.launches
        got = sweep(Ac, R, **args, max_cluster=max_cluster)
        assert sweep.launches == before + 1 and got[3].shape == (3, 3)
        plain = (ref.band_cholesky_sweep_ref if sweep is band_cholesky_sweep_cuda
                 else ref.band_cholesky_partitioned_sweep_ref)(Ac, R, **args)
        for i in range(3):
            one = sweep(Ac[i], R[i], **args, max_cluster=max_cluster)
            for g, w in zip(got, one):
                assert torch.equal(g[i], w)
        for g, w in zip(got, plain):
            torch.testing.assert_close(g, w, **TOL)


def test_window_route_on_the_card(cuda):
    """sweep="window" on the card: a band_update, a potrf and two trsm
    launches a column, the corner's nat potrf and nat trsm and the Schur
    tree's three geadd levels; the CPU path's factor and the fused route's."""
    A, st = make_arrowhead(320, 24, 16, rho=0.7, seed=5)
    m = BandedCTSF.from_sparse(A, TileGrid(st, t=16), device=cuda)
    ndt, nat = m.grid.n_diag_tiles, m.grid.n_arrow_tiles
    kern = (band_update_cuda, potrf_cuda, trsm_cuda, geadd_cuda, band_cholesky_sweep_cuda)
    before = [k.launches for k in kern]
    f = factorize_window(m, options=SolverOptions(sweep="window"))
    assert [k.launches - b for k, b in zip(kern, before)] == [ndt, ndt + nat, 2 * ndt + nat, 3, 0]
    fc = factorize_window(BandedCTSF(m.grid, m.Dr.cpu(), m.R.cpu(), m.C.cpu()),
                          options=SolverOptions(sweep="window"))
    for g, w in zip(f.ctsf.arrays(), fc.ctsf.arrays()):
        torch.testing.assert_close(g.cpu(), w, **TOL)
    for g, w in zip(f.ctsf.arrays(), factorize_window(m).ctsf.arrays()):
        torch.testing.assert_close(g, w, **TOL)
    assert f.status[1:].tolist() == [0.0, -1.0]


@pytest.mark.parametrize("sweep", ["fused", "window"])
def test_factorize_window_batched_on_the_card(cuda, sweep):
    """Three θ-candidates ``τ A + δ I``: the fused route is one sweep launch
    whose band and status are each element's unbatched factor bit for bit;
    the window route is one band_update launch a column; both agree with
    each element's unbatched factor."""
    A, st = make_arrowhead(240, 24, 16, rho=0.7, seed=0)
    grid = TileGrid(st, t=16)
    mats = [BandedCTSF.from_sparse((tau * A + delta * sp.identity(A.shape[0])).tocsr(), grid, device=cuda)
            for tau, delta in ((1.0, 0.0), (0.5, 0.25), (2.0, 0.1))]
    kern = band_cholesky_sweep_cuda if sweep == "fused" else band_update_cuda
    before = kern.launches
    f = factorize_window_batched(mats, options=SolverOptions(sweep=sweep))
    assert kern.launches - before == (1 if sweep == "fused" else grid.n_diag_tiles)
    assert f.status.shape == (3, 3) and logdet(f).shape == (3,)
    for i, m in enumerate(mats):
        one = factorize_window(m, options=SolverOptions(sweep=sweep))
        for name in ("Dr", "R", "C"):
            got, want = getattr(f.ctsf, name)[i], getattr(one.ctsf, name)
            if sweep == "fused" and name != "C":
                assert torch.equal(got, want), name
            torch.testing.assert_close(got, want, **TOL)
        if sweep == "fused":
            assert torch.equal(f.status[i], one.status)


def _spd(rng, nb, t):
    x = rng.standard_normal((nb, t, t)).astype(np.float32)
    return x @ x.transpose(0, 2, 1) + t * np.eye(t, dtype=np.float32)


@pytest.mark.parametrize("t", TILES)
def test_potrf_kernel_single_batch_and_in_place(cuda, t):
    """The blocked potrf on one tile, on a batch, and in place (out=a),
    one launch each, against the plain version; L lower, zeros above."""
    a = torch.from_numpy(_spd(np.random.default_rng(100 + t), 5, t)).to(cuda)
    want = ref.potrf_ref(a)
    before = potrf_cuda.launches
    one = potrf_cuda(a[2])
    torch.testing.assert_close(one, want[2], **TOL)
    got = potrf_cuda(a)
    torch.testing.assert_close(got, want, **TOL)
    assert torch.equal(got, got.tril())
    b = a.clone()
    assert potrf_cuda(b, out=b).data_ptr() == b.data_ptr()
    torch.testing.assert_close(b, want, **TOL)
    assert potrf_cuda.launches == before + 3


@pytest.mark.parametrize("t", TILES)
def test_potrf_kernel_breakdown(cuda, t):
    """A non-positive pivot at column c leaves columns before c finite and
    every entry of the lower triangle from column c on non-finite."""
    a = torch.from_numpy(_spd(np.random.default_rng(t), 1, t)[0]).to(cuda)
    c = t // 2 + 1
    a[c, c] = -1.0
    got = potrf_cuda(a)
    lower = torch.ones((t - c, t - c), dtype=torch.bool, device=cuda).tril()
    assert torch.isfinite(got[:, :c]).all()
    assert not torch.isfinite(got[c:, c:])[lower].any()


@pytest.mark.parametrize("t", TILES)
def test_factorize_window_indefinite_corner_status(cuda, t):
    """An indefinite corner tile: the factor's status word on the card is
    the one impl="ref" gives on the same card."""
    m = _matrix(t, cuda)
    C = m.C.clone()
    # twice the largest diagonal entry off the diagonal: indefinite
    C[0, 0] -= 2 * C[0, 0].diagonal().abs().max() * torch.eye(t, device=cuda)
    bad = BandedCTSF(m.grid, m.Dr, m.R, C)
    got = factorize_window(bad).status.tolist()
    want = factorize_window(bad, options=SolverOptions(impl="ref")).status.tolist()
    assert got[1:] == want[1:] == [1.0, float(m.grid.n_diag_tiles)]
    assert got[0] == pytest.approx(want[0], rel=2e-4)


# (ndt, bt, nat) beyond test_selinv_sweep_kernel's grid: one column, fewer
# columns than band tiles, and chip_smoke.py's grid at ndt = 6
SELINV_EDGES = [(1, 4, 4), (1, 0, 0), (3, 4, 1), (2, 4, 0)]


@pytest.mark.parametrize("t", [16, 64])
@pytest.mark.parametrize("ndt,bt,nat", SELINV_EDGES + [(6, bt, nat) for bt in (0, 1, 4)
                                                       for nat in (0, 1, 4)])
@pytest.mark.parametrize("max_cluster", [4, 8, MAX_SELINV_CLUSTER])
def test_selinv_sweep_kernel_clusters(cuda, t, ndt, bt, nat, max_cluster):
    """The pre-pass and the cluster recurrence against the plain versions
    at every cluster size the plan allows, start_tile 0 and 2."""
    lcol, R, sc = _selinv_inputs(t, bt, nat, ndt, cuda, seed=ndt + bt + nat)
    for start in (0, 2):
        work = selinv_prepass_cuda(lcol, R, sc, start)
        torch.testing.assert_close(work, ref.selinv_prepass_ref(lcol, R, sc, start), **TOL)
        got = selinv_sweep_cuda(lcol, R, sc, start, max_cluster=max_cluster)
        want = ref.selinv_sweep_ref(lcol, R, sc, start)
        for g, w in zip(got, want):
            torch.testing.assert_close(g, w, **TOL)


@pytest.mark.parametrize("t", [16, 64])
def test_selinv_sweep_kernel_deterministic_and_counted(cuda, t):
    """Two launches give the same bits; a sweep is one pre-pass and one
    recurrence launch, the recurrence alone (work=) one."""
    lcol, R, sc = _selinv_inputs(t, 4, 4, 8, cuda, seed=3)
    before = (selinv_sweep_cuda.launches, selinv_prepass_cuda.launches)
    a, b = selinv_sweep_cuda(lcol, R, sc), selinv_sweep_cuda(lcol, R, sc)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    assert (selinv_sweep_cuda.launches, selinv_prepass_cuda.launches) == \
        (before[0] + 2, before[1] + 2)
    work = selinv_prepass_cuda(lcol, R, sc)
    c = selinv_sweep_cuda(lcol, R, sc, work=work)
    assert torch.equal(c[0], a[0]) and torch.equal(c[1], a[1])
    assert (selinv_sweep_cuda.launches, selinv_prepass_cuda.launches) == \
        (before[0] + 3, before[1] + 3)


def test_selinv_sweep_kernel_refuses_a_bad_plan(cuda):
    """The C entry point checks the plan again and returns an error, which
    the wrapper's check raises: no quiet fallback."""
    from repro_torch.kernels import _build
    lcol, R, sc = _selinv_inputs(64, 4, 4, 4, cuda)
    work = selinv_prepass_cuda(lcol, R, sc)
    panels, acols = torch.empty_like(lcol), torch.empty_like(R)
    lib = _build.load("selinv")
    plan = selinv_plan(64, 4, 4)
    stream = torch.cuda.current_stream().cuda_stream
    for cluster, split in ((MAX_SELINV_CLUSTER + 1, plan.diag_split), (0, 1),
                           (plan.cluster, plan.diag_split + 1)):
        with pytest.raises(RuntimeError, match="CUDA error"):
            _build.check(lib, lib.stiles_selinv_sweep_f32(
                work.data_ptr(), panels.data_ptr(), acols.data_ptr(), 1, 4, 4, 4, 64, cluster,
                split, 0, stream), "selinv_sweep")
    with pytest.raises(RuntimeError, match="CUDA error"):
        _build.check(lib, lib.stiles_selinv_sweep_f32(
            work.data_ptr(), panels.data_ptr(), acols.data_ptr(), 1, 4, 4, 4, 64,
            plan.cluster, plan.diag_split, -1, stream), "selinv_sweep")


# (t, split) for every split of csrc/gemm.cu at every tile size
GEMM_CASES = [(t, s) for t in TILES for s in GEMM_SPLITS[t]]


@pytest.mark.parametrize("t,split", GEMM_CASES)
def test_gemm_syrk_kernels_every_split(cuda, t, split):
    """C - A B^T and C - A A^T on the plan of ``split`` blocks a tile:
    batched, A or B one tile broadcast, one tile, a two-level batch against
    broadcast operands, and in place into C."""
    rng = np.random.default_rng(10 * t + split)
    x = lambda *shape: torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(cuda)
    c, a, b = x(5, t, t), x(5, t, t), x(5, t, t)
    for args in ((c, a, b), (c, a[0], b), (c, a, b[1]), (c[2], a[0], b[1])):
        torch.testing.assert_close(gemm_cuda(*args, split=split), ref.gemm_ref(*args), **TOL)
    c4, a4 = x(2, 3, t, t), x(2, 1, t, t)
    torch.testing.assert_close(gemm_cuda(c4, a4, c4[1, 2].clone(), split=split),
                               ref.gemm_ref(c4, a4, c4[1, 2]), **TOL)
    torch.testing.assert_close(syrk_cuda(c, a, split=split), ref.syrk_ref(c, a), **TOL)
    torch.testing.assert_close(syrk_cuda(c[1], a[3], split=split), ref.syrk_ref(c[1], a[3]),
                               **TOL)
    for kern, args, want in ((gemm_cuda, (a[0], b[2]), ref.gemm_ref(c[1], a[0], b[2])),
                             (syrk_cuda, (a[4],), ref.syrk_ref(c[1], a[4]))):
        inplace = c[1].clone()
        assert kern(inplace, *args, out=inplace, split=split).data_ptr() == inplace.data_ptr()
        torch.testing.assert_close(inplace, want, **TOL)


@pytest.mark.parametrize("t", TILES)
def test_gemm_splits_bit_identical(cuda, t):
    """Every output element is summed over k in the same order in one thread
    whatever the split: every split, the default and a second launch give
    the same bits, and a launch is counted once."""
    rng = np.random.default_rng(t)
    x = lambda *shape: torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(cuda)
    c, a, b = x(5, t, t), x(5, t, t), x(t, t)
    for kern, args in ((gemm_cuda, (c, a, b)), (syrk_cuda, (c, a)), (gemm_cuda, (c[0], a[1], b))):
        first = kern(*args)
        before = kern.launches
        for split in GEMM_SPLITS[t]:
            assert torch.equal(kern(*args, split=split), first), (kern.__name__, split)
        assert kern.launches - before == len(GEMM_SPLITS[t])


def test_gemm_refuses_a_bad_split(cuda):
    """A split the kernel is not built for is refused, by the wrapper and by
    the C entry point (a piece size it has no instance of)."""
    from repro_torch.kernels import _build
    c = torch.zeros((64, 64), device=cuda)
    for t, split in ((64, 2), (32, 64), (8, 4)):
        with pytest.raises(ValueError, match="split"):
            gemm_cuda(c[:t, :t].contiguous(), c[:t, :t].contiguous(), c[:t, :t].contiguous(),
                      split=split)
    lib = _build.load("gemm")
    stream = torch.cuda.current_stream().cuda_stream
    for t, sub in ((64, 12), (64, 128), (32, 64), (8, 4), (12, 8)):
        with pytest.raises(RuntimeError, match="CUDA error"):
            _build.check(lib, lib.stiles_gemm_f32(c.data_ptr(), c.data_ptr(), c.data_ptr(),
                                                  c.data_ptr(), 1, 0, 0, t, sub, stream), "gemm")


def _chip_smoke():
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _tasklist_matrix(device, scale=1.0, shift=0.0, n=200, bw=24, ar=16, t=16):
    A, st = make_arrowhead(n, bw, ar, rho=0.6, seed=0)
    A = (scale * A + shift * sp.identity(A.shape[0])).tocsr()
    return TileMatrix.from_sparse(A, TileGrid(st, t=t), device=device)


def _eager(tm, workers):
    """The task list launched task by task from the host, on the card."""
    from repro_torch.core.cholesky import _run_tasklist, _schedule
    return _run_tasklist(tm.tiles.clone(), _schedule(tm, workers), workers, None)


@pytest.mark.parametrize("tree", [False, True])
def test_tasklist_graph_replay_matches_the_eager_loop(cuda, tree):
    """The replayed graph's factor is the eager loop's bit for bit with the
    tree off; with it on, the batched product goes through cuBLAS, which may
    take another algorithm inside a capture, so within the kernels'
    tolerance.  Two calls return buffers of their own."""
    tm = _tasklist_matrix(cuda)
    workers = 4 if tree else 0
    first = factorize_tasklist(tm, tree_reduction=tree, tree_workers=4)
    second = factorize_tasklist(tm, tree_reduction=tree, tree_workers=4)
    eager = _eager(tm, workers)
    assert torch.equal(first, second) and first.data_ptr() != second.data_ptr()
    if tree:
        torch.testing.assert_close(first, eager, **TOL)
    else:
        assert torch.equal(first, eager)
    first.zero_()
    assert torch.equal(factorize_tasklist(tm, tree_reduction=tree, tree_workers=4), second)


def test_tasklist_graph_serves_a_new_matrix_of_the_same_pattern(cuda):
    """A new TileMatrix of the same pattern and other values (an INLA θ
    step) replays the cached graph without a new capture and gets its own
    factor, not the first matrix's."""
    from repro_torch.core.cholesky import tasklist_graphs
    tm1 = _tasklist_matrix(cuda)
    tm2 = _tasklist_matrix(cuda, scale=1.5, shift=0.25)
    f1 = factorize_tasklist(tm1)
    captures = tasklist_graphs.captures
    f2 = factorize_tasklist(tm2)
    assert tasklist_graphs.captures == captures
    assert torch.equal(f2, _eager(tm2, 0))
    assert not torch.equal(f1, f2)
    assert torch.equal(factorize_tasklist(tm1), f1)


def test_tasklist_graph_shared_by_impl_none_and_cuda(cuda):
    """impl=None and impl="cuda" run the same kernels on the card: the second
    replays the first one's graph."""
    from repro_torch.core.cholesky import tasklist_graphs
    tm = _tasklist_matrix(cuda, n=190)
    f1 = factorize_tasklist(tm)
    captures = tasklist_graphs.captures
    f2 = factorize_tasklist(tm, options=SolverOptions(impl="cuda"))
    assert tasklist_graphs.captures == captures and torch.equal(f1, f2)


@pytest.mark.parametrize("tree", [False, True])
def test_tasklist_graph_counts_each_call_once(cuda, tree):
    """Launches on the card, as chip_smoke.py counts them: the first call
    makes the warm-up's and one call's (those chip_smoke.py derives from the
    symbolic task list), every later call one call's.  The wrappers count
    their own calls: the warm-up and the capture, not the replays."""
    from repro_torch.core.cholesky import tasklist_graphs
    smoke = _chip_smoke()
    tasklist_graphs.clear()
    tm = _tasklist_matrix(cuda, n=180, bw=20, ar=12)
    workers = 4 if tree else 0
    want = smoke.tasklist_launches(tm, workers)
    warm = smoke.tasklist_warmup_launches(want, workers)
    kern = dict(potrf=potrf_cuda, trsm=trsm_cuda, syrk=syrk_cuda, gemm=gemm_cuda,
                geadd=geadd_cuda)
    for call in range(3):
        before, own = device_counts(kern), {k: f.launches for k, f in kern.items()}
        factorize_tasklist(tm, tree_reduction=tree, tree_workers=4)
        after = device_counts(kern)
        first = {k: want[k] + warm[k] for k in kern}
        assert {k: after[k] - before[k] for k in kern} == (want if call else first)
        assert {k: f.launches - own[k] for k, f in kern.items()} == (
            dict.fromkeys(kern, 0) if call else first)


def test_tasklist_graph_cache_is_bounded(cuda):
    """More patterns than the cache holds: the least recently used goes, and
    calling it again captures it anew."""
    from repro_torch.core.cholesky import TASKLIST_GRAPH_CACHE, tasklist_graphs
    tasklist_graphs.clear()
    tm = _tasklist_matrix(cuda)
    captures = tasklist_graphs.captures
    for workers in range(2, 3 + TASKLIST_GRAPH_CACHE):
        factorize_tasklist(tm, tree_reduction=True, tree_workers=workers)
    assert len(tasklist_graphs) == TASKLIST_GRAPH_CACHE
    assert tasklist_graphs.captures == captures + TASKLIST_GRAPH_CACHE + 1
    factorize_tasklist(tm, tree_reduction=True, tree_workers=3 + TASKLIST_GRAPH_CACHE - 1)
    assert tasklist_graphs.captures == captures + TASKLIST_GRAPH_CACHE + 1
    factorize_tasklist(tm, tree_reduction=True, tree_workers=2)
    assert tasklist_graphs.captures == captures + TASKLIST_GRAPH_CACHE + 2


@pytest.mark.parametrize("t", TILES)
@pytest.mark.parametrize("trans", [False, True])
@pytest.mark.parametrize("k", [1, 7, 8, 9, 32, 33, 64])
def test_solve_panel_kernel_every_chunk(cuda, t, trans, k):
    """Every chunk width against the plain version, bit for bit the same as
    the default and as a second launch, on a batch of three panels (float4
    loads where k % 4 == 0) and on panels at an offset of one float (scalar
    loads); each launch counted once."""
    rng = np.random.default_rng(100 * t + k)
    l = torch.from_numpy(_lower(rng, 1, t)[0]).to(cuda)
    b = torch.from_numpy(rng.standard_normal((3, t, k)).astype(np.float32)).to(cuda)
    shifted = torch.empty(3 * t * k + 1, device=cuda)[1:].view(3, t, k)
    shifted.copy_(b)
    want = ref.solve_panel_ref(l, b, trans=trans)
    first = solve_panel_cuda(l, b, trans=trans)
    before = solve_panel_cuda.launches
    for chunk in PANEL_CHUNKS:
        for panels in (b, shifted):
            got = solve_panel_cuda(l, panels, trans=trans, chunk=chunk)
            torch.testing.assert_close(got, want, **TOL)
            assert torch.equal(got, first), chunk
    assert solve_panel_cuda.launches - before == 2 * len(PANEL_CHUNKS)
    assert torch.equal(solve_panel_cuda(l, b, trans=trans), first)


def test_solve_panel_refuses_a_bad_chunk(cuda):
    """A chunk width the kernel is not built for is refused, by the wrapper
    and by the C entry point."""
    from repro_torch.kernels import _build
    l = torch.eye(16, device=cuda)
    b = torch.ones((16, 5), device=cuda)
    for chunk in (0, 3, 16):
        with pytest.raises(ValueError, match="chunk"):
            solve_panel_cuda(l, b, chunk=chunk)
    lib = _build.load("solve_panel")
    stream = torch.cuda.current_stream().cuda_stream
    with pytest.raises(RuntimeError, match="CUDA error"):
        _build.check(lib, lib.stiles_solve_panel_f32(l.data_ptr(), b.data_ptr(), b.data_ptr(),
                                                     1, 16, 5, 16, 1, 0, 0, stream),
                     "solve_panel")


@pytest.mark.parametrize("t", TILES)
@pytest.mark.parametrize("pdl", [False, True])
def test_geadd_kernel_with_and_without_pdl(cuda, t, pdl):
    """A + B bit for bit the plain version with the programmatic launch on
    and off: strided halves of a stack, a batch, and one more than a wave
    of the grid's loads (the grid-stride loop); the empty kernel launches
    on the same grid."""
    rng = np.random.default_rng(t)
    x = lambda *shape: torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(cuda)
    leaves, a, b = x(7, 2, 2, t, t), x(5, t, t), x(5, t, t)
    big = 132 * 256 * 4 * 4 // (t * t) + 3
    ba, bb = x(big, t, t), x(big, t, t)
    for p, q in ((leaves[0:6:2], leaves[1:6:2]), (a, b), (a[1], b[3]), (ba, bb)):
        assert torch.equal(geadd_cuda(p, q, pdl=pdl), ref.geadd_ref(p, q))
        geadd_floor_cuda(p, q, pdl=pdl)
    torch.cuda.synchronize()


def test_geadd_chain_in_a_graph(cuda):
    """The tree's levels as a chain of programmatic launches captured in a
    CUDA graph, bit for bit the eager tree."""
    from repro_torch.core import tree_combine
    partials = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (8, 64, 64)).astype(np.float32)).to(cuda)
    want = tree_combine(partials)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        tree_combine(partials)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        got = tree_combine(partials)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    level = partials
    while level.shape[0] > 1:
        level = ref.geadd_ref(level[0::2], level[1::2])
    assert torch.equal(want, level[0])


def _eager_solve_many(f, B):
    """solve_many with the corner launched eagerly, as before its graph:
    the two sweeps and the corner's two loops, called directly."""
    from repro_torch.core.solve import (_backward_corner, _forward_corner, _merge_panels,
                                        _split_rhs)
    c = f.ctsf
    bd, ba = _split_rhs(c.grid, B)
    yd, acc_a = ops.band_forward_sweep(c.Dr, c.R, bd)
    xa = _backward_corner(c.C, _forward_corner(c.C, ba, acc_a, None), None)
    return _merge_panels(ops.band_backward_sweep(c.Dr, c.R, yd, xa.contiguous()), xa)


@pytest.mark.parametrize("t", [32, 64])
def test_solve_graph_matches_the_eager_corner(cuda, t):
    """solve_many's corner from its CUDA graph: one capture a direction on
    the first call (its result the eager loop's), none on a second call, an
    impl="cuda" call or a new factor of the same grid; each replay within
    the kernels' tolerance of the eager corner (cuBLAS may take another
    algorithm inside a capture), and outputs of their own."""
    from repro_torch.core.solve import corner_graphs
    corner_graphs.clear()
    m = _matrix(t, cuda)
    f = factorize_window(m)
    B = torch.from_numpy(np.random.default_rng(t).standard_normal(
        (m.grid.padded_n, 6)).astype(np.float32)).to(cuda)
    captures = corner_graphs.captures
    first = solve_many(f, B)
    assert corner_graphs.captures == captures + 2
    eager = _eager_solve_many(f, B)
    assert torch.equal(first, eager)
    second = solve_many(f, B)
    third = solve_many(f, B, options=SolverOptions(impl="cuda"))
    torch.testing.assert_close(second, eager, **TOL)
    assert torch.equal(second, third) and second.data_ptr() != third.data_ptr()
    # a θ step 1.5 A + 0.25 I of the same grid
    eye = 0.25 * torch.eye(t, device=cuda)
    Dr, C = 1.5 * m.Dr, 1.5 * m.C
    Dr[:, 0] += eye
    for i in range(C.shape[0]):
        C[i, i] += eye
    m2 = BandedCTSF(m.grid, Dr, 1.5 * m.R, C)
    f2 = factorize_window(m2)
    x2 = solve_many(f2, B)
    assert corner_graphs.captures == captures + 2
    torch.testing.assert_close(x2, _eager_solve_many(f2, B), **TOL)
    assert not torch.allclose(x2, second)
    assert torch.equal(solve_many(f, B), second)


def test_solve_graph_ref_captures_nothing(cuda):
    """impl="ref" on the card runs the corner eagerly, as the CPU does."""
    from repro_torch.core.solve import corner_graphs
    m = _matrix(16, cuda)
    f = factorize_window(m)
    B = torch.ones((m.grid.padded_n, 3), device=cuda)
    captures = corner_graphs.captures
    solve_many(f, B, options=SolverOptions(impl="ref"))
    assert corner_graphs.captures == captures


# ---------------------------------------------------------------------------
# the θ-batch's read-out: the batched band solves, solve_panel with one L a
# panel, the batched selinv sweep, and breakdown recovery
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("t", TILES)
@pytest.mark.parametrize("trans", [False, True])
@pytest.mark.parametrize("k", [1, 33])
def test_solve_panel_kernel_one_l_per_panel(cuda, t, trans, k):
    """One L a panel (the batched corner): one launch, against the plain
    loop, and each panel bit for bit its launch alone against its L."""
    rng = np.random.default_rng(7 * t + k)
    l = torch.from_numpy(_lower(rng, 3, t)).to(cuda)
    b = torch.from_numpy(rng.standard_normal((3, t, k)).astype(np.float32)).to(cuda)
    before = solve_panel_cuda.launches
    got = solve_panel_cuda(l, b, trans=trans)
    assert solve_panel_cuda.launches == before + 1
    torch.testing.assert_close(got, ref.solve_panel_ref(l, b, trans=trans), **TOL)
    for i in range(3):
        assert torch.equal(got[i], solve_panel_cuda(l[i], b[i].contiguous(), trans=trans))


@pytest.mark.parametrize("t", [16, 64])
@pytest.mark.parametrize("ndt,bt,nat", [(5, 1, 0), (6, 4, 4), (9, 4, 1)])
@pytest.mark.parametrize("k", [1, 33])
@pytest.mark.parametrize("start_tile", [0, 2])
@pytest.mark.parametrize("batch", [1, 3])
def test_batched_band_sweep_kernels(cuda, t, ndt, bt, nat, k, start_tile, batch):
    """Both band sweeps on a batch: one launch each, against the plain
    versions, and each element bit for bit its unbatched launch at the
    batch's chunk width; the batch-1 plan is the unbatched plan."""
    rng = np.random.default_rng(1000 * batch + 10 * ndt + k)
    els = [_band_factor(rng, ndt, bt, nat, t, cuda) for _ in range(batch)]
    Dr, R = torch.stack([e[0] for e in els]), torch.stack([e[1] for e in els])
    bd = torch.from_numpy(rng.standard_normal((batch, ndt, t, k)).astype(np.float32)).to(cuda)
    bd[:, :start_tile] = 0.0
    xa = torch.from_numpy(rng.standard_normal((batch, nat, t, k)).astype(np.float32)).to(cuda)
    before = (band_forward_sweep_cuda.launches, band_backward_sweep_cuda.launches)
    yd, acca = band_forward_sweep_cuda(Dr, R, bd, start_tile)
    xd = band_backward_sweep_cuda(Dr, R, bd, xa, start_tile)
    assert (band_forward_sweep_cuda.launches, band_backward_sweep_cuda.launches) == (
        before[0] + 1, before[1] + 1)
    want = ref.band_forward_sweep_ref(Dr, R, bd, start_tile) + (
        ref.band_backward_sweep_ref(Dr, R, bd, xa, start_tile),)
    for g, w in zip((yd, acca, xd), want):
        torch.testing.assert_close(g, w, **TOL)
    width = card_solve_plan(t, bt, nat, k, device=cuda, batch=batch).width
    if batch == 1:
        assert width == card_solve_plan(t, bt, nat, k, device=cuda).width
    for i in range(batch):
        one = band_forward_sweep_cuda(Dr[i], R[i], bd[i], start_tile, width=width) + (
            band_backward_sweep_cuda(Dr[i], R[i], bd[i], xa[i], start_tile, width=width),)
        assert all(torch.equal(g[i], o) for g, o in zip((yd, acca, xd), one))


@pytest.mark.parametrize("t", [16, 64])
@pytest.mark.parametrize("bt,nat", [(0, 1), (1, 0), (4, 4)])
@pytest.mark.parametrize("batch", [1, 3])
def test_batched_selinv_sweep_kernel(cuda, t, bt, nat, batch):
    """The selinv pre-pass and recurrence on a batch: one launch each,
    against the plain versions, each element bit for bit its unbatched
    launch."""
    els = [_selinv_inputs(t, bt, nat, 6, cuda, seed=s) for s in range(batch)]
    lcol, R, sc = (torch.stack([e[q] for e in els]) for q in range(3))
    for start in (0, 2):
        before = (selinv_prepass_cuda.launches, selinv_sweep_cuda.launches)
        work = selinv_prepass_cuda(lcol, R, sc, start)
        got = selinv_sweep_cuda(lcol, R, sc, start, work=work)
        assert (selinv_prepass_cuda.launches, selinv_sweep_cuda.launches) == (
            before[0] + 1, before[1] + 1)
        torch.testing.assert_close(work, ref.selinv_prepass_ref(lcol, R, sc, start), **TOL)
        for g, w in zip(got, ref.selinv_sweep_ref(lcol, R, sc, start)):
            torch.testing.assert_close(g, w, **TOL)
        for i in range(batch):
            assert torch.equal(work[i], selinv_prepass_cuda(lcol[i], R[i], sc[i], start))
            one = selinv_sweep_cuda(lcol[i], R[i], sc[i], start)
            assert all(torch.equal(g[i], o) for g, o in zip(got, one))


def _card_scounts():
    """:func:`_scounts` as launches on the card: ``solve_panel``'s count less
    the launches the corner graphs' captures recorded, plus those their
    replays made (a first call of a key both runs the corner and captures
    it)."""
    from repro_torch.core.solve import corner_graphs
    fwd, bwd, panel, sweep, pre = _scounts()
    name = solve_panel_cuda.__name__
    return (fwd, bwd, panel - corner_graphs.recorded[name] + corner_graphs.replayed[name],
            sweep, pre)


def _theta_batch_on(device, faults=False, seed=0):
    """Four θ-candidates ``τ A + δ I`` of one grid (t = 16, nat = 1) on
    ``device``; with ``faults`` element 1 made indefinite (a band diagonal
    tile dropped by 10 x its mean |diagonal|) and element 2 given a NaN on
    a structural nonzero, placed symmetrically."""
    A, st = make_arrowhead(240, 24, 16, rho=0.7, seed=seed)
    grid = TileGrid(st, t=16)
    mats = [BandedCTSF.from_sparse((tau * A + delta * sp.identity(A.shape[0])).tocsr(), grid,
                                   device="cpu")
            for tau, delta in ((1.0, 0.0), (0.5, 0.25), (2.0, 0.1), (1.5, 0.3))]
    Dr, R, C = (torch.stack(x) for x in zip(*(m.arrays() for m in mats)))
    if faults:
        d = torch.diagonal(Dr[1, :, 0], dim1=-2, dim2=-1)
        Dr[1, 3, 0] -= 10.0 * d.abs().mean() * torch.eye(16)
        R[2, 1, 0, 2, 5] = float("nan")
    return BandedCTSF(grid, Dr.to(device), R.to(device), C.to(device))


def test_regularized_batch_on_the_card(cuda):
    """factorize_window_batched(regularize=True) on the card: the statuses
    the CPU ladder gives (OK, RECOVERED, FAILED, OK), healthy elements bit
    for bit the unregularized call, the recovered factor the CPU path's;
    the clean batch bit for bit the call without regularize=."""
    mb = _theta_batch_on(cuda, faults=True)
    f = factorize_window_batched(mb, options=SolverOptions(regularize=True))
    plain = factorize_window_batched(mb)
    cpu = factorize_window_batched(_theta_batch_on("cpu", faults=True),
                                   options=SolverOptions(regularize=True))
    assert f.info.status.tolist() == cpu.info.status.tolist() == [
        STATUS_OK, STATUS_RECOVERED, STATUS_FAILED, STATUS_OK]
    assert f.info.attempts.tolist() == cpu.info.attempts.tolist()
    assert f.info.first_bad_tile.tolist() == cpu.info.first_bad_tile.tolist()
    torch.testing.assert_close(f.info.tau.cpu(), cpu.info.tau, rtol=1e-6, atol=0.0,
                               equal_nan=True)
    for i in (0, 3):
        assert all(torch.equal(a[i], b[i]) for a, b in zip(f.ctsf.arrays(), plain.ctsf.arrays()))
    for a, b in zip(f.ctsf.arrays(), cpu.ctsf.arrays()):
        torch.testing.assert_close(a[1].cpu(), b[1], **TOL)
    clean = _theta_batch_on(cuda)
    g0 = factorize_window_batched(clean)
    g1 = factorize_window_batched(clean, options=SolverOptions(regularize=True))
    assert g1.info.status.tolist() == [STATUS_OK] * 4
    assert all(torch.equal(a, b) for a, b in zip(g0.ctsf.arrays(), g1.ctsf.arrays()))


def test_batched_read_out_on_the_card(cuda):
    """solve_many_batched and selinv_batched on the card against the CPU
    path; a clean batch is one forward, one backward and 2 nat solve_panel
    launches, a recovered one twice that (the refinement pass), and the
    clean elements of the recovered batch bit for bit the clean batch's;
    selinv_batched one pre-pass and one recurrence launch."""
    grid = _theta_batch_on("cpu").grid
    nat = grid.n_arrow_tiles
    B = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (4, grid.padded_n, 5)).astype(np.float32))
    outs = {}
    for faults in (False, True):
        mb = _theta_batch_on(cuda, faults)
        f = factorize_window_batched(mb, options=SolverOptions(regularize=True))
        fc = factorize_window_batched(_theta_batch_on("cpu", faults),
                                      options=SolverOptions(regularize=True))
        before = _card_scounts()
        X = solve_many_batched(f, B.to(cuda))
        rounds = 2 if faults else 1
        assert [a - b for a, b in zip(_card_scounts(), before)] == [
            rounds, rounds, 2 * nat * rounds, 0, 0]
        want = solve_many_batched(fc, B)
        keep = [0, 1, 3] if faults else [0, 1, 2, 3]
        torch.testing.assert_close(X[keep].cpu(), want[keep], **TOL)
        outs[faults] = X
        if not faults:
            before = _scounts()
            sig = selinv_batched(f)
            assert [a - b for a, b in zip(_scounts(), before)] == [0, 0, 0, 1, 1]
            sc = selinv_batched(fc)
            for a, b in zip(sig.arrays(), sc.arrays()):
                torch.testing.assert_close(a.cpu(), b, **TOL)
            torch.testing.assert_close(sig.diagonal().cpu(), sc.diagonal(), **TOL)
    for i in (0, 3):
        assert torch.equal(outs[True][i], outs[False][i])


# ---------------------------------------------------------------------------
# Canonical-grid bucketing: the sweeps with an identity prefix of more than
# half the grid, whole Schur chunks of prefix, and a shared start on a batch
# ---------------------------------------------------------------------------

# a policy whose diagonal floor puts more than half of each grid in the prefix
DEEP = dict(min_diag_tiles=32)


def _deep_embedding(t, device, seed=0):
    """A GRIDS[t] matrix embedded on a canonical grid of 32 or more diagonal
    tiles (prefix deeper than half) and its source grid: ``(emb, m, pad)``,
    on ``device``."""
    from repro_torch.core import GridBucketPolicy, embed_ctsf
    m = _matrix(t, device, seed=seed)
    cg = GridBucketPolicy(**DEEP).canonicalize(m.grid)
    pad = cg.n_diag_tiles - m.grid.n_diag_tiles
    assert 2 * pad > cg.n_diag_tiles
    return embed_ctsf(m, cg), m, pad


@pytest.mark.parametrize("t", TILES)
@pytest.mark.parametrize("nchunks", [1, 8])
@pytest.mark.parametrize("max_cluster", [1, 16])
def test_sweep_kernel_skips_a_deep_prefix(cuda, t, nchunks, max_cluster):
    """The fused sweep at start_tile = the prefix against its plain version;
    chunks that are all prefix leave exactly zero Schur partials, the
    prefix identity panels and zero arrow rows, and the rest is the source
    grid's factor."""
    emb, m, pad = _deep_embedding(t, cuda)
    Ac = band_row_to_col(emb.Dr)
    got = band_cholesky_sweep_cuda(Ac, emb.R, nchunks=nchunks, start_tile=pad,
                                   max_cluster=max_cluster)
    want = ref.band_cholesky_sweep_ref(Ac, emb.R, nchunks=nchunks, start_tile=pad)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, **TOL)
    from repro_torch.kernels.ring import chunk_layout
    csz, _ = chunk_layout(emb.grid.n_diag_tiles, nchunks)
    for c in range(pad // csz):
        assert not got[2][c].any()
    eye = torch.eye(t, device=cuda)
    assert torch.equal(got[0][:pad, 0], eye.expand(pad, t, t)) and not got[0][:pad, 1:].any()
    assert not got[1][:pad].any()
    src = band_cholesky_sweep_cuda(band_row_to_col(m.Dr), m.R, nchunks=1)
    b1 = m.grid.band_tiles + 1
    torch.testing.assert_close(got[0][pad:, :b1], src[0], **TOL)
    torch.testing.assert_close(got[2].sum(0), src[2].sum(0), **TOL)


@pytest.mark.parametrize("t", [16, 64])
def test_partitioned_sweep_kernel_skips_a_deep_prefix(cuda, t):
    """The partitioned sweep with a plan shifted past a deep prefix: the
    prefix joins partition 0, against the plain version and bit for bit
    the fused kernel on block-separable input."""
    A, st, bounds = block_separable_arrowhead(12 * t, 2 * t, t, t, n_parts=3, seed=1)
    m = BandedCTSF.from_sparse(A, TileGrid(st, t), device=cuda)
    from repro_torch.core import GridBucketPolicy, embed_ctsf
    cg = GridBucketPolicy(**DEEP).canonicalize(m.grid)
    pad = cg.n_diag_tiles - m.grid.n_diag_tiles
    emb = embed_ctsf(m, cg)
    plan = PartitionPlan(bounds).shifted(pad)
    Ac = band_row_to_col(emb.Dr)
    got = band_cholesky_partitioned_sweep_cuda(Ac, emb.R, plan.boundaries, start_tile=pad)
    want = ref.band_cholesky_partitioned_sweep_ref(Ac, emb.R, plan.boundaries, start_tile=pad)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, **TOL)
    fused = band_cholesky_sweep_cuda(Ac, emb.R, nchunks=1, start_tile=pad)
    assert torch.equal(got[0], fused[0]) and torch.equal(got[1], fused[1])


@pytest.mark.parametrize("t", [16, 64])
def test_batched_sweep_kernel_with_a_shared_start(cuda, t):
    """assemble_rung_batch of two grids of one rung: one launch at the
    shared (smaller) start, each element against the plain version and bit
    for bit its unbatched launch at that start."""
    from repro_torch.core import GridBucketPolicy, assemble_rung_batch
    pol = GridBucketPolicy(**DEEP)
    n, bw, ar = GRIDS[t]
    pairs = [make_arrowhead(nn, bw, ar, rho=0.6, seed=s) for s, nn in enumerate((n, n - t))]
    mats = [BandedCTSF.from_sparse(A, TileGrid(st, t), device=cuda) for A, st in pairs]
    cg = pol.canonicalize(mats[0].grid)
    assert pol.canonicalize(mats[1].grid) == cg
    batch, start = assemble_rung_batch(mats, cg)
    Ac = band_row_to_col(batch.Dr)
    before = band_cholesky_sweep_cuda.launches
    got = band_cholesky_sweep_cuda(Ac, batch.R, nchunks=8, start_tile=start)
    assert band_cholesky_sweep_cuda.launches == before + 1
    want = ref.band_cholesky_sweep_ref(Ac, batch.R, nchunks=8, start_tile=start)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, **TOL)
    for i in range(2):
        one = band_cholesky_sweep_cuda(Ac[i], batch.R[i], nchunks=8, start_tile=start)
        assert all(torch.equal(g[i], o) for g, o in zip(got, one))


@pytest.mark.parametrize("t", [16, 64])
@pytest.mark.parametrize("k", [1, 33])
@pytest.mark.parametrize("batch", [1, 3])
def test_band_sweep_kernels_skip_a_deep_prefix(cuda, t, k, batch):
    """Both band sweeps on an embedded factor at start_tile = the prefix,
    unbatched and on a batch with the start shared: against the plain
    versions, the prefix rows zero, each element bit for bit its launch
    alone at the batch's chunk width."""
    from repro_torch.core import factorize_window
    emb, _, pad = _deep_embedding(t, cuda)
    f = factorize_window(emb, options=SolverOptions(impl="ref"))
    g = emb.grid
    nat = g.n_arrow_tiles
    rng = np.random.default_rng(k)
    Dr = f.ctsf.Dr.expand((batch,) + tuple(f.ctsf.Dr.shape)).contiguous()
    R = f.ctsf.R.expand((batch,) + tuple(f.ctsf.R.shape)).contiguous()
    bd = torch.from_numpy(rng.standard_normal((batch, g.n_diag_tiles, t, k)).astype(
        np.float32)).to(cuda)
    bd[:, :pad] = 0.0
    xa = torch.from_numpy(rng.standard_normal((batch, nat, t, k)).astype(np.float32)).to(cuda)
    yd, acca = band_forward_sweep_cuda(Dr, R, bd, pad)
    xd = band_backward_sweep_cuda(Dr, R, bd, xa, pad)
    want = ref.band_forward_sweep_ref(Dr, R, bd, pad) + (
        ref.band_backward_sweep_ref(Dr, R, bd, xa, pad),)
    for got, w in zip((yd, acca, xd), want):
        torch.testing.assert_close(got, w, **TOL)
    assert not yd[:, :pad].any() and not xd[:, :pad].any()
    width = card_solve_plan(t, g.band_tiles, nat, k, device=cuda, batch=batch).width
    for i in range(batch):
        one = band_forward_sweep_cuda(Dr[i], R[i], bd[i], pad, width=width) + (
            band_backward_sweep_cuda(Dr[i], R[i], bd[i], xa[i], pad, width=width),)
        assert all(torch.equal(x[i], o) for x, o in zip((yd, acca, xd), one))


@pytest.mark.parametrize("t", [16, 64])
@pytest.mark.parametrize("batch", [1, 3])
def test_selinv_kernels_skip_a_deep_prefix(cuda, t, batch):
    """The selinv pre-pass and recurrence on an embedded factor at
    start_tile = the prefix: against the plain versions, identity Σ panels
    over the prefix, a batch with the start shared bit for bit each
    element's launch alone."""
    from repro_torch.core import factorize_window
    from repro_torch.core.selinv import corner_sigma
    emb, _, pad = _deep_embedding(t, cuda)
    f = factorize_window(emb, options=SolverOptions(impl="ref"))
    lcol = band_row_to_col(f.ctsf.Dr)
    sc = corner_sigma(f.ctsf.C)
    lead = lambda x: x.expand((batch,) + tuple(x.shape)).contiguous()
    lcol, R, sc = lead(lcol), lead(f.ctsf.R), lead(sc)
    work = selinv_prepass_cuda(lcol, R, sc, pad)
    torch.testing.assert_close(work, ref.selinv_prepass_ref(lcol, R, sc, pad), **TOL)
    got = selinv_sweep_cuda(lcol, R, sc, pad, work=work)
    for g, w in zip(got, ref.selinv_sweep_ref(lcol, R, sc, pad)):
        torch.testing.assert_close(g, w, **TOL)
    eye = torch.eye(t, device=cuda)
    assert torch.equal(got[0][:, :pad, 0], eye.expand(batch, pad, t, t))
    assert not got[0][:, :pad, 1:].any() and not got[1][:, :pad].any()
    for i in range(batch):
        one = selinv_sweep_cuda(lcol[i], R[i], sc[i], pad)
        assert all(torch.equal(g[i], o) for g, o in zip(got, one))


@pytest.mark.parametrize("t", [16, 64])
def test_policy_entry_points_on_the_card(cuda, t):
    """factorize_window, solve_many, selected_inverse and both
    marginal_variances methods under the policy on the card against the
    CPU's unbucketed calls, with the launches of the unbucketed calls."""
    from repro_torch.core import GridBucketPolicy, factorize_window, solve_many
    pol = SolverOptions(policy=GridBucketPolicy(**DEEP))
    m = _matrix(t, cuda)
    mc = _matrix(t, "cpu")
    g = m.grid
    before = _counts()
    fp = factorize_window(m, options=pol)
    assert [a - b for a, b in zip(_counts(), before)] == [g.n_arrow_tiles] * 2 + [1]
    f0 = factorize_window(mc)
    for a, b in zip(fp.restrict().ctsf.arrays(), f0.ctsf.arrays()):
        torch.testing.assert_close(a.cpu(), b, **TOL)
    torch.testing.assert_close(fp.logdet().cpu(), f0.logdet(), rtol=1e-5, atol=0)
    B = torch.from_numpy(np.random.default_rng(t).standard_normal((g.padded_n, 5)).astype(
        np.float32))
    torch.testing.assert_close(solve_many(fp, B.to(cuda)).cpu(), solve_many(f0, B), **TOL)
    torch.testing.assert_close(selected_inverse(fp).Dr.cpu(), selected_inverse(f0).Dr, **TOL)
    idx = [0, g.structure.n // 2, g.structure.n - 1]
    for method in ("selinv", "panels"):
        o = SolverOptions(method=method)
        torch.testing.assert_close(marginal_variances(fp, idx, options=o).cpu(),
                                   marginal_variances(f0, idx, options=o), **TOL)


# ---------------------------------------------------------------------------
# the distributed path on the card: a world of one over NCCL, worlds of 2
# and 4 sharing the card over gloo (ranks spawned by run_local, the rank
# functions of tests/_torch_ranks.py); telemetry around the card's calls
# ---------------------------------------------------------------------------

def _ranks():
    import _torch_ranks
    from repro_torch.launch.mesh import run_local
    return _torch_ranks, run_local


@pytest.mark.parametrize("world,backend", [(1, "nccl"), (2, "gloo"), (4, "gloo")])
def test_distributed_factorize_on_the_card(cuda, world, backend):
    """Each rank's share and the assembled factor: panels and arrow rows
    bit for bit the fused ``factorize_window`` of the whole matrix, the
    corner the same bits on every rank and within 1e-5 of the fused
    route's; one sweep, log2(world) geadd and the corner's launches a
    rank."""
    ranks, run_local = _ranks()
    A, st = make_arrowhead(16 * 16 + 16, 16, 16, rho=0.0, seed=3)
    m = BandedCTSF.from_sparse(A, TileGrid(st, t=16), device="cpu")
    outs = run_local(ranks.distributed, m, 4, (1, world), "model", "cuda", world_size=world,
                     backend=backend, device_type="cuda", timeout=300)
    f = factorize_window(BandedCTSF.from_sparse(A, TileGrid(st, t=16), device=cuda))
    C = f.ctsf.C.cpu()
    want = {"band_cholesky_sweep": 1, "potrf": 1, "trsm": 1}
    if world > 1:
        want["geadd"] = world.bit_length() - 1
    for o in outs:
        assert torch.equal(o["full"][0], f.ctsf.Dr.cpu()) and torch.equal(o["full"][1],
                                                                          f.ctsf.R.cpu())
        assert torch.equal(o["C"], outs[0]["C"])
        torch.testing.assert_close(o["C"], C, rtol=0, atol=1e-5 * float(C.abs().max()))
        assert o["launches"] == want


def test_concurrent_mesh_on_the_card(cuda):
    """The sharded concurrent calls over the ``data`` axis of a (2, 2)
    mesh of four gloo ranks on the card: each rank's elements bit for bit
    the unsharded call's (the corner within 1e-5), the logdets the whole
    batch's on every rank, Σ within 2e-4 of ``selinv_batched``'s, the
    faulted batch's statuses and attempts the unsharded call's."""
    from repro_torch.core.concurrent import concurrent_factorize, stack_ctsf
    from repro_torch.runtime.fault_tolerance import NumericalFaultInjector
    ranks, run_local = _ranks()
    mats = []
    for seed in range(8):
        A, st = make_arrowhead(160, 16, 16, rho=0.5, seed=seed)
        mats.append(BandedCTSF.from_sparse(A, TileGrid(st, t=16), device="cpu"))
    batch = stack_ctsf(mats)
    faulted = NumericalFaultInjector(seed=0).corrupt(batch, {2: "indefinite", 5: "nan"})
    outs = run_local(ranks.concurrent, batch, faulted, (2, 2), [None], "cuda", world_size=4,
                     backend="gloo", device_type="cuda", timeout=300)
    on = lambda b: BandedCTSF(b.grid, *(x.to(cuda) for x in b.arrays()))
    f = concurrent_factorize(on(batch))
    s = selinv_batched(f)
    ff = concurrent_factorize(on(faulted), options=SolverOptions(regularize=True))
    for r, o in enumerate(outs):
        run, lo = o["runs"][0], (r // 2) * 4
        assert run["offset"] == lo and run["launches"] == {
            "band_cholesky_sweep": 1, "potrf": 1, "trsm": 1}
        for a, b in zip(run["factor"][:2], f.ctsf.arrays()[:2]):
            assert torch.equal(a, b[lo:lo + 4].cpu())
        C = f.ctsf.C[lo:lo + 4].cpu()
        torch.testing.assert_close(run["factor"][2], C, rtol=0,
                                   atol=1e-5 * float(C.abs().max()))
        torch.testing.assert_close(run["logdet"], f.logdet().cpu(), rtol=1e-5, atol=0)
        assert torch.equal(run["logdet"], outs[0]["runs"][0]["logdet"])
        for a, b in zip(run["sigma"], s.arrays()):
            torch.testing.assert_close(a, b[lo:lo + 4].cpu(), **TOL)
        info = o["faulted"]["info"]
        assert torch.equal(info[0], ff.info.status.cpu())
        assert torch.equal(info[1], ff.info.attempts.cpu())
        assert torch.equal(info[4], ff.info.first_bad_tile.cpu())


def test_telemetry_around_the_card(cuda):
    """With telemetry enabled the solves' corner graphs still capture (two
    keys for a new k) and the spans are the reference's; kernel_report of
    ``factorize_window`` counts one sweep and the corner's launches."""
    from repro_torch.core.solve import corner_graphs
    from repro_torch.runtime import telemetry
    m = _matrix(16, cuda)
    nat = m.grid.n_arrow_tiles
    f = factorize_window(m)
    B = torch.randn((m.grid.padded_n, 7), generator=torch.Generator().manual_seed(0)).to(cuda)
    corner_graphs.clear()
    c0 = corner_graphs.captures
    telemetry.reset()
    try:
        with telemetry.capture():
            X = solve_many(f, B)
            torch.cuda.synchronize()
        snap = telemetry.snapshot()
    finally:
        telemetry.reset()
    assert corner_graphs.captures - c0 == 2
    assert [s["name"] for s in snap["spans"]] == ["solve.solve_many"]
    assert snap["counters"] == {}
    torch.testing.assert_close(solve_many(f, B), X, **TOL)
    rep = telemetry.kernel_report(factorize_window, m, grid=m.grid, sweep="cholesky")
    assert rep.launches == {"band_cholesky_sweep": 1, "potrf": nat, "trsm": nat}


def test_corner_capture_beside_allocating_threads(cuda):
    """The corner's capture (``cholesky.capture``, thread-local capture
    errors) completes while other threads allocate on the card and copy from
    pageable memory, and those threads' calls do not fail."""
    import threading
    from repro_torch.core.solve import corner_graphs
    m = _matrix(16, cuda)
    f = factorize_window(m)
    B = torch.randn((m.grid.padded_n, 5), generator=torch.Generator().manual_seed(1)).to(cuda)
    want = solve_many(f, B)
    stop, errors = threading.Event(), []

    def churn(j):
        try:
            n = 1
            while not stop.is_set():
                n = n % 4096 + 1
                x = torch.from_numpy(np.full((n, 64), j, np.float32)).to(cuda)
                torch.cuda.empty_cache()
                (x * 2).sum().item()
        except Exception as err:
            errors.append(repr(err))

    threads = [threading.Thread(target=churn, args=(j,)) for j in range(4)]
    for t in threads:
        t.start()
    try:
        for _ in range(5):
            corner_graphs.clear()
            c0 = corner_graphs.captures
            got = solve_many(f, B)
            assert corner_graphs.captures - c0 == 2
            torch.testing.assert_close(got, want, **TOL)
            torch.testing.assert_close(solve_many(f, B), want, **TOL)
    finally:
        stop.set()
        for t in threads:
            t.join(timeout=60)
    assert not errors and not any(t.is_alive() for t in threads)


def test_rung_server_on_the_card(cuda):
    """The rung server on the card: its executor's own stream, results on
    the card against the CPU server's on the same arrivals (the same
    history), and a threaded run whose clients build their requests on the
    card, every wait with a timeout."""
    import threading
    from repro_torch.launch.rung_server import RungServer, SimClock, _build_arrivals, replay
    from repro_torch.data import request_stream
    stream = request_stream(2, [(300, 70, 70), (260, 70, 70), (300, 70, 10)], 12,
                            rate=3000.0, k=5)

    def serve(device):
        clock = SimClock()
        server = RungServer(max_batch=3, max_delay=1e-3, clock=clock, device=device)
        futs = replay(server, clock, _build_arrivals(stream, t=16, device=device))
        return server, [f.result(timeout=0) for f in futs]

    gpu, gres = serve(cuda)
    cpu, cres = serve("cpu")
    assert isinstance(gpu.executor.inner.stream, torch.cuda.Stream)
    assert gpu.history == cpu.history
    for g, c in zip(gres, cres):
        assert (g.status, g.attempts) == (c.status, c.attempts) == (STATUS_OK, 1)
        assert g.x.device.type == "cuda"
        torch.testing.assert_close(g.x.cpu(), c.x, **TOL)
    hosts = _build_arrivals(stream, t=16, device="cpu")
    server = RungServer(max_batch=3, max_delay=1e-3, device=cuda)
    server.start()
    futs, errors = [None] * len(hosts), []

    def client(j):
        try:
            for i in range(j, len(hosts), 3):
                _, m, b, _ = hosts[i]
                mc = BandedCTSF(m.grid, *(x.to(cuda) for x in m.arrays()))
                futs[i] = server.submit(mc, b.to(cuda))
        except Exception as err:
            errors.append(repr(err))

    clients = [threading.Thread(target=client, args=(j,)) for j in range(3)]
    for c in clients:
        c.start()
    for c in clients:
        c.join(timeout=60)
    try:
        assert not errors and all(f is not None for f in futs)
        tres = [f.result(timeout=60) for f in futs]
    finally:
        server.stop(timeout=60)
    for r, c in zip(tres, cres):
        assert r.status == STATUS_OK
        torch.testing.assert_close(r.x.cpu(), c.x, **TOL)


@pytest.fixture
def four_cards(cuda):
    if torch.cuda.device_count() < 4:
        pytest.skip("needs four CUDA devices (NCCL takes one rank a card)")
    return cuda


def test_nccl_collectives_across_cards(four_cards):
    """The collectives over NCCL, a rank a card, device to device: the
    tree the same bits on every rank and the sum of the rows, the ring and
    the quantized sum, the gather in rank order.  The rows are tiles: on
    the card the butterfly's and the ring's adds are the geadd kernel's."""
    ranks, run_local = _ranks()
    rng = np.random.default_rng(0)
    data = torch.from_numpy(rng.standard_normal((4, 3, 8, 8)).astype(np.float32))
    qdata = torch.from_numpy(rng.standard_normal((4, 64)).astype(np.float32))
    outs = run_local(ranks.collectives, data, qdata, "cuda", world_size=4, backend="nccl",
                     device_type="cuda", timeout=300)
    for o in outs:
        torch.testing.assert_close(o["tree"], data.sum(0), rtol=1e-6, atol=1e-6)
        assert torch.equal(o["tree"], outs[0]["tree"])
        torch.testing.assert_close(o["ring"], data.sum(0), rtol=1e-6, atol=1e-6)
        q = qdata.sum(0)
        assert float((o["quantized"] - q).abs().max() / q.abs().max()) < 0.02
        assert torch.equal(o["gather"], data) and o["launches"] == {"geadd": 2}


def test_nccl_distributed_factorize_across_cards(four_cards):
    """``distributed_factorize`` over NCCL on four cards: panels bit for
    bit the fused factor's, the corner the same bits on every rank."""
    ranks, run_local = _ranks()
    A, st = make_arrowhead(16 * 16 + 16, 16, 16, rho=0.0, seed=3)
    m = BandedCTSF.from_sparse(A, TileGrid(st, t=16), device="cpu")
    outs = run_local(ranks.distributed, m, 4, (1, 4), "model", "cuda", world_size=4,
                     backend="nccl", device_type="cuda", timeout=300)
    f = factorize_window(BandedCTSF.from_sparse(A, TileGrid(st, t=16), device=four_cards))
    C = f.ctsf.C.cpu()
    for o in outs:
        assert torch.equal(o["full"][0], f.ctsf.Dr.cpu()) and torch.equal(o["full"][1],
                                                                          f.ctsf.R.cpu())
        assert torch.equal(o["C"], outs[0]["C"])
        torch.testing.assert_close(o["C"], C, rtol=0, atol=1e-5 * float(C.abs().max()))
        assert o["launches"] == {"band_cholesky_sweep": 1, "geadd": 2, "potrf": 1, "trsm": 1}


@pytest.mark.parametrize("r", [8, 32])
@pytest.mark.parametrize("band", [1, 2])
@pytest.mark.parametrize("n_layers", [2, 12])
def test_arrowhead_factorize_and_precondition_on_the_card(cuda, r, band, n_layers):
    """The arrowhead preconditioner's ``factorize`` (the fused sweep, the
    corner's potrf and trsm) and ``precondition`` (both band-solve sweeps,
    the corner's solve_panel) on the card against the same calls with
    ``impl="ref"`` on the card, rtol = atol = 2e-4 (relative to each
    array's max); band 2 over 2 layers clips the band to ``bt = ndt - 1``."""
    from repro_torch import pytree
    from repro_torch.optim.arrowhead import build_precond
    g = torch.Generator(device=cuda).manual_seed(r + band + n_layers)
    shapes = {"embed": (64, 24), "final_norm": {"scale": (24,)},
              "layers": {"w": (n_layers, 24, 40), "b": (n_layers, 40)}}

    def rand():
        return {k: (torch.randn(v, generator=g, device=cuda) if isinstance(v, tuple) else
                    {kk: torch.randn(vv, generator=g, device=cuda) for kk, vv in v.items()})
                for k, v in shapes.items()}

    params = rand()
    pre = build_precond(params, r=r, band=band, ema=0.5, damping=1e-2)
    state = pre.init_state(cuda)
    for _ in range(3):
        grads = rand()
        state = pre.update_stats(state, grads)
    f, fr = pre.factorize(state), pre.factorize(state, impl="ref")
    for k in ("Dr", "R", "C"):
        scale = float(fr[k].abs().max())
        torch.testing.assert_close(f[k], fr[k], rtol=2e-4, atol=2e-4 * scale)
    d, dr = pre.precondition(f, grads), pre.precondition(fr, grads, impl="ref")
    for a, b in zip(pytree.leaves(d), pytree.leaves(dr)):
        torch.testing.assert_close(a, b, rtol=2e-4, atol=2e-4 * float(b.abs().max()))
