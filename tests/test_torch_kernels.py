"""The port's kernels module against the JAX package: the band-layout
converters, and the plain versions of potrf, trsm, gemm, syrk, geadd,
solve_panel, the band-Cholesky sweep, the band-solve sweeps and the
selected-inversion sweep against ``repro.kernels.ref`` and against the Pallas kernels in
interpret mode, at rtol = atol = 2e-4 (the tolerance of test_kernels.py;
both sides are float32 and differ only in summation order).  The CUDA
kernels themselves are held to the plain versions on the card by
test_torch_gpu.py and chip_smoke.py."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import BandedCTSF as JBandedCTSF
from repro.core import TileGrid as JTileGrid
from repro.data import make_arrowhead
from repro.kernels import ref as jref
from repro.kernels import ring as jring
from repro.kernels.band_cholesky import band_cholesky_sweep_pallas
from repro.kernels.band_solve import band_backward_sweep_pallas, band_forward_sweep_pallas
from repro.kernels.gemm import geadd_pallas, gemm_pallas, syrk_pallas
from repro.kernels.potrf import potrf_pallas
from repro.kernels.selinv import selinv_sweep_pallas
from repro.kernels.trsm import solve_panel_pallas, trsm_pallas
from repro_torch.kernels import ops, ref, ring
from repro_torch.kernels.band_cholesky import band_cholesky_sweep_cuda
from repro_torch.kernels.band_solve import band_backward_sweep_cuda, band_forward_sweep_cuda
from repro_torch.kernels.gemm import geadd_cuda, gemm_cuda, syrk_cuda
from repro_torch.kernels.potrf import potrf_cuda
from repro_torch.kernels.selinv import selinv_sweep_cuda
from repro_torch.kernels.trsm import solve_panel_cuda, trsm_cuda

TILES = [8, 16, 32, 64]
TOL = dict(rtol=2e-4, atol=2e-4)
# grids (n, bandwidth, arrow, t): a single tile (bt=0), bt=0 with an arrow,
# nat=0 with bt=1, a thick arrow and wide band, a deep band of small tiles,
# and t = 32 and t = 64
GRIDS = [(16, 4, 0, 16), (30, 6, 14, 16), (160, 8, 0, 16), (130, 40, 30, 16),
         (96, 40, 16, 8), (200, 40, 40, 32), (300, 70, 70, 64)]


def _t(x):
    return torch.from_numpy(np.array(x, dtype=np.float32))


def _spd(rng, nb, t):
    a = rng.standard_normal((nb, t, t)).astype(np.float32)
    return a @ a.transpose(0, 2, 1) + t * np.eye(t, dtype=np.float32)


def _band(n, bw, ar, t, seed=0):
    A, st = make_arrowhead(n, bw, ar, rho=0.6, seed=seed)
    bm = JBandedCTSF.from_sparse(A, JTileGrid(st, t=t))
    return np.array(jring.band_row_to_col(bm.Dr)), np.array(bm.R)


@pytest.mark.parametrize("ndt,b1", [(1, 1), (5, 1), (5, 3), (3, 4), (7, 5)])
def test_ring_converters(ndt, b1):
    x = np.random.default_rng(ndt * 10 + b1).standard_normal(
        (ndt, b1, 4, 4)).astype(np.float32)
    np.testing.assert_array_equal(ring.band_row_to_col(_t(x)).numpy(),
                                  np.asarray(jring.band_row_to_col(jnp.asarray(x))))
    np.testing.assert_array_equal(ring.band_col_to_row(_t(x)).numpy(),
                                  np.asarray(jring.band_col_to_row(jnp.asarray(x))))


def test_ring_helpers():
    for n in range(0, 20):
        for c in range(0, 10):
            assert ring.chunk_layout(n, c) == jring.chunk_layout(n, c)
    for bt, t in [(0, 8), (3, 16)]:
        np.testing.assert_array_equal(ring.identity_prefix_panel(bt, t).numpy(),
                                      np.asarray(jring.identity_prefix_panel(bt, t)))
        np.testing.assert_array_equal(ring.eye_tile(t).numpy(),
                                      np.asarray(jring.eye_tile(t)))


@pytest.mark.parametrize("t", TILES)
def test_potrf_ref(rng, t):
    a = _spd(rng, 3, t)
    got = ref.potrf_ref(_t(a)).numpy()
    for i in range(3):
        np.testing.assert_allclose(got[i], np.asarray(jref.potrf_ref(jnp.asarray(a[i]))), **TOL)
    np.testing.assert_allclose(got, np.asarray(potrf_pallas(jnp.asarray(a))), **TOL)


def test_potrf_ref_breakdown_is_nan():
    """A non-PD tile gives a factor whose lower triangle is NaN, as
    jnp.linalg.cholesky does, instead of torch's exception; the PD tiles of
    the batch are unharmed."""
    a = _spd(np.random.default_rng(1), 2, 8)
    a[1, 3, 3] = -50.0
    got = ref.potrf_ref(_t(a)).numpy()
    want = np.asarray(jref.potrf_ref(jnp.asarray(a[1])))
    np.testing.assert_array_equal(np.isnan(got[1]), np.isnan(want))
    assert np.isnan(got[1][np.tril_indices(8)]).all()
    np.testing.assert_allclose(got[0], np.asarray(jref.potrf_ref(jnp.asarray(a[0]))), **TOL)


@pytest.mark.parametrize("t", TILES)
def test_trsm_ref(rng, t):
    l = np.asarray(jref.potrf_ref(jnp.asarray(_spd(rng, 1, t)[0])))
    a = rng.standard_normal((4, t, t)).astype(np.float32)
    got = ref.trsm_ref(_t(l), _t(a)).numpy()
    for i in range(4):
        np.testing.assert_allclose(got[i], np.asarray(jref.trsm_ref(jnp.asarray(l), jnp.asarray(a[i]))),
                                   **TOL)
    np.testing.assert_allclose(got, np.asarray(trsm_pallas(jnp.asarray(l), jnp.asarray(a))), **TOL)


@pytest.mark.parametrize("t", TILES)
def test_gemm_syrk_geadd_ref(rng, t):
    """The task list's tile updates: C - A B^T batched and with one A or B
    broadcast, C - A A^T over the full tile, A + B; against the JAX oracles
    and the Pallas kernels in interpret mode."""
    c, a, b = (rng.standard_normal((3, t, t)).astype(np.float32) for _ in range(3))
    J = jnp.asarray
    for args in ((c, a, b), (c, a[0], b[1]), (c[0], a[1], b[2])):
        got = ref.gemm_ref(*map(_t, args)).numpy()
        if args[0].ndim == 2:
            np.testing.assert_allclose(got, np.asarray(jref.gemm_ref(*map(J, args))), **TOL)
        else:
            np.testing.assert_allclose(
                got, np.asarray(gemm_pallas(*map(J, args), interpret=True)), **TOL)
        torch.testing.assert_close(ops.gemm(*map(_t, args)), _t(got), rtol=0, atol=0)
    got = ref.syrk_ref(_t(c), _t(a)).numpy()
    np.testing.assert_allclose(got, np.asarray(syrk_pallas(J(c), J(a), interpret=True)), **TOL)
    np.testing.assert_allclose(got[1], np.asarray(jref.syrk_ref(J(c[1]), J(a[1]))), **TOL)
    got = ref.geadd_ref(_t(a), _t(b)).numpy()
    np.testing.assert_array_equal(got, np.asarray(geadd_pallas(J(a), J(b), interpret=True)))
    np.testing.assert_array_equal(got, np.asarray(jref.geadd_ref(J(a), J(b))))
    # out= takes the result in place, the dispatcher's plain versions copy
    ct = _t(c)
    want = ref.gemm_ref(ct[1], _t(a[0]), _t(b[0]))
    assert ops.gemm(ct[1], _t(a[0]), _t(b[0]), out=ct[1]).data_ptr() == ct[1].data_ptr()
    torch.testing.assert_close(ct[1], want, rtol=0, atol=0)
    want = ref.syrk_ref(ct[2], _t(a[0]))
    ops.syrk(ct[2], _t(a[0]), out=ct[2])
    torch.testing.assert_close(ct[2], want, rtol=0, atol=0)


@pytest.mark.parametrize("n,bw,ar,t,nchunks", [g + (c,) for g, c in zip(GRIDS, (1, 3, 3, 3, 1, 3, 2))])
def test_band_cholesky_sweep_ref(n, bw, ar, t, nchunks):
    """The plain sweep against the JAX scan oracle and the Pallas kernel:
    panels, factored arrow rows, per-chunk Schur sums and the status word."""
    Ac, R = _band(n, bw, ar, t)
    got = ref.band_cholesky_sweep_ref(_t(Ac), _t(R), nchunks=nchunks)
    want = jref.band_cholesky_sweep_ref(jnp.asarray(Ac), jnp.asarray(R), nchunks=nchunks)
    pallas = band_cholesky_sweep_pallas(jnp.asarray(Ac), jnp.asarray(R), nchunks=nchunks,
                                        interpret=True)
    for g, w, p, name in zip(got, want, pallas, ("panels", "R_out", "schur", "status")):
        assert tuple(g.shape) == w.shape == p.shape, name
        np.testing.assert_allclose(g.numpy(), np.asarray(w), err_msg=name, **TOL)
        np.testing.assert_allclose(g.numpy(), np.asarray(p), err_msg=name, **TOL)
    # the dispatcher takes the plain version for CPU tensors
    for g, d in zip(got, ops.band_cholesky_sweep(_t(Ac), _t(R), nchunks=nchunks)):
        torch.testing.assert_close(g, d, rtol=0, atol=0)


@pytest.mark.parametrize("start_tile", [2, 5])
def test_band_cholesky_sweep_start_tile(start_tile):
    """Prefix columns emit identity panels and zero arrow rows; the rest
    matches both JAX backends."""
    Ac, R = _band(96, 16, 8, 8)
    ndt, b1, t, _ = Ac.shape
    pad = np.zeros((start_tile, b1, t, t), np.float32)
    Ac = np.concatenate([pad, Ac])
    R = np.concatenate([np.zeros((start_tile,) + R.shape[1:], np.float32), R])
    got = ref.band_cholesky_sweep_ref(_t(Ac), _t(R), nchunks=3, start_tile=start_tile)
    st = jnp.asarray(start_tile, jnp.int32)
    want = jref.band_cholesky_sweep_ref(jnp.asarray(Ac), jnp.asarray(R), nchunks=3, start_tile=st)
    pallas = band_cholesky_sweep_pallas(jnp.asarray(Ac), jnp.asarray(R), nchunks=3,
                                        start_tile=st, interpret=True)
    for g, w, p, name in zip(got, want, pallas, ("panels", "R_out", "schur", "status")):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), err_msg=name, **TOL)
        np.testing.assert_allclose(g.numpy(), np.asarray(p), err_msg=name, **TOL)
    panels = got[0].numpy()
    np.testing.assert_array_equal(panels[:start_tile, 0],
                                  np.broadcast_to(np.eye(t), (start_tile, t, t)))
    assert np.abs(panels[:start_tile, 1:]).max() == 0.0
    assert np.abs(got[1].numpy()[:start_tile]).max() == 0.0


@pytest.mark.parametrize("n,bw,ar,t", [(130, 40, 30, 16), (96, 40, 16, 8), (16, 4, 0, 16)])
def test_band_cholesky_sweep_breakdown_status(n, bw, ar, t):
    """An indefinite diagonal tile is flagged with the same nonfinite bit
    and first failing column as both JAX backends, and the same pivot."""
    Ac, R = _band(n, bw, ar, t)
    bad = Ac.shape[0] // 2
    Ac[bad, 0] -= 10.0 * np.abs(np.diagonal(Ac[:, 0], axis1=-2, axis2=-1)).mean() * np.eye(t, dtype=np.float32)
    got = ref.band_cholesky_sweep_ref(_t(Ac), _t(R))[3].numpy()
    want = np.asarray(jref.band_cholesky_sweep_ref(jnp.asarray(Ac), jnp.asarray(R))[3])
    pallas = np.asarray(band_cholesky_sweep_pallas(jnp.asarray(Ac), jnp.asarray(R),
                                                   interpret=True)[3])
    assert got[1] == want[1] == pallas[1] == 1.0
    assert got[2] == want[2] == pallas[2]
    assert 0 <= got[2] <= bad
    np.testing.assert_allclose(got[0], want[0], rtol=2e-4, atol=1e-6)
    np.testing.assert_allclose(got[0], pallas[0], rtol=2e-4, atol=1e-6)


def test_sweep_status_matches_reference():
    rng = np.random.default_rng(3)
    panels = rng.standard_normal((6, 3, 8, 8)).astype(np.float32)
    r_out = rng.standard_normal((6, 2, 8, 8)).astype(np.float32)
    panels[2, 1, 0, 0] = np.nan
    panels[4, 0, 3, 3] = 0.0
    r_out[5, 0, 1, 1] = np.inf
    np.testing.assert_array_equal(ref.sweep_status(_t(panels), _t(r_out)).numpy(),
                                  np.asarray(jref.sweep_status(jnp.asarray(panels),
                                                               jnp.asarray(r_out))))
    np.testing.assert_array_equal(ref.empty_sweep_status().numpy(),
                                  np.asarray(jref.empty_sweep_status()))


@pytest.mark.parametrize("t", TILES)
@pytest.mark.parametrize("trans", [False, True])
@pytest.mark.parametrize("k", [1, 5, 16])
def test_solve_panel_ref(rng, t, trans, k):
    l = np.asarray(jref.potrf_ref(jnp.asarray(_spd(rng, 1, t)[0])))
    b = rng.standard_normal((2, t, k)).astype(np.float32)
    got = ref.solve_panel_ref(_t(l), _t(b), trans=trans).numpy()
    for i in range(2):
        np.testing.assert_allclose(got[i], np.asarray(jref.solve_panel_ref(
            jnp.asarray(l), jnp.asarray(b[i]), trans=trans)), **TOL)
    np.testing.assert_allclose(got, np.asarray(solve_panel_pallas(
        jnp.asarray(l), jnp.asarray(b), trans=trans, interpret=True)), **TOL)
    # the dispatcher's plain version for CPU tensors
    torch.testing.assert_close(ops.solve_panel(_t(l), _t(b), trans=trans),
                               ref.solve_panel_ref(_t(l), _t(b), trans=trans), rtol=0, atol=0)


def _band_factor(rng, ndt, bt, nat, t):
    """Random row-band factor tiles with the BandedCTSF conventions, as
    test_kernels.py makes them: well-conditioned lower-triangular diagonal
    tiles, structural zeros above the band."""
    Dr = rng.standard_normal((ndt, bt + 1, t, t)).astype(np.float32)
    for m in range(ndt):
        Dr[m, 0] = np.tril(Dr[m, 0]) + t * np.eye(t)
        Dr[m, min(m, bt) + 1:] = 0.0
    return Dr, rng.standard_normal((ndt, nat, t, t)).astype(np.float32)


# (ndt, bt, nat, start_tile, k): one tile (bt = 0), no arrow, a wider band,
# a deep band, and start_tile > 0 with and without an arrow, each at one
# of k = 1 and k = 13
SOLVE_SWEEPS = [(1, 0, 0, 0, 1), (5, 1, 0, 0, 13), (6, 2, 2, 0, 1), (9, 4, 1, 0, 13),
                (9, 4, 1, 0, 1), (7, 2, 1, 3, 13), (6, 0, 2, 2, 1), (5, 3, 0, 1, 13)]


@pytest.mark.parametrize("ndt,bt,nat,start_tile,k", SOLVE_SWEEPS)
def test_band_solve_sweeps_ref(rng, ndt, bt, nat, start_tile, k):
    """Both band sweeps' plain versions against the JAX oracles and the
    Pallas kernels; the rows before start_tile come out zero."""
    t = 8
    Dr, R = _band_factor(rng, ndt, bt, nat, t)
    bd = rng.standard_normal((ndt, t, k)).astype(np.float32)
    bd[:start_tile] = 0.0
    xa = rng.standard_normal((nat, t, k)).astype(np.float32)
    jargs = (jnp.asarray(Dr), jnp.asarray(R), jnp.asarray(bd))
    st = jnp.asarray(start_tile, jnp.int32)
    got = ref.band_forward_sweep_ref(_t(Dr), _t(R), _t(bd), start_tile)
    for want in (jref.band_forward_sweep_ref(*jargs, start_tile),
                 band_forward_sweep_pallas(*jargs, start_tile=st, interpret=True)):
        for g, w, name in zip(got, want, ("yd", "acc_a")):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), err_msg=name, **TOL)
    assert np.abs(got[0].numpy()[:start_tile]).max(initial=0.0) == 0.0
    got = ref.band_backward_sweep_ref(_t(Dr), _t(R), _t(bd), _t(xa), start_tile)
    for want in (jref.band_backward_sweep_ref(*jargs, jnp.asarray(xa), st),
                 band_backward_sweep_pallas(*jargs, jnp.asarray(xa), start_tile=st,
                                            interpret=True)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert np.abs(got.numpy()[:start_tile]).max(initial=0.0) == 0.0
    # the dispatcher takes the plain versions for CPU tensors
    for g, d in zip(ref.band_forward_sweep_ref(_t(Dr), _t(R), _t(bd), start_tile),
                    ops.band_forward_sweep(_t(Dr), _t(R), _t(bd), start_tile)):
        torch.testing.assert_close(g, d, rtol=0, atol=0)
    torch.testing.assert_close(got, ops.band_backward_sweep(_t(Dr), _t(R), _t(bd), _t(xa),
                                                            start_tile), rtol=0, atol=0)


def _selinv_inputs(n, bw, ar, t, pad=0):
    """The reference factor's column view, arrow rows and full corner Σ,
    with ``pad`` identity-prefix columns in front (a canonical-grid
    embedding, as test_kernels.py builds it)."""
    from repro.core import SolverOptions as JSolverOptions
    from repro.core import embed_ctsf, factorize_window
    A, st = make_arrowhead(n, bw, ar, rho=0.6, seed=0)
    grid = JTileGrid(st, t=t)
    bm = JBandedCTSF.from_sparse(A, grid)
    if pad:
        grid = JTileGrid.from_tile_counts(t, grid.n_diag_tiles + pad, grid.band_tiles,
                                          grid.n_arrow_tiles)
        bm = embed_ctsf(bm, grid)
    f = factorize_window(bm, options=JSolverOptions(impl="ref")).ctsf
    nat = grid.n_arrow_tiles
    nc = nat * t
    w = np.linalg.inv(np.asarray(f.C).transpose(0, 2, 1, 3).reshape(nc, nc).astype(np.float64))
    sc = (w.T @ w).reshape(nat, t, nat, t).transpose(0, 2, 1, 3).astype(np.float32)
    return np.asarray(jring.band_row_to_col(f.Dr)), np.asarray(f.R), sc


@pytest.mark.parametrize("n,bw,ar,t,pad", [(96, 16, 8, 8, 3), (130, 40, 30, 16, 0),
                                           (160, 8, 0, 16, 2), (16, 4, 0, 16, 0)])
def test_selinv_sweep_ref(n, bw, ar, t, pad):
    """The plain Takahashi sweep against the JAX oracle and the Pallas
    kernel; identity-prefix columns emit identity Σ panels."""
    lcol, R, sc = _selinv_inputs(n, bw, ar, t, pad)
    got = ref.selinv_sweep_ref(_t(lcol), _t(R), _t(sc), start_tile=pad)
    st = jnp.asarray(pad, jnp.int32)
    jargs = (jnp.asarray(lcol), jnp.asarray(R), jnp.asarray(sc))
    for want in (jref.selinv_sweep_ref(*jargs, start_tile=st),
                 selinv_sweep_pallas(*jargs, start_tile=st, interpret=True)):
        for g, w, name in zip(got, want, ("panels", "acols")):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), err_msg=name, **TOL)
    panels = got[0].numpy()
    np.testing.assert_array_equal(panels[:pad, 0], np.broadcast_to(np.eye(t), (pad, t, t)))
    assert np.abs(panels[:pad, 1:]).max(initial=0.0) == 0.0
    for g, d in zip(got, ops.selinv_sweep(_t(lcol), _t(R), _t(sc), start_tile=pad)):
        torch.testing.assert_close(g, d, rtol=0, atol=0)


def test_selinv_step_ref(rng):
    s = rng.standard_normal((3, 5, 8, 8)).astype(np.float32)
    g = rng.standard_normal((5, 8, 8)).astype(np.float32)
    np.testing.assert_allclose(ref.selinv_step_ref(_t(s), _t(g)).numpy(),
                               np.asarray(jref.selinv_step_ref(jnp.asarray(s), jnp.asarray(g))),
                               **TOL)


def test_gemm_cuda_refuses_operands_that_do_not_broadcast():
    """gemm/syrk accept what broadcasts against C and nothing else, on the
    card as in the plain version: a batch of C's size in another shape is
    refused before any launch."""
    rng = np.random.default_rng(0)
    c = _t(rng.standard_normal((2, 3, 8, 8)).astype(np.float32))
    a = _t(rng.standard_normal((3, 2, 8, 8)).astype(np.float32))
    for call in (lambda: gemm_cuda(c, a, c), lambda: gemm_cuda(c, c, a),
                 lambda: syrk_cuda(c, a), lambda: gemm_cuda(c[0], c, c[0])):
        with pytest.raises(ValueError, match="broadcast"):
            call()
    for call in (lambda: ref.gemm_ref(c, a, c), lambda: ref.syrk_ref(c, a)):
        with pytest.raises(RuntimeError):
            call()


def test_cuda_wrappers_refuse_cpu_tensors():
    """The kernel wrappers never compute on the CPU, and the dispatcher
    never sends a CPU tensor to them on its own."""
    a = _t(_spd(np.random.default_rng(0), 1, 8)[0])
    t4, p = a[None, None], a[None]
    for call in (lambda: potrf_cuda(a), lambda: trsm_cuda(a, a),
                 lambda: band_cholesky_sweep_cuda(t4, t4),
                 lambda: solve_panel_cuda(a, a), lambda: band_forward_sweep_cuda(t4, t4, p),
                 lambda: band_backward_sweep_cuda(t4, t4, p, p),
                 lambda: selinv_sweep_cuda(t4, t4, t4),
                 lambda: ops.potrf(a, impl="cuda"), lambda: ops.solve_panel(a, a, impl="cuda"),
                 lambda: ops.band_forward_sweep(t4, t4, p, impl="cuda"),
                 lambda: ops.band_backward_sweep(t4, t4, p, p, impl="cuda"),
                 lambda: ops.selinv_sweep(t4, t4, t4, impl="cuda"),
                 lambda: gemm_cuda(a, a, a), lambda: syrk_cuda(a, a), lambda: geadd_cuda(p, p),
                 lambda: ops.gemm(a, a, a, impl="cuda"), lambda: ops.syrk(a, a, impl="cuda"),
                 lambda: ops.geadd(a, a, impl="cuda"), lambda: ops.potrf(a, impl="cuda", out=a)):
        with pytest.raises(ValueError, match="CUDA"):
            call()
    with pytest.raises(ValueError, match="impl"):
        ops.trsm(a, a, impl="pallas")
    kernels = (potrf_cuda, trsm_cuda, band_cholesky_sweep_cuda, solve_panel_cuda,
               band_forward_sweep_cuda, band_backward_sweep_cuda, selinv_sweep_cuda,
               gemm_cuda, syrk_cuda, geadd_cuda)
    before = [k.launches for k in kernels]
    ops.potrf(a), ops.trsm(a, a), ops.band_cholesky_sweep(t4, t4), ops.solve_panel(a, a)
    ops.band_forward_sweep(t4, t4, p), ops.band_backward_sweep(t4, t4, p, p)
    ops.selinv_sweep(t4, t4, t4), ops.gemm(a, a, a), ops.syrk(a, a), ops.geadd(p, p)
    assert [k.launches for k in kernels] == before
