"""The port's θ-batch read-out against the JAX package, on the CPU:
``solve_many_batched`` and ``selinv_batched`` on a batched factor from
``factorize_window_batched`` (clean, and recovered by ``regularize=``),
against the reference's (``impl="ref"``, ``bucket=False``) and against the
port's unbatched calls on each element, at rtol = atol = 2e-4; the
reference's input errors; ``SelectedInverse.diagonal`` and ``covariance``
on a batched Σ; the batched plain kernels against loops of unbatched ones,
bit for bit; and the corner graph's key with a batch axis.

The batch is an INLA θ-sweep, ``A_θ = τ_θ A + δ_θ I`` for one sparsity
pattern, made with numpy from a seed.  A recovered batch has one element
made indefinite (a band diagonal tile dropped by 10 times the band's mean
|diagonal|, as the reference's ``tests/test_robustness.py::_corrupt_diag``).

A fault of the reference shows here: ``solve_many_batched`` decides
whether to refine with ``np.asarray(info.tau).max() > 0``, and a FAILED
element's tau is NaN (its Gershgorin rung on a NaN input), so a batch with
a NaN element is never refined.  The port refines wherever some element
has ``tau > 0``; that case is held to the port's unbatched refined solve."""
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import repro.core as J
from repro_torch.core import (STATUS_FAILED, STATUS_OK, STATUS_RECOVERED, BandedCTSF,
                              CholeskyFactor, FactorInfo, SelectedInverse, SolverOptions,
                              TileGrid, factorize_window_batched, selected_inverse, selinv_batched,
                              solve_many, solve_many_batched)
from repro_torch.core.solve import corner_graph_key
from repro_torch.data import make_arrowhead
from repro_torch.kernels import ref

TOL = dict(rtol=2e-4, atol=2e-4)
B = 4
# (n, bandwidth, arrow, t): nat = 1 at t = 8 and at t = 16
GRIDS = [(96, 16, 8, 8), (240, 24, 16, 16)]
KS = [1, 5]
REG = SolverOptions(regularize=True)
JREG = J.SolverOptions(regularize=True, impl="ref")


def _theta(n, bw, ar, t, seed=0):
    """B θ-candidates of one matrix, stacked (port layout)."""
    A, st = make_arrowhead(n, bw, ar, rho=0.6, seed=seed)
    rng = np.random.default_rng(seed)
    tau, delta = rng.uniform(0.5, 2.0, B), rng.uniform(0.0, 0.5, B)
    eye = sp.identity(A.shape[0], format="csr")
    mats = [BandedCTSF.from_sparse((tau[i] * A + delta[i] * eye).tocsr(), TileGrid(st, t),
                                   device="cpu") for i in range(B)]
    return BandedCTSF(mats[0].grid, *(torch.stack(x) for x in zip(*(m.arrays() for m in mats))))


def _recovered(mb, nan=False):
    """Element 1 indefinite; with ``nan`` element 2 also carries a NaN on an
    arrow row's structural nonzero."""
    Dr, R, C = (x.clone() for x in mb.arrays())
    d = torch.diagonal(Dr[1, :, 0], dim1=-2, dim2=-1)
    Dr[1, mb.grid.n_diag_tiles // 2, 0] -= 10.0 * d.abs().mean() * torch.eye(mb.grid.t)
    if nan:
        R[2, -1, 0, 0, 1] = float("nan")
    return BandedCTSF(mb.grid, Dr, R, C)


def _jctsf(m):
    return J.BandedCTSF(m.grid, *(jnp.asarray(x.numpy()) for x in m.arrays()))


def _rhs(grid, k, seed=1):
    """(B, padded_n, k) panels, zero in the padding."""
    Bn = np.random.default_rng(seed).standard_normal((B, grid.padded_n, k)).astype(np.float32)
    s = grid.structure
    Bn[:, s.n_diag:grid.n_diag_tiles * grid.t] = 0.0
    Bn[:, grid.n_diag_tiles * grid.t + s.arrow:] = 0.0
    return Bn


def _element(f, i):
    """Element ``i`` of a batched factor as a factor of its own, its
    FactorInfo (and kept matrix) sliced alike."""
    c = f.ctsf
    info = None
    if f.info is not None:
        m = f.info.matrix
        info = FactorInfo(*(getattr(f.info, k)[i] for k in (
            "status", "attempts", "tau", "min_pivot", "first_bad_tile")),
            matrix=None if m is None else BandedCTSF(m.grid, *(x[i] for x in m.arrays())))
    return CholeskyFactor(BandedCTSF(c.grid, *(x[i] for x in c.arrays())), f.status[i], info)


@pytest.mark.parametrize("n,bw,ar,t", GRIDS)
@pytest.mark.parametrize("k", KS)
@pytest.mark.parametrize("recovered", [False, True])
def test_solve_many_batched_matches_reference(n, bw, ar, t, k, recovered):
    """Each element against the reference's batched solve and against the
    port's unbatched ``solve_many`` on that element (the recovered one
    refined against its kept matrix)."""
    clean = _theta(n, bw, ar, t)
    mb = _recovered(clean) if recovered else clean
    f = factorize_window_batched(mb, options=REG)
    jf = J.factorize_window_batched(_jctsf(mb), bucket=False, options=JREG)
    assert f.info.status.tolist() == [STATUS_OK, STATUS_RECOVERED if recovered else STATUS_OK,
                                      STATUS_OK, STATUS_OK]
    Bn = _rhs(mb.grid, k)
    X = solve_many_batched(f, torch.from_numpy(Bn))
    assert X.shape == (B, mb.grid.padded_n, k)
    jX = np.asarray(J.solve_many_batched(jf, jnp.asarray(Bn), bucket=False,
                                         options=J.SolverOptions(impl="ref")))
    np.testing.assert_allclose(X.numpy(), jX, **TOL)
    for i in range(B):
        one = solve_many(_element(f, i), torch.from_numpy(Bn[i]))
        torch.testing.assert_close(X[i], one, **TOL)


@pytest.mark.parametrize("n,bw,ar,t", GRIDS)
@pytest.mark.parametrize("k", KS)
def test_recovered_batch_refines_only_the_recovered_element(n, bw, ar, t, k):
    """In a recovered batch the refinement pass touches the recovered
    element alone: the clean elements are bit for bit the clean batch's
    (and an unrefined call's), and the recovered element's residual
    against its original matrix is at most the unrefined one's in every
    column (here the original is indefinite, so the step is refused
    column by column and nothing gets worse)."""
    clean = _theta(n, bw, ar, t)
    mb = _recovered(clean)
    Bn = torch.from_numpy(_rhs(mb.grid, k))
    f = factorize_window_batched(mb, options=REG)
    X = solve_many_batched(f, Bn)
    X0 = solve_many_batched(factorize_window_batched(clean, options=REG), Bn)
    unrefined = solve_many_batched(CholeskyFactor(f.ctsf, f.status), Bn)
    for i in (0, 2, 3):
        assert torch.equal(X[i], X0[i]) and torch.equal(X[i], unrefined[i])
    A1 = np.asarray(BandedCTSF(mb.grid, *(x[1] for x in mb.arrays())).to_dense(
        lower_only=False), np.float64)
    r = lambda Y: np.linalg.norm(A1 @ Y[1].numpy().astype(np.float64) - Bn[1].numpy(), axis=0)
    assert (r(X) <= r(unrefined)).all()


def _jittered_batch(nan=False):
    """A clean θ-batch whose element 1 is factorized as ``A_1 + tau I``,
    tau half of A_1's smallest eigenvalue (so one refinement step
    contracts every residual mode by at most 1/3), with the FactorInfo a
    ladder would give it and the originals kept; with ``nan`` element 2's
    factor is NaN and its tau NaN, as a FAILED element's.  Returns the
    factor, its unrefined twin and the originals."""
    from repro_torch.core.robustness import add_diagonal_jitter
    mb = _theta(96, 16, 8, 8)
    g = mb.grid
    a1 = np.asarray(BandedCTSF(g, *(x[1] for x in mb.arrays())).to_dense(lower_only=False),
                    np.float64)
    tau = torch.zeros(B)
    tau[1] = 0.5 * float(np.linalg.eigvalsh(a1).min())
    Dr, C = add_diagonal_jitter(mb.Dr, mb.C, g, tau)
    f = factorize_window_batched(BandedCTSF(g, Dr, mb.R, C))
    arrays = list(f.ctsf.arrays())
    if nan:
        tau[2] = float("nan")
        arrays = [x.clone() for x in arrays]
        arrays[0][2] = float("nan")
    status = torch.tensor([STATUS_OK, STATUS_RECOVERED, STATUS_FAILED if nan else STATUS_OK,
                           STATUS_OK], dtype=torch.int32)
    info = FactorInfo(status, torch.tensor([1, 2, 5 if nan else 1, 1], dtype=torch.int32), tau,
                      f.status[:, 0], torch.tensor([-1, 0, -1, -1], dtype=torch.int32), mb)
    ctsf = BandedCTSF(g, *arrays)
    return CholeskyFactor(ctsf, f.status, info), CholeskyFactor(ctsf, f.status), mb


@pytest.mark.parametrize("nan", [False, True])
def test_batched_refinement_helps_a_jittered_element(nan):
    """The batched mirror of the reference's refinement test: the jittered
    element's residual against its original matrix is at most the
    unrefined one's in every column and its largest under 0.6 of the
    unrefined largest, as its unbatched refined solve gives it; the other
    elements bit for bit an unrefined call's.  With a FAILED element
    (tau NaN) beside it the jittered element is still refined (the
    reference's ``tau.max() > 0`` is NaN there and refines nothing)."""
    f, plain, mb = _jittered_batch(nan)
    Bn = torch.from_numpy(_rhs(mb.grid, 3))
    X, X0 = solve_many_batched(f, Bn), solve_many_batched(plain, Bn)
    for i in (0, 2, 3):
        assert torch.equal(X[i], X0[i]) or (nan and i == 2)
    torch.testing.assert_close(X[1], solve_many(_element(f, 1), Bn[1]), **TOL)
    a1 = np.asarray(BandedCTSF(mb.grid, *(x[1] for x in mb.arrays())).to_dense(
        lower_only=False), np.float64)
    r = lambda Y: np.linalg.norm(a1 @ Y[1].numpy().astype(np.float64) - Bn[1].numpy(), axis=0)
    assert (r(X) <= r(X0)).all() and r(X).max() < 0.6 * r(X0).max()
    if not nan:
        jinfo = J.FactorInfo(*(jnp.asarray(getattr(f.info, k).numpy()) for k in (
            "status", "attempts", "tau", "min_pivot", "first_bad_tile")), matrix=_jctsf(mb))
        from repro.core.cholesky import CholeskyFactor as JCholeskyFactor
        jf = JCholeskyFactor(_jctsf(f.ctsf), info=jinfo)
        jX = np.asarray(J.solve_many_batched(jf, jnp.asarray(Bn.numpy()), bucket=False,
                                             options=J.SolverOptions(impl="ref")))
        np.testing.assert_allclose(X.numpy(), jX, **TOL)


def test_refinement_beside_a_failed_element_leaves_the_clean_ones():
    """A recovered batch with a FAILED element (tau NaN) beside the
    recovered one: the clean elements are bit for bit the clean batch's,
    the recovered element as its unbatched (refined) solve."""
    clean = _theta(96, 16, 8, 8)
    mb = _recovered(clean, nan=True)
    f = factorize_window_batched(mb, options=REG)
    assert f.info.status.tolist() == [STATUS_OK, STATUS_RECOVERED, STATUS_FAILED, STATUS_OK]
    assert torch.isnan(f.info.tau[2])
    Bn = torch.from_numpy(_rhs(mb.grid, 5))
    X = solve_many_batched(f, Bn)
    torch.testing.assert_close(X[1], solve_many(_element(f, 1), Bn[1]), **TOL)
    X0 = solve_many_batched(factorize_window_batched(clean), Bn)
    for i in (0, 3):
        assert torch.equal(X[i], X0[i])


def test_solve_many_batched_refuses_what_the_reference_refuses():
    mb = _theta(96, 16, 8, 8)
    f = factorize_window_batched(mb)
    jf = J.factorize_window_batched(_jctsf(mb), bucket=False,
                                    options=J.SolverOptions(impl="ref"))
    g = mb.grid
    one = CholeskyFactor(BandedCTSF(g, *(x[0] for x in mb.arrays())))
    jone = J.factorize_window(J.BandedCTSF(g, *(jnp.asarray(x[0].numpy()) for x in mb.arrays())),
                              options=J.SolverOptions(impl="ref"))
    with pytest.raises(ValueError, match="batched factor"):
        solve_many_batched(one, torch.zeros((B, g.padded_n, 2)))
    with pytest.raises(ValueError, match="batched factor"):
        J.solve_many_batched(jone, jnp.zeros((B, g.padded_n, 2)))
    for shape in ((B, g.padded_n), (B - 1, g.padded_n, 2), (B, g.padded_n + 1, 2)):
        with pytest.raises(ValueError, match="rhs panels"):
            solve_many_batched(f, torch.zeros(shape))
        with pytest.raises(ValueError, match="rhs panels"):
            J.solve_many_batched(jf, jnp.zeros(shape))
    with pytest.raises(TypeError):
        solve_many_batched(f, torch.zeros((B, g.padded_n, 2)), False)
    X = solve_many_batched(f, torch.zeros((B, g.padded_n, 2)), bucket=False)
    assert X.shape == (B, g.padded_n, 2) and not X.any()


@pytest.mark.parametrize("n,bw,ar,t", GRIDS)
@pytest.mark.parametrize("recovered", [False, True])
def test_selinv_batched_matches_reference(n, bw, ar, t, recovered):
    """Each element against ``selected_inverse`` on it and against the
    reference's ``selinv_batched``; ``diagonal()`` (padded and not) and
    ``covariance(i, j)`` broadcast over the batch as the reference's do."""
    mb = _theta(n, bw, ar, t)
    mb = _recovered(mb) if recovered else mb
    f = factorize_window_batched(mb, options=REG)
    jf = J.factorize_window_batched(_jctsf(mb), bucket=False, options=JREG)
    sig = selinv_batched(f)
    jsig = J.selinv_batched(jf, bucket=False, options=J.SolverOptions(impl="ref"))
    for a, b in zip(sig.arrays(), jsig.arrays()):
        assert a.shape[0] == B
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)
    for i in range(B):
        one = selected_inverse(_element(f, i))
        for a, b in zip(sig.arrays(), one.arrays()):
            torch.testing.assert_close(a[i], b, **TOL)
    s = mb.grid.structure
    for padded in (False, True):
        d = sig.diagonal(padded=padded)
        assert d.shape == (B, mb.grid.padded_n if padded else s.n)
        np.testing.assert_allclose(d.numpy(), np.asarray(jsig.diagonal(padded=padded)), **TOL)
    for i, j in ((0, 0), (3, 1), (s.n - 1, 0), (s.n - 1, s.n - 2), (s.n // 2, s.n // 2 - 1)):
        c = sig.covariance(i, j)
        assert c.shape == (B,)
        np.testing.assert_allclose(c.numpy(), np.asarray(jsig.covariance(i, j)), **TOL)


def test_selected_inverse_accessors_take_a_batch():
    """``SelectedInverse.diagonal`` and ``covariance`` on a Σ with a leading
    batch axis index from the right, one row (value) an element, each
    element what the unbatched Σ gives."""
    mb = _theta(96, 16, 8, 8)
    f = factorize_window_batched(mb)
    sigmas = [selected_inverse(_element(f, i)) for i in range(B)]
    stacked = SelectedInverse(mb.grid, *(torch.stack(x) for x in zip(
        *(s.arrays() for s in sigmas))))
    n = mb.grid.structure.n
    assert stacked.diagonal().shape == (B, n)
    for i, s in enumerate(sigmas):
        assert torch.equal(stacked.diagonal()[i], s.diagonal())
        assert torch.equal(stacked.diagonal(padded=True)[i], s.diagonal(padded=True))
        for a, b in ((0, 1), (n - 1, 2), (n - 1, n - 1), (40, 37)):
            assert torch.equal(stacked.covariance(a, b)[i], s.covariance(a, b))
    with pytest.raises(ValueError, match="leading batch axis"):
        selinv_batched(_element(f, 0))


@pytest.mark.parametrize("ndt,bt,nat", [(5, 1, 0), (6, 2, 2), (9, 4, 1)])
def test_batched_plain_kernels_are_loops_of_unbatched_calls(ndt, bt, nat):
    """The plain band sweeps, selinv sweep and pre-pass and solve_panel
    (one L a panel) on a batch of three: bit for bit a loop of unbatched
    plain calls."""
    t, nb = 8, 3
    rng = np.random.default_rng(10 * ndt + bt)
    Dr = torch.from_numpy(rng.standard_normal((nb, ndt, bt + 1, t, t)).astype(np.float32))
    Dr[:, :, 0] = torch.from_numpy(np.tril(rng.standard_normal((nb, ndt, t, t))).astype(
        np.float32)) + t * torch.eye(t)
    R = torch.from_numpy(rng.standard_normal((nb, ndt, nat, t, t)).astype(np.float32))
    sc = torch.from_numpy(rng.standard_normal((nb, nat, nat, t, t)).astype(np.float32))
    bd = torch.from_numpy(rng.standard_normal((nb, ndt, t, 3)).astype(np.float32))
    xa = torch.from_numpy(rng.standard_normal((nb, nat, t, 3)).astype(np.float32))
    for start in (0, 2):
        yd, acca = ref.band_forward_sweep_ref(Dr, R, bd, start)
        xd = ref.band_backward_sweep_ref(Dr, R, bd, xa, start)
        panels, acols = ref.selinv_sweep_ref(Dr, R, sc, start)
        work = ref.selinv_prepass_ref(Dr, R, sc, start)
        for i in range(nb):
            y1, a1 = ref.band_forward_sweep_ref(Dr[i], R[i], bd[i], start)
            assert torch.equal(yd[i], y1) and torch.equal(acca[i], a1)
            assert torch.equal(xd[i], ref.band_backward_sweep_ref(Dr[i], R[i], bd[i], xa[i],
                                                                  start))
            p1, c1 = ref.selinv_sweep_ref(Dr[i], R[i], sc[i], start)
            assert torch.equal(panels[i], p1) and torch.equal(acols[i], c1)
            assert torch.equal(work[i], ref.selinv_prepass_ref(Dr[i], R[i], sc[i], start))
    L = Dr[:, :, 0].reshape(-1, t, t)
    b = torch.from_numpy(rng.standard_normal((nb * ndt, t, 5)).astype(np.float32))
    for trans in (False, True):
        got = ref.solve_panel_ref(L, b, trans)
        for i in range(nb * ndt):
            assert torch.equal(got[i], ref.solve_panel_ref(L[i], b[i], trans))


def test_corner_graph_key_takes_the_batch_shape():
    """A batched corner's key: ``nat`` from ``C.shape[-4]`` (not the
    batch), the leading batch shape appended; unbatched keys stay as
    they were, and two batch sizes are two keys."""
    t, nat, k = 16, 3, 5
    C, panel = torch.zeros((nat, nat, t, t)), torch.zeros((nat, t, k))
    Cb, panelb = torch.zeros((8, nat, nat, t, t)), torch.zeros((8, nat, t, k))
    assert corner_graph_key(C, panel, False) == (t, nat, k, False, "cpu")
    key = corner_graph_key(Cb, panelb, True)
    assert key == (t, nat, k, True, "cpu", 8)
    assert corner_graph_key(Cb[:3], panelb[:3], True) != key
    assert corner_graph_key(Cb[:nat], panelb[:nat], True) != corner_graph_key(C, panel, True)
    assert all(isinstance(x, (int, bool, str)) for x in key)
