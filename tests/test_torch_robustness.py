"""The port's breakdown recovery against the JAX package, on the CPU:
``core/robustness.py`` function for function (``diag_scale``,
``status_ok``, ``add_diagonal_jitter``, ``gershgorin_shift``,
``ctsf_matvec``) on unbatched and batched inputs, ``RegularizePolicy`` and
``SolverOptions(regularize=)``, the jitter ladder of ``factorize_window``
and ``factorize_window_batched`` on the ring, window and partitioned routes
(``impl="ref"`` and ``bucket=False`` on the reference's side), the fault
generators, and the refinement step of ``solve_many``.

Inputs are made with numpy from a seed and fed to both packages.  The port
is held to rtol = atol = 2e-4 (float32, sums in another order), the
applied jitter to 1e-6 relative, and the ladder's integer outcomes
(status, attempts, first bad tile) exactly.  Healthy elements of a
regularized call are held bit for bit to the call without it.

One fault of the reference shows here: its ``gershgorin_shift`` holds an
arrow row's disc against the transposed corner diagonal, which raises
unless ``nat`` is 1 or ``t`` and mixes rows where it does not.  The port
holds each row to its own diagonal entry; it is checked against the
reference without an arrow and against a dense numpy oracle with one, and
against the reference on the ladder's own inputs, where the band's discs
set the shift."""
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import repro.core as J
import repro.core.robustness as JR
from repro.core.cholesky import CholeskyFactor as JCholeskyFactor
from repro.data import indefinite_arrowhead as jindefinite_arrowhead
from repro.data import nan_contaminated_arrowhead as jnan_contaminated_arrowhead
from repro.data import near_singular_arrowhead as jnear_singular_arrowhead
from repro_torch.core import (STATUS_FAILED, STATUS_OK, STATUS_RECOVERED, STATUS_SHED,
                              BandedCTSF, CholeskyFactor, FactorInfo, RegularizePolicy,
                              SolverOptions, TileGrid, detect_partition_plan, factorize_window,
                              factorize_window_batched, solve_many)
from repro_torch.core.robustness import (add_diagonal_jitter, ctsf_matvec, diag_scale,
                                         gershgorin_shift, status_ok)
from repro_torch.data import (block_separable_arrowhead, indefinite_arrowhead, make_arrowhead,
                              nan_contaminated_arrowhead, near_singular_arrowhead)

TOL = dict(rtol=2e-4, atol=2e-4)
# (n, bandwidth, arrow, t): nat = 1 at t = 8 and 16, no arrow, nat = 2
GRIDS = [(96, 16, 8, 8), (240, 24, 16, 16), (160, 8, 0, 16), (96, 16, 16, 8)]
ROUTES = ["ring", "window", "partitioned"]
B = 4


def _pair(A, st, t):
    """One matrix in both packages."""
    return (BandedCTSF.from_sparse(A, TileGrid(st, t), device="cpu"),
            J.BandedCTSF.from_sparse(A, J.TileGrid(st, t)))


def _np(x):
    return np.asarray(x)


def _jctsf(m):
    """The port's BandedCTSF (batched or not) in the JAX package."""
    return J.BandedCTSF(m.grid, *(jnp.asarray(x.numpy()) for x in m.arrays()))


def _theta(n, bw, ar, t, seed=0, rho=0.6):
    """B θ-candidates ``τ A + δ I`` of one matrix, stacked (port layout)."""
    A, st = make_arrowhead(n, bw, ar, rho=rho, seed=seed)
    rng = np.random.default_rng(seed)
    tau, delta = rng.uniform(0.5, 2.0, B), rng.uniform(0.0, 0.5, B)
    eye = sp.identity(A.shape[0], format="csr")
    mats = [BandedCTSF.from_sparse((tau[i] * A + delta[i] * eye).tocsr(), TileGrid(st, t),
                                   device="cpu") for i in range(B)]
    return BandedCTSF(mats[0].grid, *(torch.stack(x) for x in zip(*(m.arrays() for m in mats))))


def _corrupt_diag(Dr, tile, shift=10.0):
    """One band diagonal tile made indefinite, as the reference's
    ``tests/test_robustness.py::_corrupt_diag``: the tile's diagonal
    dropped by ``shift`` times the mean |diagonal| of the band."""
    d = torch.diagonal(Dr[:, 0], dim1=-2, dim2=-1)
    out = Dr.clone()
    out[tile, 0] -= shift * d.abs().mean() * torch.eye(Dr.shape[-1])
    return out


def _one(mb, i):
    """Element ``i`` of a stacked BandedCTSF."""
    return BandedCTSF(mb.grid, *(x[i] for x in mb.arrays()))


def _faulted(mb):
    """The batch with element 1 indefinite and element 2 carrying a NaN on
    a structural nonzero of an arrow row (placed symmetrically: the arrow
    rows hold both halves); elements 0 and 3 clean."""
    g = mb.grid
    Dr, R, C = (x.clone() for x in mb.arrays())
    Dr[1] = _corrupt_diag(Dr[1], g.n_diag_tiles // 2)
    if g.n_arrow_tiles:
        R[2, -1, 0, 0, 1] = float("nan")
    else:
        Dr[2, -1, 0, 1, 0] = float("nan")
    return BandedCTSF(g, Dr, R, C)


def _route_batch(route):
    """A θ-batch for ``route`` and both packages' options: the partitioned
    route's matrix is block-separable with the plan the port finds."""
    if route == "partitioned":
        A, st, _ = block_separable_arrowhead(120, 6, 8, 8, n_parts=3, seed=0)
        m = BandedCTSF.from_sparse(A, TileGrid(st, 8), device="cpu")
        plan = detect_partition_plan(A, m.grid.structure, 8)
        jplan = J.detect_partition_plan(A, J.TileGrid(st, 8).structure, 8)
        assert plan.n_partitions == 3 and plan.boundaries == jplan.boundaries
        rng = np.random.default_rng(1)
        tau, delta = rng.uniform(0.5, 2.0, B), rng.uniform(0.0, 0.5, B)
        eye = sp.identity(A.shape[0], format="csr")
        mats = [BandedCTSF.from_sparse((tau[i] * A + delta[i] * eye).tocsr(), m.grid,
                                       device="cpu") for i in range(B)]
        mb = BandedCTSF(m.grid, *(torch.stack(x) for x in zip(*(q.arrays() for q in mats))))
        return (mb, SolverOptions(partition_plan=plan),
                dict(partition_plan=jplan, impl="ref"))
    return _theta(96, 16, 8, 8), SolverOptions(sweep=route), dict(sweep=route, impl="ref")


# ---------------------------------------------------------------------------
# the functions
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,bw,ar,t", GRIDS)
@pytest.mark.parametrize("batched", [False, True])
def test_diag_scale_and_jitter_match_reference(n, bw, ar, t, batched):
    mb = _theta(n, bw, ar, t)
    m = mb if batched else _one(mb, 1)
    jm = _jctsf(m)
    scale = diag_scale(m.Dr, m.C, m.grid)
    want = JR.diag_scale(jm.Dr, jm.C, jm.grid)
    assert scale.shape == np.shape(want) == ((B,) if batched else ())
    np.testing.assert_array_equal(scale.numpy(), _np(want))
    shift = torch.linspace(0.1, 2.0, B) if batched else torch.tensor(0.7)
    Dr, C = add_diagonal_jitter(m.Dr, m.C, m.grid, shift)
    jDr, jC = JR.add_diagonal_jitter(jm.Dr, jm.C, jm.grid, jnp.asarray(shift.numpy()))
    np.testing.assert_array_equal(Dr.numpy(), _np(jDr))
    np.testing.assert_array_equal(C.numpy(), _np(jC))
    assert not torch.equal(Dr, m.Dr)              # a new tensor, the input as it was


def test_diag_scale_of_a_nan_diagonal_is_one():
    """A NaN diagonal scales as 1.0 in both packages (NaN > 0 is false)."""
    m = _theta(96, 16, 8, 8)
    Dr = m.Dr.clone()
    Dr[2, 0, 0, 1, 1] = float("nan")
    got = diag_scale(Dr, m.C, m.grid)
    want = JR.diag_scale(jnp.asarray(Dr.numpy()), jnp.asarray(m.C.numpy()), m.grid)
    np.testing.assert_array_equal(got.numpy(), _np(want))
    assert got[2].item() == 1.0


def test_status_ok_matches_reference():
    rng = np.random.default_rng(0)
    words = rng.standard_normal((6, 3)).astype(np.float32)
    words[:, 1] = [0, 0, 1, 0, 0, 1]
    words[0, 0], words[3, 0] = np.inf, 1e-12
    scale = rng.uniform(0.5, 4.0, 6).astype(np.float32)
    for policy in (RegularizePolicy(), RegularizePolicy(pivot_rtol=1e-3)):
        got = status_ok(torch.from_numpy(words), torch.from_numpy(scale), policy)
        jpol = JR.RegularizePolicy(pivot_rtol=policy.pivot_rtol)
        want = JR.status_ok(jnp.asarray(words), jnp.asarray(scale), jpol)
        np.testing.assert_array_equal(got.numpy(), _np(want))


def _dense_gershgorin(m):
    """max_i (sum_{j != i} |A_ij| - A_ii), clipped at 0, on the padded
    dense matrix of each element, in float64."""
    out = []
    for i in range(m.Dr.shape[0]) if m.Dr.dim() == 5 else [None]:
        e = m if i is None else _one(m, i)
        a = np.asarray(e.to_dense(lower_only=False), dtype=np.float64)
        d = np.diag(a)
        out.append(max(0.0, float((np.abs(a).sum(axis=1) - np.abs(d) - d).max())))
    return np.asarray(out if m.Dr.dim() == 5 else out[0])


@pytest.mark.parametrize("n,bw,ar,t", GRIDS)
@pytest.mark.parametrize("batched", [False, True])
def test_gershgorin_shift_against_dense_oracle(n, bw, ar, t, batched):
    """The port's shift is the dense Gershgorin bound of every element,
    made indefinite so that it is positive; without an arrow it is the
    reference's too."""
    mb = _theta(n, bw, ar, t)
    Dr = torch.stack([_corrupt_diag(d, min(q, mb.grid.n_diag_tiles - 1))
                      for q, d in enumerate(mb.Dr)])
    mb = BandedCTSF(mb.grid, Dr, mb.R, mb.C)
    m = mb if batched else _one(mb, 1)
    got = gershgorin_shift(m.Dr, m.R, m.C, m.grid)
    want = _dense_gershgorin(m)
    assert got.shape == want.shape and (want > 0).all()
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5)
    if not m.grid.n_arrow_tiles:
        jm = _jctsf(m)
        np.testing.assert_allclose(got.numpy(), _np(JR.gershgorin_shift(
            jm.Dr, jm.R, jm.C, jm.grid)), rtol=1e-6)


def test_gershgorin_shift_of_nan_is_nan():
    m = _theta(96, 16, 8, 8)
    R = m.R.clone()
    R[1, 0, 0, 0, 0] = float("nan")
    got = gershgorin_shift(m.Dr, R, m.C, m.grid)
    assert torch.isnan(got[1]) and torch.isfinite(got[[0, 2, 3]]).all()


@pytest.mark.parametrize("n,bw,ar,t", GRIDS)
@pytest.mark.parametrize("batched", [False, True])
def test_ctsf_matvec_matches_reference_and_dense(n, bw, ar, t, batched):
    mb = _theta(n, bw, ar, t)
    g = mb.grid
    rng = np.random.default_rng(n + t)
    lead = (B,) if batched else ()
    xd = rng.standard_normal(lead + (g.n_diag_tiles, t, 3)).astype(np.float32)
    xa = rng.standard_normal(lead + (g.n_arrow_tiles, t, 3)).astype(np.float32)
    m = mb if batched else _one(mb, 0)
    yd, ya = ctsf_matvec(*m.arrays(), torch.from_numpy(xd), torch.from_numpy(xa), g)
    for i in range(B) if batched else [None]:
        pick = (lambda x: x) if i is None else (lambda x: x[i])
        e = BandedCTSF(g, *(pick(x) for x in m.arrays()))
        je = _jctsf(e)
        wd, wa = JR.ctsf_matvec(je.Dr, je.R, je.C, jnp.asarray(pick(xd)), jnp.asarray(pick(xa)),
                                je.grid)
        np.testing.assert_allclose(pick(yd).numpy(), _np(wd), **TOL)
        np.testing.assert_allclose(pick(ya).numpy(), _np(wa), **TOL)
        x = np.concatenate([pick(xd).reshape(-1, 3), pick(xa).reshape(-1, 3)])
        y = np.asarray(e.to_dense(lower_only=False), np.float64) @ x
        got = np.concatenate([pick(yd).numpy().reshape(-1, 3), pick(ya).numpy().reshape(-1, 3)])
        np.testing.assert_allclose(got, y, rtol=1e-4, atol=1e-3)


# ---------------------------------------------------------------------------
# options
# ---------------------------------------------------------------------------

VALUES = [None, False, True, RegularizePolicy(taus=(1e-3,), gershgorin=False), "yes", 1, 0,
          1.0]


@pytest.mark.parametrize("value", VALUES, ids=repr)
def test_regularize_options_accept_and_refuse_as_reference(value):
    """``RegularizePolicy.resolve`` gives the reference's policy or refusal
    for the same value, and ``SolverOptions(regularize=)`` refuses exactly
    what the reference's factorization refuses (the port when the options
    are built, the reference when they are used)."""
    jvalue = (JR.RegularizePolicy(taus=value.taus, gershgorin=value.gershgorin)
              if isinstance(value, RegularizePolicy) else value)
    A, st = make_arrowhead(64, 8, 4, rho=0.6, seed=0)
    m, jm = _pair(A, st, 8)
    try:
        want = JR.RegularizePolicy.resolve(jvalue)
        J.factorize_window(jm, options=J.SolverOptions(regularize=jvalue, impl="ref"))
    except ValueError:
        with pytest.raises(ValueError, match="regularize"):
            RegularizePolicy.resolve(value)
        with pytest.raises(ValueError, match="regularize"):
            SolverOptions(regularize=value)
        return
    got = RegularizePolicy.resolve(value)
    assert (got is None) == (want is None)
    if got is not None:
        assert (got.taus, got.pivot_rtol, got.gershgorin, got.gershgorin_margin,
                got.keep_matrix) == (want.taus, want.pivot_rtol, want.gershgorin,
                                     want.gershgorin_margin, want.keep_matrix)
    assert SolverOptions(regularize=value).regularize is value
    assert hash(SolverOptions(regularize=value)) is not None


def test_status_constants_match_reference():
    assert (STATUS_OK, STATUS_RECOVERED, STATUS_FAILED, STATUS_SHED) == (
        JR.STATUS_OK, JR.STATUS_RECOVERED, JR.STATUS_FAILED, JR.STATUS_SHED) == (0, 1, 2, 3)


def test_regularize_is_keyword_only():
    A, st = make_arrowhead(64, 8, 4, rho=0.6, seed=0)
    m, _ = _pair(A, st, 8)
    with pytest.raises(TypeError):
        factorize_window(m, 8, SolverOptions(regularize=True))


# ---------------------------------------------------------------------------
# the ladder
# ---------------------------------------------------------------------------

def _info_np(info):
    return {k: _np(getattr(info, k)) for k in ("status", "attempts", "tau", "min_pivot",
                                              "first_bad_tile")}


@pytest.mark.parametrize("route", ROUTES)
def test_batched_ladder_matches_reference(route):
    """A batch of four (clean, indefinite, NaN, clean) on each route:
    status, attempts and first bad tile as the reference's, tau to 1e-6
    relative, the factors to 2e-4 except the FAILED element's; the healthy
    elements bit for bit the port's unregularized call, the recovered one's
    matrix kept; ``status`` and ``info`` read the same."""
    clean, opts, jkw = _route_batch(route)
    mb = _faulted(clean)
    ropts = SolverOptions(**{**{f: getattr(opts, f) for f in ("sweep", "partition_plan")},
                             "regularize": True})
    f = factorize_window_batched(mb, options=ropts)
    jf = J.factorize_window_batched(_jctsf(mb), bucket=False,
                                    options=J.SolverOptions(regularize=True, **jkw))
    got, want = _info_np(f.info), _info_np(jf.info)
    assert got["status"].tolist() == want["status"].tolist() == [
        STATUS_OK, STATUS_RECOVERED, STATUS_FAILED, STATUS_OK]
    assert got["attempts"].tolist() == want["attempts"].tolist()
    assert got["first_bad_tile"].tolist() == want["first_bad_tile"].tolist()
    assert got["first_bad_tile"][[0, 3]].tolist() == [-1, -1]
    np.testing.assert_allclose(got["tau"], want["tau"], rtol=1e-6, atol=0)
    assert got["tau"][1] > 0 and got["tau"][[0, 3]].tolist() == [0.0, 0.0]
    np.testing.assert_allclose(got["min_pivot"][[0, 1, 3]], want["min_pivot"][[0, 1, 3]],
                               rtol=2e-4)
    for x, jx in zip(f.ctsf.arrays(), jf.ctsf.arrays()):
        np.testing.assert_allclose(x.numpy()[[0, 1, 3]], _np(jx)[[0, 1, 3]], **TOL)
    plain = factorize_window_batched(mb, options=opts)
    for x, y in zip(f.ctsf.arrays(), plain.ctsf.arrays()):
        assert torch.equal(x[[0, 3]], y[[0, 3]])
    assert f.info.matrix is not None and torch.equal(f.info.matrix.Dr, mb.Dr)
    assert f.info.ok().tolist() == [True, True, False, True]
    np.testing.assert_array_equal(f.status[..., 0].numpy(), got["min_pivot"])
    np.testing.assert_array_equal(f.status[..., 2].numpy().astype(np.int32),
                                  got["first_bad_tile"])
    e1, e2 = f.info.element(1), f.info.element(2)
    assert e1 == {"status": STATUS_RECOVERED, "attempts": int(got["attempts"][1]),
                  "tau": float(got["tau"][1]), "min_pivot": float(got["min_pivot"][1]),
                  "first_bad_tile": int(got["first_bad_tile"][1])}
    assert e2["status"] == STATUS_FAILED and np.isnan(e2["tau"])


@pytest.mark.parametrize("route", ROUTES)
def test_clean_batch_regularized_is_bit_identical(route):
    """regularize=True on a clean batch: one attempt, no jitter, no kept
    matrix, and every array bit for bit the call without it."""
    mb, opts, _ = _route_batch(route)
    f0 = factorize_window_batched(mb, options=opts)
    f1 = factorize_window_batched(mb, options=SolverOptions(
        sweep=opts.sweep, partition_plan=opts.partition_plan, regularize=True))
    assert f1.info.status.tolist() == [STATUS_OK] * B and f1.info.attempts.tolist() == [1] * B
    assert f1.info.tau.tolist() == [0.0] * B and f1.info.matrix is None
    assert f0.info is None
    for x, y in zip(f0.ctsf.arrays() + (f0.status,), f1.ctsf.arrays() + (f1.status,)):
        assert torch.equal(x, y)


@pytest.mark.parametrize("n,bw,ar,t", GRIDS)
def test_unbatched_ladder(n, bw, ar, t):
    """factorize_window(regularize=True): an SPD input bit for bit the call
    without it; an indefinite one RECOVERED as the reference's, its factor
    the Cholesky factor of A + tau I.  With two arrow tiles the reference's
    Gershgorin rung raises (module docstring), so there the shift is held
    to the dense oracle's instead."""
    m = _one(_theta(n, bw, ar, t), 0)
    f0 = factorize_window(m)
    f1 = factorize_window(m, options=SolverOptions(regularize=True))
    assert f1.info.status.item() == STATUS_OK and f1.info.tau.shape == ()
    for x, y in zip(f0.ctsf.arrays() + (f0.status,), f1.ctsf.arrays() + (f1.status,)):
        assert torch.equal(x, y)
    bad = BandedCTSF(m.grid, _corrupt_diag(m.Dr, m.grid.n_diag_tiles // 2), m.R, m.C)
    f = factorize_window(bad, options=SolverOptions(regularize=True))
    got = _info_np(f.info)
    assert got["status"] == STATUS_RECOVERED and got["attempts"] > 1
    if m.grid.n_arrow_tiles <= 1:
        jf = J.factorize_window(_jctsf(bad), options=J.SolverOptions(regularize=True,
                                                                     impl="ref"))
        want = _info_np(jf.info)
        assert got["status"] == want["status"] and got["attempts"] == want["attempts"]
        assert got["first_bad_tile"] == want["first_bad_tile"]
        np.testing.assert_allclose(got["tau"], want["tau"], rtol=1e-6)
        for x, jx in zip(f.ctsf.arrays(), jf.ctsf.arrays()):
            np.testing.assert_allclose(x.numpy(), _np(jx), **TOL)
    else:
        # the rung that recovered it: a relative tau, else the Gershgorin one
        scale = diag_scale(bad.Dr, bad.C, bad.grid).item()
        taus = RegularizePolicy().taus
        want = (taus[got["attempts"] - 2] * scale if got["attempts"] - 2 < len(taus)
                else _dense_gershgorin(bad) + 1e-3 * scale)
        np.testing.assert_allclose(got["tau"], want, rtol=1e-5)
    L = np.tril(np.asarray(f.ctsf.to_dense(), np.float64))
    target = np.asarray(bad.to_dense(lower_only=False), np.float64) + float(
        got["tau"]) * np.eye(m.grid.padded_n)
    assert np.abs(L @ L.T - target).max() <= 1e-4 * np.abs(target).max()


def test_ladder_policy_without_gershgorin_fails_what_it_cannot_recover():
    """A policy whose taus are too small and no Gershgorin rung leaves an
    indefinite element FAILED after 1 + len(taus) attempts, as the
    reference's, with tau the last rung's."""
    m = _one(_theta(96, 16, 8, 8), 0)
    bad = BandedCTSF(m.grid, _corrupt_diag(m.Dr, 3), m.R, m.C)
    pol = RegularizePolicy(taus=(1e-6, 1e-4), gershgorin=False)
    f = factorize_window(bad, options=SolverOptions(regularize=pol))
    jf = J.factorize_window(_jctsf(bad), options=J.SolverOptions(
        regularize=JR.RegularizePolicy(taus=(1e-6, 1e-4), gershgorin=False), impl="ref"))
    got, want = _info_np(f.info), _info_np(jf.info)
    assert got["status"] == want["status"] == STATUS_FAILED
    assert got["attempts"] == want["attempts"] == 3
    np.testing.assert_allclose(got["tau"], want["tau"], rtol=1e-6)


# ---------------------------------------------------------------------------
# the fault generators
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 3])
def test_fault_generators_match_reference(seed):
    """The ported generators corrupt the same entries as the reference's
    (the same numpy seeding), and the indefinite one recovers through the
    ladder as the reference's does."""
    for mine, theirs, kw in ((indefinite_arrowhead, jindefinite_arrowhead, {}),
                             (near_singular_arrowhead, jnear_singular_arrowhead,
                              dict(eig_min=1e-5)),
                             (nan_contaminated_arrowhead, jnan_contaminated_arrowhead,
                              dict(count=2))):
        A, st = mine(96, 16, 8, seed=seed, **kw)
        jA, jst = theirs(96, 16, 8, seed=seed, **kw)
        np.testing.assert_array_equal(A.toarray(), jA.toarray())
        assert (st.n, st.bandwidth, st.arrow) == (jst.n, jst.bandwidth, jst.arrow)
    A, st = indefinite_arrowhead(96, 16, 8, seed=seed)
    assert np.linalg.eigvalsh(A.toarray()).min() < 0
    m, jm = _pair(A, st, 8)
    f = factorize_window(m, options=SolverOptions(regularize=True))
    jf = J.factorize_window(jm, options=J.SolverOptions(regularize=True, impl="ref"))
    assert f.info.status.item() == int(_np(jf.info.status)) == STATUS_RECOVERED
    np.testing.assert_allclose(f.info.tau.item(), float(_np(jf.info.tau)), rtol=1e-6)
    assert torch.isfinite(f.ctsf.Dr).all()
    A, st = nan_contaminated_arrowhead(64, 8, 4, seed=seed)
    m, _ = _pair(A, st, 8)
    f = factorize_window(m, options=SolverOptions(regularize=True))
    assert f.info.status.item() == STATUS_FAILED and not f.info.ok()


# ---------------------------------------------------------------------------
# refinement
# ---------------------------------------------------------------------------

def test_solve_many_refines_jittered_factor():
    """Mirror of the reference's test: a factor of ``A + tau I`` with tau
    half of A's smallest eigenvalue, and A kept on its FactorInfo.  The
    port's refined solve matches the reference's; the refined residual is
    at most the unrefined one in every column and its largest under 0.6 of
    the unrefined largest."""
    A, st = make_arrowhead(96, 16, 8, rho=0.6, seed=0)
    m, jm = _pair(A, st, 8)
    g = m.grid
    dense = np.asarray(m.to_dense(lower_only=False), np.float64)
    tau = 0.5 * float(np.linalg.eigvalsh(dense).min())
    DrJ, CJ = add_diagonal_jitter(m.Dr, m.C, g, torch.tensor(tau, dtype=torch.float32))
    fJ = factorize_window(BandedCTSF(g, DrJ, m.R, CJ))
    info = FactorInfo(status=torch.tensor(STATUS_RECOVERED, dtype=torch.int32),
                      attempts=torch.tensor(2, dtype=torch.int32),
                      tau=torch.tensor(tau, dtype=torch.float32),
                      min_pivot=torch.tensor(1.0), first_bad_tile=torch.tensor(0, dtype=torch.int32),
                      matrix=m)
    refined = CholeskyFactor(fJ.ctsf, info=info)
    jDrJ, jCJ = JR.add_diagonal_jitter(jm.Dr, jm.C, jm.grid, jnp.float32(tau))
    jfJ = J.factorize_window(J.BandedCTSF(jm.grid, jDrJ, jm.R, jCJ),
                             options=J.SolverOptions(impl="ref"))
    jinfo = JR.FactorInfo(status=jnp.asarray(1, jnp.int32), attempts=jnp.asarray(2, jnp.int32),
                          tau=jnp.asarray(tau, jnp.float32), min_pivot=jnp.asarray(1.0),
                          first_bad_tile=jnp.asarray(0, jnp.int32), matrix=jm)
    jrefined = JCholeskyFactor(jfJ.ctsf, info=jinfo)
    Bn = np.random.default_rng(0).standard_normal((g.padded_n, 3)).astype(np.float32)
    X_plain = solve_many(fJ, torch.from_numpy(Bn)).numpy()
    X_ref = solve_many(refined, torch.from_numpy(Bn)).numpy()
    jX = _np(J.solve_many(jrefined, jnp.asarray(Bn), options=J.SolverOptions(impl="ref")))
    np.testing.assert_allclose(X_ref, jX, **TOL)
    r_plain = np.linalg.norm(dense @ X_plain - Bn, axis=0)
    r_ref = np.linalg.norm(dense @ X_ref - Bn, axis=0)
    assert (r_ref <= r_plain).all()
    assert r_ref.max() < 0.6 * r_plain.max()
    # a factor whose info holds no matrix, or tau = 0, is solved unrefined
    for other in (FactorInfo(info.status, info.attempts, info.tau, info.min_pivot,
                             info.first_bad_tile, None),
                  FactorInfo(info.status, info.attempts, torch.tensor(0.0), info.min_pivot,
                             info.first_bad_tile, m)):
        X = solve_many(CholeskyFactor(fJ.ctsf, info=other), torch.from_numpy(Bn)).numpy()
        np.testing.assert_array_equal(X, X_plain)
