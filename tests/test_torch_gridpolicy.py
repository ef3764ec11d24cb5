"""The port's canonical-grid bucketing (``core/gridpolicy.py``) against the
JAX package's, on the CPU, case for case with ``tests/test_gridpolicy.py``:
the same matrices (``make_arrowhead`` at the reference file's CASES, t = 8,
and its band-less arrow-only grid), fed to both packages from one scipy
matrix.

The policy's grids and the embeddings and restrictions are held to the
reference's exactly (equal tile counts; arrays equal, or to 1e-6 after a
factorization).  Results across the embedding (factor, logdet, solves,
marginal variances, draws, Σ) are held to the reference's policy call and
to the port's own unbucketed call at fp32 tolerance, rtol = atol = 2e-5 as
the reference file uses, never bit for bit: the reference's own
bit-identity case fails on ``[120-18-8]`` (ROADMAP C).  The JAX side runs
with ``impl="ref"``, as the reference's CPU tests do, except where the
reference file runs its Pallas sweeps (interpret mode)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import repro.core as J
from repro.core import concurrent as jconcurrent
from repro_torch.core import (ArrowheadStructure, BandedCTSF, CholeskyFactor, GridBucketPolicy,
                              PartitionPlan, SolverOptions, TileGrid, assemble_rung_batch,
                              assemble_rung_rhs, embed_ctsf, embed_rhs, factorize_window,
                              factorize_window_batched, marginal_variances,
                              padded_flop_overhead, restrict_factor, restrict_rhs,
                              restrict_selinv, sample_gmrf_many, selected_inverse,
                              selinv_batched, solve_many, solve_many_batched)
from repro_torch.core import cholesky as core_cholesky
from repro_torch.core.concurrent import (concurrent_logdet, concurrent_quadratic_forms,
                                         concurrent_solve, stack_ctsf)
from repro_torch.data import block_separable_arrowhead, make_arrowhead

POLICY = GridBucketPolicy()
JPOLICY = J.GridBucketPolicy()
REF = SolverOptions(impl="ref")
PREF = SolverOptions(impl="ref", policy=POLICY)
JREF = J.SolverOptions(impl="ref")
JPREF = J.SolverOptions(impl="ref", policy=JPOLICY)
TOL = 2e-5
# the reference file's CASES: (n, bandwidth, arrow): diagonal padding only,
# band and diagonal padding, exactly on a rung (zero padding)
CASES = [(96, 10, 5), (120, 18, 8), (136, 15, 8)]


def _problem(n, bw, ar, t=8, seed=1):
    """One matrix in both packages: ``(A, grid, m, jgrid, jm)``."""
    A, st = make_arrowhead(n, bw, ar, rho=0.6, seed=seed)
    grid = TileGrid(st, t=t)
    jgrid = J.TileGrid(J.ArrowheadStructure(n=st.n, bandwidth=st.bandwidth, arrow=st.arrow), t)
    return A, grid, BandedCTSF.from_sparse(A, grid, device="cpu"), jgrid, \
        J.BandedCTSF.from_sparse(A, jgrid)


def _counts(g):
    return (g.t, g.n_diag_tiles, g.band_tiles, g.n_arrow_tiles)


def _close(got, want, tol=TOL):
    got = got.numpy() if torch.is_tensor(got) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), rtol=tol, atol=tol)


def _exact(got, want):
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _arrays(x):
    return (x.Dr, x.R, x.C)


def _rhs(grid, k, seed=0):
    """A (padded_n, k) panel, zero in the padding rows."""
    B = np.random.default_rng(seed).standard_normal((grid.padded_n, k)).astype(np.float32)
    s = grid.structure
    B[s.n_diag:grid.n_diag_tiles * grid.t] = 0.0
    B[grid.n_diag_tiles * grid.t + s.arrow:] = 0.0
    return B


# ---------------------------------------------------------------------------
# The policy
# ---------------------------------------------------------------------------

def test_canonicalize_rounds_up_and_is_idempotent():
    _, grid, _, jgrid, _ = _problem(96, 10, 5)
    cg = POLICY.canonicalize(grid)
    assert _counts(cg) == _counts(JPOLICY.canonicalize(jgrid))
    assert cg.n_diag_tiles >= grid.n_diag_tiles and cg.band_tiles >= grid.band_tiles
    assert cg.n_arrow_tiles >= grid.n_arrow_tiles
    assert cg.n_diag_tiles & (cg.n_diag_tiles - 1) == 0
    assert cg.band_tiles in POLICY.band_rungs and cg.n_arrow_tiles in POLICY.arrow_rungs
    assert POLICY.canonicalize(cg) == cg
    assert cg.padded_n == cg.structure.n


def test_equal_rungs_give_equal_canonical_grids():
    _, g1, _, j1, _ = _problem(96, 10, 5)
    _, g2, _, j2, _ = _problem(90, 9, 3)
    c1, c2 = POLICY.canonicalize(g1), POLICY.canonicalize(g2)
    assert g1 != g2 and c1 == c2 and hash(c1) == hash(c2)
    assert _counts(c1) == _counts(JPOLICY.canonicalize(j1)) == _counts(JPOLICY.canonicalize(j2))


@pytest.mark.parametrize("n,bw,ar", CASES)
def test_rungs_and_overhead_match_reference(n, bw, ar):
    _, grid, _, jgrid, _ = _problem(n, bw, ar)
    cg, jcg = POLICY.canonicalize(grid), JPOLICY.canonicalize(jgrid)
    assert POLICY.rungs_for(grid) == JPOLICY.rungs_for(jgrid)
    assert _counts(cg) == _counts(jcg)
    assert padded_flop_overhead(grid, cg) == J.padded_flop_overhead(jgrid, jcg)


def test_zero_padding_case_is_exactly_on_rung():
    _, grid, _, _, _ = _problem(136, 15, 8)
    cg = POLICY.canonicalize(grid)
    assert _counts(cg) == _counts(grid)
    assert padded_flop_overhead(grid, cg) == 0.0


def test_rungs_above_top_fall_back_to_pow2():
    pol = GridBucketPolicy(band_rungs=(1, 2), arrow_rungs=(0, 1))
    jpol = J.GridBucketPolicy(band_rungs=(1, 2), arrow_rungs=(0, 1))
    cg = pol.canonicalize(TileGrid.from_tile_counts(8, 32, 5, 3))
    assert cg.band_tiles == 8 and cg.n_arrow_tiles == 4
    assert _counts(cg) == _counts(jpol.canonicalize(J.TileGrid.from_tile_counts(8, 32, 5, 3)))


def test_join_takes_elementwise_max_rung():
    _, g1, _, j1, _ = _problem(96, 10, 5)
    _, g2, _, j2, _ = _problem(120, 18, 8)
    j = POLICY.join([g1, g2])
    c1, c2 = POLICY.canonicalize(g1), POLICY.canonicalize(g2)
    assert j.band_tiles == max(c1.band_tiles, c2.band_tiles)
    assert j.n_diag_tiles == max(c1.n_diag_tiles, c2.n_diag_tiles)
    assert _counts(j) == _counts(JPOLICY.join([j1, j2]))
    with pytest.raises(ValueError, match="mixed tile sizes"):
        POLICY.join([g1, TileGrid(g2.structure, t=4)])
    with pytest.raises(ValueError, match="at least one"):
        POLICY.join([])


def test_policy_and_tile_count_validation():
    with pytest.raises(ValueError, match="ascending"):
        GridBucketPolicy(band_rungs=(4, 2))
    with pytest.raises(ValueError, match="band_rungs"):
        GridBucketPolicy(band_rungs=(0, 1))
    with pytest.raises(ValueError, match="min_diag_tiles"):
        GridBucketPolicy(min_diag_tiles=0)
    with pytest.raises(ValueError, match="band_tiles"):
        TileGrid.from_tile_counts(8, 4, 4, 1)
    with pytest.raises(ValueError, match="band_tiles=0"):
        TileGrid.from_tile_counts(8, 4, 0, 1)
    g = TileGrid.from_tile_counts(8, 16, 4, 2)
    assert (g.n_diag_tiles, g.band_tiles, g.n_arrow_tiles) == (16, 4, 2)


# ---------------------------------------------------------------------------
# The embedding
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,bw,ar", CASES)
def test_embed_matches_reference_and_restrict_roundtrips(n, bw, ar):
    _, grid, m, jgrid, jm = _problem(n, bw, ar)
    cg, jcg = POLICY.canonicalize(grid), JPOLICY.canonicalize(jgrid)
    emb, jemb = embed_ctsf(m, cg), J.embed_ctsf(jm, jcg)
    for a, b in zip(_arrays(emb), _arrays(jemb)):
        _exact(a, b)
    pad_d, t = cg.n_diag_tiles - grid.n_diag_tiles, grid.t
    dense = emb.to_dense(lower_only=False)
    np.testing.assert_array_equal(dense[:pad_d * t, :pad_d * t], np.eye(pad_d * t))
    assert not dense[:pad_d * t, pad_d * t:].any()
    r = restrict_factor(CholeskyFactor(emb), grid)
    assert r.ctsf.grid == grid
    for a, b in zip(_arrays(r.ctsf), _arrays(m)):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="source grid"):
        restrict_factor(CholeskyFactor(emb))


def test_embedding_keeps_a_batch_axis_and_matches_reference():
    _, grid, m, jgrid, jm = _problem(120, 18, 8)
    cg, jcg = POLICY.canonicalize(grid), JPOLICY.canonicalize(jgrid)
    mb = BandedCTSF(grid, *(torch.stack([x, 2 * x]) for x in m.arrays()))
    jmb = J.BandedCTSF(jgrid, *(jnp.stack([x, 2 * x]) for x in _arrays(jm)))
    emb, jemb = embed_ctsf(mb, cg), J.embed_ctsf(jmb, jcg)
    for a, b in zip(_arrays(emb), _arrays(jemb)):
        assert a.shape[0] == 2
        _exact(a, b)


def test_identity_embeds_to_identity():
    _, grid, _, _, _ = _problem(96, 10, 5)
    cg = POLICY.canonicalize(grid)
    emb = embed_ctsf(BandedCTSF.eye(grid, device="cpu"), cg)
    for a, b in zip(_arrays(emb), _arrays(BandedCTSF.eye(cg, device="cpu"))):
        assert torch.equal(a, b)


def test_rhs_embed_restrict_roundtrip_and_validation():
    _, grid, _, jgrid, _ = _problem(96, 10, 5)
    cg, jcg = POLICY.canonicalize(grid), JPOLICY.canonicalize(jgrid)
    Bn = np.random.default_rng(0).standard_normal((grid.padded_n, 3)).astype(np.float32)
    B = torch.from_numpy(Bn)
    Bc = embed_rhs(B, grid, cg)
    assert Bc.shape == (cg.padded_n, 3)
    _exact(Bc, J.embed_rhs(jnp.asarray(Bn), jgrid, jcg))
    assert torch.equal(restrict_rhs(Bc, grid, cg), B)
    _exact(restrict_rhs(Bc, grid, cg), J.restrict_rhs(jnp.asarray(Bc.numpy()), jgrid, jcg))
    with pytest.raises(ValueError, match="padded_n"):
        embed_rhs(B[:-1], grid, cg)
    with pytest.raises(ValueError, match="padded_n"):
        restrict_rhs(Bc[:-1], grid, cg)
    with pytest.raises(ValueError, match="does not embed"):
        embed_rhs(Bc, cg, grid)


def test_assemble_rung_batch_and_rhs_match_reference():
    probs = [_problem(96, 10, 5), _problem(90, 9, 3), _problem(88, 11, 2)]
    cg = POLICY.canonicalize(probs[0][1])
    jcg = JPOLICY.canonicalize(probs[0][3])
    batch, start = assemble_rung_batch([p[2] for p in probs], cg)
    jbatch, jstart = J.assemble_rung_batch([p[4] for p in probs], jcg)
    assert start == jstart and batch.grid == cg
    for a, b in zip(_arrays(batch), _arrays(jbatch)):
        _exact(a, b)
    panels = [_rhs(p[1], 2, seed=i) for i, p in enumerate(probs)]
    got = assemble_rung_rhs([torch.from_numpy(x) for x in panels], [p[1] for p in probs], cg)
    _exact(got, J.assemble_rung_rhs([jnp.asarray(x) for x in panels], [p[3] for p in probs],
                                    jcg))
    with pytest.raises(ValueError, match="panels for"):
        assemble_rung_rhs([torch.from_numpy(panels[0])], [p[1] for p in probs], cg)
    with pytest.raises(ValueError, match="at least one"):
        assemble_rung_batch([], cg)


# ---------------------------------------------------------------------------
# The entry points: bucketed against the reference's and against unbucketed
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,bw,ar", CASES)
def test_factorize_window_policy_parity(n, bw, ar):
    _, grid, m, _, jm = _problem(n, bw, ar)
    f0 = factorize_window(m, options=REF)
    fp = factorize_window(m, options=PREF)
    jfp = J.factorize_window(jm, options=JPREF)
    assert fp.source_grid == grid and fp.ctsf.grid == POLICY.canonicalize(grid)
    assert _counts(fp.ctsf.grid) == _counts(jfp.ctsf.grid)
    for a, b in zip(_arrays(fp.ctsf), _arrays(jfp.ctsf)):
        _close(a, b)
    fr = fp.restrict()
    assert fr.ctsf.grid == grid and fr.source_grid is None
    for a, b, c in zip(_arrays(fr.ctsf), _arrays(f0.ctsf), _arrays(jfp.restrict().ctsf)):
        _close(a, b)
        _close(a, c)
    _close(fp.logdet(), f0.logdet())
    _close(fp.logdet(), jfp.logdet())
    assert f0.restrict() is f0


@pytest.mark.parametrize("n,bw,ar", CASES)
def test_solve_and_marginals_policy_parity(n, bw, ar):
    _, grid, m, _, jm = _problem(n, bw, ar)
    f0 = factorize_window(m, options=REF)
    fp = factorize_window(m, options=PREF)
    jfp = J.factorize_window(jm, options=JPREF)
    Bn = _rhs(grid, 4, seed=n)
    B = torch.from_numpy(Bn)
    X0 = solve_many(f0, B, options=REF)
    Xp = solve_many(fp, B, options=REF)
    _close(Xp, X0)
    _close(Xp, J.solve_many(jfp, jnp.asarray(Bn), options=JREF))
    # a policy on a plain factor embeds it on the fly
    _close(solve_many(f0, B, options=PREF), X0)
    idx = np.arange(0, grid.structure.n, 7)
    v0 = marginal_variances(f0, idx, options=REF)
    _close(marginal_variances(fp, idx, options=REF), v0)
    _close(marginal_variances(fp, idx, options=REF),
           J.marginal_variances(jfp, idx, options=JREF))
    pan = SolverOptions(impl="ref", method="panels")
    _close(marginal_variances(fp, idx, options=pan), marginal_variances(f0, idx, options=pan))
    _close(marginal_variances(fp, idx, options=pan),
           J.marginal_variances(jfp, idx, options=J.SolverOptions(impl="ref", method="panels")))
    # draws: z in the source layout, so the bucketed draw is the unbucketed
    # one for the same generator (to fp32 tolerance across the embedding)
    s0 = sample_gmrf_many(f0, num=3, generator=torch.Generator().manual_seed(5), options=REF)
    s1 = sample_gmrf_many(fp, num=3, generator=torch.Generator().manual_seed(5), options=REF)
    assert s1.shape == (grid.padded_n, 3)
    _close(s1, s0)
    key = jax.random.PRNGKey(5)
    z = np.array(jax.random.normal(key, (grid.padded_n, 3), dtype=jnp.float32))
    _close(sample_gmrf_many(fp, num=3, z=torch.from_numpy(z), options=REF),
           J.sample_gmrf_many(jfp, key, 3, options=JREF))


@pytest.mark.parametrize("n,bw,ar", CASES)
def test_forward_solve_start_tile_keeps_its_source_meaning(n, bw, ar):
    """``start_tile`` counts the source grid's tiles under a policy."""
    from repro_torch.core import forward_solve_many
    _, grid, m, _, jm = _problem(n, bw, ar)
    f0, fp = factorize_window(m, options=REF), factorize_window(m, options=PREF)
    jfp = J.factorize_window(jm, options=JPREF)
    Bn = _rhs(grid, 3, seed=2)
    Bn[:3 * grid.t] = 0.0
    got = forward_solve_many(fp, torch.from_numpy(Bn), start_tile=3, options=REF)
    _close(got, forward_solve_many(f0, torch.from_numpy(Bn), start_tile=3, options=REF))
    _close(got, J.forward_solve_many(jfp, jnp.asarray(Bn), start_tile=3, options=JREF))


@pytest.mark.parametrize("n,bw,ar", CASES)
def test_selinv_policy_parity(n, bw, ar):
    _, grid, m, _, jm = _problem(n, bw, ar)
    f0 = factorize_window(m, options=REF)
    fp = factorize_window(m, options=PREF)
    jfp = J.factorize_window(jm, options=JPREF)
    s0 = selected_inverse(f0, options=REF)
    s1 = selected_inverse(fp, options=REF)
    js = J.selected_inverse(jfp, options=JREF)
    assert s1.grid == grid
    for a, b, c in zip(_arrays(s1), _arrays(s0), _arrays(js)):
        _close(a, b)
        _close(a, c)
    _close(s1.diagonal(), s0.diagonal())
    # a policy on a plain factor, and restrict_selinv of the embedded Σ
    _close(selected_inverse(f0, options=PREF).Dr, s0.Dr)
    from repro_torch.core.selinv import SelectedInverse, _selinv_impl
    c = fp.ctsf
    pad = c.grid.n_diag_tiles - grid.n_diag_tiles
    full = SelectedInverse(c.grid, *_selinv_impl(c.Dr, c.R, c.C, c.grid, "ref", pad))
    _close(restrict_selinv(full, grid).C, s0.C)


def test_fused_reference_sweeps_ride_the_embedding():
    """The reference file runs its Pallas sweeps (interpret mode) on the
    embedding; the port's plain sweeps on its own embedding match them."""
    _, grid, m, _, jm = _problem(96, 10, 5)
    fp = factorize_window(m, options=PREF)
    jfp = J.factorize_window(jm, options=J.SolverOptions(impl="pallas", policy=JPOLICY))
    _close(fp.restrict().ctsf.Dr, jfp.restrict().ctsf.Dr)
    Bn = _rhs(grid, 4, seed=3)
    _close(solve_many(fp, torch.from_numpy(Bn), options=REF),
           J.solve_many(jfp, jnp.asarray(Bn), options=J.SolverOptions(impl="pallas")))
    _close(selected_inverse(fp, options=REF).diagonal(),
           J.selected_inverse(jfp, options=J.SolverOptions(impl="pallas")).diagonal())


@pytest.mark.parametrize("sweep", ["window", "ring"])
@pytest.mark.parametrize("n,bw,ar", CASES)
def test_factorize_window_routes_under_policy(sweep, n, bw, ar):
    _, grid, m, _, jm = _problem(n, bw, ar)
    f0 = factorize_window(m, options=SolverOptions(sweep=sweep))
    fp = factorize_window(m, options=SolverOptions(sweep=sweep, policy=POLICY))
    jfp = J.factorize_window(jm, options=J.SolverOptions(impl="ref", sweep=sweep,
                                                         policy=JPOLICY))
    for a, b, c in zip(_arrays(fp.restrict().ctsf), _arrays(f0.ctsf),
                       _arrays(jfp.restrict().ctsf)):
        _close(a, b)
        _close(a, c)


@pytest.mark.parametrize("n_parts", [2, 4])
def test_partitioned_route_shifts_its_plan_under_policy(n_parts):
    """A partition plan under the policy: the prefix joins partition 0."""
    A, st, bounds = block_separable_arrowhead(100, 5, 4, 8, n_parts=n_parts, seed=0)
    grid = TileGrid(st, 8)
    jgrid = J.TileGrid(J.ArrowheadStructure(n=st.n, bandwidth=st.bandwidth, arrow=st.arrow), 8)
    m, jm = BandedCTSF.from_sparse(A, grid, device="cpu"), J.BandedCTSF.from_sparse(A, jgrid)
    plan = PartitionPlan(bounds)
    opts = SolverOptions(partition_plan=plan, policy=POLICY)
    fp = factorize_window(m, options=opts)
    pad = fp.ctsf.grid.n_diag_tiles - grid.n_diag_tiles
    assert pad > 0 and plan.shifted(pad).boundaries[1] == bounds[1] + pad
    jfp = J.factorize_window(jm, options=J.SolverOptions(
        impl="ref", policy=JPOLICY, partition_plan=J.PartitionPlan(bounds)))
    f0 = factorize_window(m, options=SolverOptions(partition_plan=plan))
    for a, b, c in zip(_arrays(fp.restrict().ctsf), _arrays(f0.ctsf),
                       _arrays(jfp.restrict().ctsf)):
        _close(a, b)
        _close(a, c)
    with pytest.raises(ValueError, match="rebuild the plan"):
        factorize_window(embed_ctsf(m, fp.ctsf.grid), options=SolverOptions(partition_plan=plan))


def test_batched_and_concurrent_policy_parity():
    _, grid, m, _, jm = _problem(96, 10, 5)
    fb0 = factorize_window_batched([m] * 3, options=REF)
    fbp = factorize_window_batched([m] * 3, options=PREF)
    jfbp = J.factorize_window_batched([jm] * 3, options=JPREF)
    assert fbp.source_grid == grid
    _close(restrict_factor(fbp).ctsf.Dr, fb0.ctsf.Dr)
    _close(fbp.ctsf.Dr, jfbp.ctsf.Dr)
    _close(concurrent_logdet(fbp), concurrent_logdet(fb0))
    _close(concurrent_logdet(fbp), jconcurrent.concurrent_logdet(jfbp))
    yn = np.random.default_rng(1).standard_normal(grid.padded_n).astype(np.float32)
    y = torch.from_numpy(yn)
    _close(concurrent_solve(fbp, y, options=REF), concurrent_solve(fb0, y, options=REF))
    _close(concurrent_solve(fbp, y, options=REF),
           jconcurrent.concurrent_solve(jfbp, jnp.asarray(yn), options=JREF))
    _close(concurrent_quadratic_forms(fbp, y, options=REF),
           concurrent_quadratic_forms(fb0, y, options=REF))
    _close(concurrent_quadratic_forms(fbp, y, options=REF),
           jconcurrent.concurrent_quadratic_forms(jfbp, jnp.asarray(yn), options=JREF))
    sb0, sbp = selinv_batched(fb0, options=REF), selinv_batched(fbp, options=REF)
    assert sbp.grid == grid
    _close(sbp.diagonal(), sb0.diagonal())
    _close(sbp.Dr, sb0.Dr)
    _close(sbp.Dr, J.selinv_batched(jfbp, options=JREF).Dr)


def test_solve_many_batched_on_an_embedded_factor():
    """The port's embedded batched factor takes panels in the source layout
    (the reference's takes the canonical layout: held through its
    embed_rhs / restrict_rhs)."""
    _, grid, m, _, jm = _problem(120, 18, 8)
    fbp = factorize_window_batched([m] * 3, options=PREF)
    jfbp = J.factorize_window_batched([jm] * 3, options=JPREF)
    f0 = factorize_window(m, options=REF)
    Bn = np.stack([_rhs(grid, 2, seed=i) for i in range(3)])
    X = solve_many_batched(fbp, torch.from_numpy(Bn), options=REF)
    assert X.shape == Bn.shape
    jg = jfbp.ctsf.grid
    jX = J.solve_many_batched(jfbp, J.embed_rhs(jnp.asarray(Bn), jfbp.source_grid, jg),
                              options=JREF)
    _close(X, J.restrict_rhs(jX, jfbp.source_grid, jg))
    for i in range(3):
        _close(X[i], solve_many(f0, torch.from_numpy(Bn[i]), options=REF))
    with pytest.raises(ValueError, match="start_tile"):
        solve_many_batched(fbp, torch.from_numpy(Bn), start_tile=1)


def test_stack_ctsf_policy_embeds_mixed_grids():
    _, g1, m1, _, jm1 = _problem(96, 10, 5)
    _, g2, m2, _, jm2 = _problem(120, 18, 8)
    with pytest.raises(ValueError, match="equal structure"):
        stack_ctsf([m1, m2])
    stacked = stack_ctsf([m1, m2], policy=POLICY)
    jstacked = jconcurrent.stack_ctsf([jm1, jm2], policy=JPOLICY)
    assert stacked.grid == POLICY.join([g1, g2]) and stacked.Dr.shape[0] == 2
    for a, b in zip(_arrays(stacked), _arrays(jstacked)):
        _exact(a, b)
    fb = factorize_window_batched(stacked, options=PREF)
    f1 = factorize_window(m1, options=PREF)
    _close(fb.ctsf.Dr[0], embed_ctsf(f1.ctsf, stacked.grid).Dr)
    _close(fb.ctsf.Dr, J.factorize_window_batched(jstacked, options=JPREF).ctsf.Dr)


def test_stack_ctsf_embeds_bandless_grid_with_banded_ones():
    _, _, m1, _, jm1 = _problem(96, 10, 5)
    x = np.random.default_rng(7).standard_normal((16, 16)).astype(np.float32)
    dense = x @ x.T + 16 * np.eye(16, dtype=np.float32)
    st = ArrowheadStructure(n=16, bandwidth=0, arrow=16)
    g0 = TileGrid(st, t=8)
    jg0 = J.TileGrid(J.ArrowheadStructure(n=16, bandwidth=0, arrow=16), t=8)
    assert g0.n_diag_tiles == 0
    m0 = BandedCTSF.from_sparse(sp.csc_matrix(dense), g0, device="cpu")
    jm0 = J.BandedCTSF.from_sparse(sp.csc_matrix(dense), jg0)
    stacked = stack_ctsf([m1, m0], policy=POLICY)
    assert stacked.grid.n_diag_tiles > 0
    fb = factorize_window_batched(stacked, options=PREF)
    jfb = J.factorize_window_batched(jconcurrent.stack_ctsf([jm1, jm0], policy=JPOLICY),
                                     options=JPREF)
    got = fb.ctsf.C[1].numpy().transpose(0, 2, 1, 3).reshape(16, 16)
    np.testing.assert_allclose(np.tril(got), np.linalg.cholesky(dense), rtol=2e-4, atol=2e-4)
    _close(fb.ctsf.C, jfb.ctsf.C)
    np.testing.assert_allclose(fb.ctsf.Dr[1, :, 0].numpy(),
                               np.broadcast_to(np.eye(8), (stacked.grid.n_diag_tiles, 8, 8)),
                               atol=1e-6)


def test_logdet_broadcasts_over_batched_factors():
    _, _, m, _, jm = _problem(96, 10, 5)
    f1 = factorize_window(m, options=REF)
    fb = factorize_window_batched([m, m, m], options=REF)
    ld = fb.logdet()
    assert ld.shape == (3,)
    _close(ld, np.full(3, f1.logdet().item()))
    _close(concurrent_logdet(fb), ld)
    _close(ld, J.factorize_window_batched([jm] * 3, options=JREF).logdet())


def test_mixed_grid_stream_shares_canonical_cache_entries():
    """A stream of distinct grids on one canonical rung adds exactly one
    entry to the batched factorization's cache, as the reference's."""
    cache = core_cholesky._BATCHED_WINDOW_CACHE
    probs = [_problem(96, 10, 5), _problem(90, 9, 3), _problem(88, 11, 2)]
    assert len({POLICY.canonicalize(p[1]) for p in probs}) == 1
    before = set(cache.keys())
    # tree_chunks=6 keeps the key apart from other tests' entries, in both
    # packages' caches (tests/test_gridpolicy.py's twin uses 7 in the
    # reference's, test_infra.py 5; one worker may run all three)
    outs = [factorize_window_batched([m, m], tree_chunks=6, options=PREF)
            for _, _, m, _, _ in probs]
    assert len(set(cache.keys()) - before) == 1
    jcache = J.cholesky._BATCHED_WINDOW_CACHE
    jbefore = set(jcache.keys())
    for _, _, _, _, jm in probs:
        J.factorize_window_batched([jm, jm], tree_chunks=6, options=JPREF)
    assert len(set(jcache.keys()) - jbefore) == 1
    for (_, g, m, _, _), f in zip(probs, outs):
        f0 = factorize_window_batched([m, m], tree_chunks=6, options=REF)
        _close(restrict_factor(f).ctsf.Dr, f0.ctsf.Dr)
        assert f.source_grid == g


def test_start_tile_batches_share_the_policy_entry():
    """``start_tile=`` on a batch the caller embedded (assemble_rung_batch)
    rides the ``use_start`` entry the policy path builds, and is refused
    beside a policy."""
    cache = core_cholesky._BATCHED_WINDOW_CACHE
    probs = [_problem(96, 10, 5), _problem(90, 9, 3)]
    cg = POLICY.canonicalize(probs[0][1])
    batch, start = assemble_rung_batch([p[2] for p in probs], cg)
    jbatch, jstart = J.assemble_rung_batch([p[4] for p in probs],
                                           JPOLICY.canonicalize(probs[0][3]))
    factorize_window_batched([probs[0][2]] * 2, tree_chunks=6, options=PREF)
    keys = set(cache.keys())
    f = factorize_window_batched(batch, tree_chunks=6, start_tile=start, options=REF)
    assert set(cache.keys()) == keys and f.source_grid is None
    jf = J.factorize_window_batched(jbatch, tree_chunks=6, start_tile=jstart, options=JREF)
    _close(f.ctsf.Dr, jf.ctsf.Dr)
    _close(f.ctsf.C, jf.ctsf.C)
    Bn = np.stack([embed_rhs(torch.from_numpy(_rhs(p[1], 3, seed=i)), p[1], cg).numpy()
                   for i, p in enumerate(probs)])
    X = solve_many_batched(f, torch.from_numpy(Bn), start_tile=start, options=REF)
    _close(X, J.solve_many_batched(jf, jnp.asarray(Bn), start_tile=jstart, options=JREF))
    with pytest.raises(ValueError, match="start_tile"):
        factorize_window_batched([probs[0][2]] * 2, start_tile=1, options=PREF)


def test_bucket_pads_to_a_power_of_two():
    """``bucket=True`` runs a batch of 3 as 4 and strips the padding: the
    results are the unpadded call's, bit for bit on the plain path."""
    _, grid, m, _, _ = _problem(96, 10, 5)
    mats = [BandedCTSF(grid, *(s * x for x in m.arrays())) for s in (1.0, 2.0, 3.0)]
    calls = []
    from repro_torch.core import cholesky
    real = cholesky._factorize_window_impl

    def spy(Dr, *a, **k):
        calls.append(Dr.shape[0])
        return real(Dr, *a, **k)

    cholesky._factorize_window_impl = spy
    try:
        fb = factorize_window_batched(mats, bucket=True, options=PREF)
        fn = factorize_window_batched(mats, bucket=False, options=PREF)
    finally:
        cholesky._factorize_window_impl = real
    assert calls == [4, 3]
    for a, b in zip(_arrays(fb.ctsf), _arrays(fn.ctsf)):
        assert a.shape[0] == 3 and torch.equal(a, b)
    assert torch.equal(fb.status, fn.status)
    Bn = torch.from_numpy(np.stack([_rhs(grid, 2, seed=i) for i in range(3)]))
    assert torch.equal(solve_many_batched(fb, Bn, bucket=True, options=REF),
                       solve_many_batched(fb, Bn, bucket=False, options=REF))
    assert torch.equal(selinv_batched(fb, bucket=True, options=REF).Dr,
                       selinv_batched(fb, bucket=False, options=REF).Dr)
