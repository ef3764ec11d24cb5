"""The port's ``core/concurrent.py`` against the JAX package's, on the
CPU: ``stack_ctsf`` with and without a policy (its "equal structure"
refusal included) and the five ``concurrent_*`` entry points on a batch of
θ-candidates and on a stacked mixed-size batch, the JAX side with
``impl="ref"``, at rtol = atol = 2e-4 (float32, sums in another order);
each element also against the port's unbatched call on it.  ``mesh=``: the
batch sharded over the ``data`` axis of a (2, 2) mesh of four gloo ranks
(``launch/mesh.py::run_local``), with and without a policy: each rank's
elements bit for bit the unsharded port call's and within 2e-4 of the
reference's ``concurrent_factorize`` on a one-device mesh, the logdets
the whole batch's on every rank and within 1e-2 relative of ``slogdet``
(the reference's gate), ``concurrent_selinv(mesh=)`` bit for bit
``selinv_batched``'s, and a faulted batch's ``FactorInfo`` the unsharded
call's on every rank.  A mesh that is not a ``DeviceMesh`` raises
``TypeError``."""
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import _torch_ranks
import repro.core as J
from repro.core import concurrent as jconcurrent
from repro_torch.core import (BandedCTSF, GridBucketPolicy, SolverOptions, TileGrid,
                              embed_ctsf, factorize_window, logdet, selected_inverse,
                              solve_many)
from repro_torch.core.concurrent import (concurrent_factorize, concurrent_logdet,
                                         concurrent_quadratic_forms, concurrent_selinv,
                                         concurrent_solve, stack_ctsf)
from repro_torch.data import make_arrowhead
from repro_torch.launch.mesh import run_local
from repro_torch.runtime.fault_tolerance import NumericalFaultInjector

TOL = dict(rtol=2e-4, atol=2e-4)
REF = SolverOptions(impl="ref")
JREF = J.SolverOptions(impl="ref")
POLICY = GridBucketPolicy()
JPOLICY = J.GridBucketPolicy()
# (n, bandwidth, arrow, t): the batches' grids
GRIDS = [(96, 16, 8, 8), (150, 20, 12, 8)]


def _pair(A, st, t):
    grid = TileGrid(st, t)
    jgrid = J.TileGrid(J.ArrowheadStructure(n=st.n, bandwidth=st.bandwidth, arrow=st.arrow), t)
    return BandedCTSF.from_sparse(A, grid, device="cpu"), J.BandedCTSF.from_sparse(A, jgrid)


def _theta(n, bw, ar, t, nb=3, seed=0):
    """``nb`` θ-candidates ``τ A + δ I`` of one matrix in both packages."""
    A, st = make_arrowhead(n, bw, ar, rho=0.6, seed=seed)
    rng = np.random.default_rng(seed)
    tau, delta = rng.uniform(0.5, 2.0, nb), rng.uniform(0.0, 0.5, nb)
    eye = sp.identity(A.shape[0], format="csr")
    return [_pair((tau[i] * A + delta[i] * eye).tocsr(), st, t) for i in range(nb)]


def _mixed():
    """Three matrices of three grids in both packages."""
    return [_pair(*make_arrowhead(n, bw, ar, rho=0.6, seed=i), 8)
            for i, (n, bw, ar) in enumerate([(96, 10, 5), (120, 18, 8), (70, 6, 3)])]


def _close(got, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_stack_ctsf_matches_reference():
    pairs = _theta(*GRIDS[0])
    stacked = stack_ctsf([p[0] for p in pairs])
    jstacked = jconcurrent.stack_ctsf([p[1] for p in pairs])
    assert stacked.grid == pairs[0][0].grid and stacked.Dr.shape[0] == 3
    for a, b in zip(stacked.arrays(), (jstacked.Dr, jstacked.R, jstacked.C)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_stack_ctsf_refuses_unequal_grids_without_a_policy():
    pairs = _mixed()
    for stack, mats in ((stack_ctsf, [p[0] for p in pairs]),
                        (jconcurrent.stack_ctsf, [p[1] for p in pairs])):
        with pytest.raises(ValueError, match="equal structure"):
            stack(mats)
        with pytest.raises(ValueError, match="at least one"):
            stack([])
    stacked = stack_ctsf([p[0] for p in pairs], policy=POLICY)
    jstacked = jconcurrent.stack_ctsf([p[1] for p in pairs], policy=JPOLICY)
    assert stacked.grid == POLICY.join([p[0].grid for p in pairs])
    for a, b in zip(stacked.arrays(), (jstacked.Dr, jstacked.R, jstacked.C)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("n,bw,ar,t", GRIDS)
@pytest.mark.parametrize("policy", [False, True])
def test_concurrent_entry_points_match_reference(n, bw, ar, t, policy):
    pairs = _theta(n, bw, ar, t)
    opts = SolverOptions(impl="ref", policy=POLICY if policy else None)
    jopts = J.SolverOptions(impl="ref", policy=JPOLICY if policy else None)
    batch = stack_ctsf([p[0] for p in pairs])
    jbatch = jconcurrent.stack_ctsf([p[1] for p in pairs])
    f = concurrent_factorize(batch, options=opts)
    jf = jconcurrent.concurrent_factorize(jbatch, options=jopts)
    assert (f.source_grid is not None) == policy
    for a, b in zip(f.ctsf.arrays(), (jf.ctsf.Dr, jf.ctsf.R, jf.ctsf.C)):
        _close(a, b)
    _close(concurrent_logdet(f), jconcurrent.concurrent_logdet(jf))
    g = pairs[0][0].grid
    y = np.random.default_rng(n).standard_normal(g.padded_n).astype(np.float32)
    Y = np.random.default_rng(n + 1).standard_normal((g.padded_n, 3)).astype(np.float32)
    for rhs in (y, Y):
        got = concurrent_solve(f, torch.from_numpy(rhs), options=REF)
        assert got.shape == (3,) + rhs.shape
        _close(got, jconcurrent.concurrent_solve(jf, jnp.asarray(rhs), options=JREF))
    q = concurrent_quadratic_forms(f, torch.from_numpy(y), options=REF)
    _close(q, jconcurrent.concurrent_quadratic_forms(jf, jnp.asarray(y), options=JREF))
    s = concurrent_selinv(f, options=REF)
    js = jconcurrent.concurrent_selinv(jf, options=JREF)
    assert s.grid == g
    for a, b in zip(s.arrays(), (js.Dr, js.R, js.C)):
        _close(a, b)
    # each element against the unbatched port call on it
    for i, (m, _) in enumerate(pairs):
        fi = factorize_window(m, options=REF)
        _close(logdet(f)[i], logdet(fi).numpy())
        x = solve_many(fi, torch.from_numpy(y)[:, None], options=REF)[:, 0]
        _close(concurrent_solve(f, torch.from_numpy(y), options=REF)[i], x.numpy())
        _close(q[i], (torch.from_numpy(y) @ x).numpy())
        _close(s.Dr[i], selected_inverse(fi, options=REF).Dr.numpy())


def test_concurrent_on_a_stacked_mixed_batch():
    """A mixed-size batch stacked on its shared rung: each element's factor
    and read-out, restricted, are its own problem's."""
    pairs = _mixed()
    stacked = stack_ctsf([p[0] for p in pairs], policy=POLICY)
    jstacked = jconcurrent.stack_ctsf([p[1] for p in pairs], policy=JPOLICY)
    f = concurrent_factorize(stacked, options=SolverOptions(impl="ref", policy=POLICY))
    jf = jconcurrent.concurrent_factorize(jstacked, options=J.SolverOptions(impl="ref",
                                                                           policy=JPOLICY))
    _close(f.ctsf.C, jf.ctsf.C)
    ld = concurrent_logdet(f)
    _close(ld, jconcurrent.concurrent_logdet(jf))
    cg = stacked.grid
    for i, (m, _) in enumerate(pairs):
        fi = factorize_window(m, options=REF)
        _close(ld[i], logdet(fi).numpy())
        emb = embed_ctsf(fi.ctsf, cg)
        _close(f.ctsf.Dr[i], emb.Dr.numpy())
        _close(f.ctsf.C[i], emb.C.numpy())


def test_mesh_that_is_not_a_device_mesh_is_refused():
    pairs = _theta(*GRIDS[0])
    batch = stack_ctsf([p[0] for p in pairs])
    with pytest.raises(TypeError, match="DeviceMesh"):
        concurrent_factorize(batch, mesh=object())
    f = concurrent_factorize(batch, options=REF)
    with pytest.raises(TypeError, match="DeviceMesh"):
        concurrent_selinv(f, mesh=object())
    with pytest.raises(TypeError):
        concurrent_factorize(batch, None)


# ---------------------------------------------------------------------------
# mesh=: the batch sharded over the "data" axis of a (2, 2) mesh of four
# gloo ranks (the reference's test shards 8 matrices over a (4, 2) mesh)
# ---------------------------------------------------------------------------

MESH = (2, 2)
MESH_POLICIES = [None, POLICY]


def _mesh_batch():
    """The reference's multi-device batch: 8 matrices of one grid, seeds
    0..7, in both packages; and the batch with element 2 indefinite and
    element 5 a NaN."""
    pairs = [_pair(*make_arrowhead(160, 16, 16, rho=0.5, seed=s), 16) for s in range(8)]
    batch = stack_ctsf([p[0] for p in pairs])
    faulted = NumericalFaultInjector(seed=0).corrupt(batch, {2: "indefinite", 5: "nan"})
    return pairs, batch, faulted


@pytest.fixture(scope="module")
def mesh_run():
    pairs, batch, faulted = _mesh_batch()
    outs = run_local(_torch_ranks.concurrent, batch, faulted, MESH, MESH_POLICIES,
                     world_size=4, timeout=120)
    return pairs, batch, faulted, outs


def _unsharded(batch, policy):
    return concurrent_factorize(batch, options=SolverOptions(policy=policy))


@pytest.mark.parametrize("p", range(len(MESH_POLICIES)))
def test_mesh_factor_is_the_unsharded_factor_bit_for_bit(mesh_run, p):
    _, batch, _, outs = mesh_run
    f = _unsharded(batch, MESH_POLICIES[p])
    for rank, o in enumerate(outs):
        run = o["runs"][p]
        lo = (rank // MESH[1]) * 4                     # the rank's place along "data"
        assert run["offset"] == lo
        assert (run["source_grid"] is None) == (MESH_POLICIES[p] is None)
        for a, b in zip(run["factor"], f.ctsf.arrays()):
            assert torch.equal(a, b[lo:lo + 4])
        # the per-element words are the whole batch's on every rank
        assert torch.equal(run["status"], f.status)
        assert torch.equal(run["logdet"], concurrent_logdet(f))
        # one launch a sweep for the rank's four elements
        assert run["launches"] == {"band_cholesky_sweep": 1, "potrf": 1, "trsm": 1}


@pytest.mark.parametrize("p", range(len(MESH_POLICIES)))
def test_mesh_factor_matches_reference_and_slogdet(mesh_run, p):
    import jax
    from jax.sharding import Mesh
    pairs, _, _, outs = mesh_run
    jpol = JPOLICY if MESH_POLICIES[p] is not None else None
    mesh = Mesh(np.array(jax.devices()[:1]).reshape(1, 1), ("data", "model"))
    jf = jconcurrent.concurrent_factorize(jconcurrent.stack_ctsf([q[1] for q in pairs]),
                                          mesh=mesh, axis="data",
                                          options=J.SolverOptions(impl="ref", policy=jpol))
    jld = np.asarray(jconcurrent.concurrent_logdet(jf))
    for rank, o in enumerate(outs):
        run = o["runs"][p]
        lo = (rank // MESH[1]) * 4
        for a, b in zip(run["factor"], (jf.ctsf.Dr, jf.ctsf.R, jf.ctsf.C)):
            _close(a, np.asarray(b)[lo:lo + 4])
        _close(run["logdet"], jld)
        for i, (m, _) in enumerate(pairs):
            _, want = np.linalg.slogdet(m.to_dense(lower_only=False).astype(np.float64))
            assert abs(float(run["logdet"][i]) - want) < 1e-2 * abs(want), i


@pytest.mark.parametrize("p", range(len(MESH_POLICIES)))
def test_mesh_selinv_is_the_unsharded_selinv_bit_for_bit(mesh_run, p):
    _, batch, _, outs = mesh_run
    s = concurrent_selinv(_unsharded(batch, MESH_POLICIES[p]), options=REF)
    for rank, o in enumerate(outs):
        run = o["runs"][p]
        lo = (rank // MESH[1]) * 4
        for key in ("sigma", "sigma_whole"):
            for a, b in zip(run[key], s.arrays()):
                assert torch.equal(a, b[lo:lo + 4])


def test_mesh_faulted_batch_gives_every_rank_the_unsharded_info(mesh_run):
    _, _, faulted, outs = mesh_run
    ff = concurrent_factorize(faulted, options=SolverOptions(regularize=True))
    want = (ff.info.status, ff.info.attempts, ff.info.tau, ff.info.min_pivot,
            ff.info.first_bad_tile)
    assert ff.info.status.tolist() == [0, 0, 1, 0, 0, 2, 0, 0]
    for rank, o in enumerate(outs):
        got = o["faulted"]
        for a, b in zip(got["info"], want):
            torch.testing.assert_close(a, b, rtol=0, atol=0, equal_nan=True)
        torch.testing.assert_close(got["status"], ff.status, rtol=0, atol=0, equal_nan=True)
        lo = got["offset"]
        for a, b in zip(got["factor"], ff.ctsf.arrays()):
            torch.testing.assert_close(a, b[lo:lo + 4], rtol=0, atol=0, equal_nan=True)


def test_mesh_refusals_on_a_rank(mesh_run):
    for o in mesh_run[3]:
        uneven, other_axis = o["errors"]
        assert uneven == "ValueError: a batch of 3 does not split over mesh axis data=2"
        assert other_axis.startswith("ValueError: the factor is sharded over axis 'data'")
