"""The port's ``core/concurrent.py`` (the mesh-less half) against the JAX
package's, on the CPU: ``stack_ctsf`` with and without a policy (its
"equal structure" refusal included) and the five ``concurrent_*`` entry
points on a batch of θ-candidates and on a stacked mixed-size batch, the
JAX side with ``impl="ref"``, at rtol = atol = 2e-4 (float32, sums in
another order); each element also against the port's unbatched call on
it.  ``mesh=`` is refused until the distributed slice."""
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import repro.core as J
from repro.core import concurrent as jconcurrent
from repro_torch.core import (BandedCTSF, GridBucketPolicy, SolverOptions, TileGrid,
                              embed_ctsf, factorize_window, logdet, selected_inverse,
                              solve_many)
from repro_torch.core.concurrent import (concurrent_factorize, concurrent_logdet,
                                         concurrent_quadratic_forms, concurrent_selinv,
                                         concurrent_solve, stack_ctsf)
from repro_torch.data import make_arrowhead

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


def test_mesh_is_refused_until_the_distributed_slice():
    pairs = _theta(*GRIDS[0])
    batch = stack_ctsf([p[0] for p in pairs])
    with pytest.raises(NotImplementedError, match="A4"):
        concurrent_factorize(batch, mesh=object())
    f = concurrent_factorize(batch, options=REF)
    with pytest.raises(NotImplementedError, match="A4"):
        concurrent_selinv(f, mesh=object())
    with pytest.raises(TypeError):
        concurrent_factorize(batch, None)
