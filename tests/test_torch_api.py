"""The port's entry points take their options by keyword only, on the CPU.

The JAX package's entry points take ``impl`` (or ``method``, or a random
key and a count) positionally right after their data; the port's take
them by keyword.  A call written the reference's way must not run with
another meaning in the port (``factorize_tasklist(tm, "ref")`` once turned
the tree reduction on), so each case calls the port's entry point the
reference's way and expects ``TypeError``, then calls it with keywords and
holds the result to the reference's own positional call at rtol = atol =
2e-4 (float32 on both sides, different summation orders).  The batched
and concurrent entry points refuse the reference's positional call too.

``SolverOptions`` is held to the reference's: its fields in the same order,
``compile_key``, ``replace``, ``resolve_options``'s one warning a legacy
field, and a ``policy`` of another type than ``GridBucketPolicy`` refused."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as J
from repro.data import make_arrowhead as jmake_arrowhead
from repro_torch.core import (BandedCTSF, CholeskyFactor, SolverOptions, TileGrid, TileMatrix,
                              backward_solve, backward_solve_many, factorize_tasklist,
                              factorize_window, factorize_window_batched, forward_solve,
                              forward_solve_many, marginal_variances, sample_gmrf,
                              sample_gmrf_many, selected_inverse, selinv_batched, solve,
                              solve_many, solve_many_batched)
from repro_torch.core.concurrent import (concurrent_quadratic_forms, concurrent_selinv,
                                         concurrent_solve)
from repro_torch.data import make_arrowhead

TOL = dict(rtol=2e-4, atol=2e-4)
REF = SolverOptions(impl="ref")
N, BW, AR, T = 130, 40, 30, 16


@functools.lru_cache(maxsize=None)
def _inputs():
    """One matrix in both packages (window and task-list layouts), the
    reference's factor carried into the port, a right-hand-side panel, the
    reference's normal draws and the variance indices."""
    A, st = make_arrowhead(N, BW, AR, rho=0.6, seed=0)
    jA, jst = jmake_arrowhead(N, BW, AR, rho=0.6, seed=0)
    jgrid = J.TileGrid(jst, t=T)
    jm = J.BandedCTSF.from_sparse(jA, jgrid)
    m = BandedCTSF.from_sparse(A, TileGrid(st, t=T), device="cpu")
    jtm = J.TileMatrix.from_sparse(jA, jgrid)
    tm = TileMatrix.from_sparse(A, TileGrid(st, t=T), device="cpu")
    jf = J.factorize_window(jm, "ref")
    f = CholeskyFactor.from_arrays((N, BW, AR, T), *(np.asarray(x) for x in jf.ctsf.arrays()),
                                   device="cpu")
    B = np.random.default_rng(1).standard_normal((jgrid.padded_n, 3)).astype(np.float32)
    B[jst.n_diag:jgrid.n_diag_tiles * T] = 0.0
    B[jgrid.n_diag_tiles * T + jst.arrow:] = 0.0
    key = jax.random.PRNGKey(7)
    z1 = np.array(jax.random.normal(key, (jgrid.padded_n,), dtype=jnp.float32))
    z4 = np.array(jax.random.normal(key, (jgrid.padded_n, 4), dtype=jnp.float32))
    idx = np.array([0, 7, N // 2, N - AR, N - 1])
    return dict(jm=jm, m=m, jtm=jtm, tm=tm, jf=jf, f=f, B=B, key=key, z1=z1, z4=z4, idx=idx)


def _t(x):
    return torch.from_numpy(x)


# name -> (the reference's positional call written against the port, the
# port's keyword call, the reference's positional call)
CASES = {
    "factorize_tasklist": (
        lambda d: factorize_tasklist(d["tm"], "ref"),
        lambda d: factorize_tasklist(d["tm"], tree_reduction=False, tree_workers=8, options=REF),
        lambda d: J.factorize_tasklist(d["jtm"], "ref")),
    "factorize_window": (
        lambda d: factorize_window(d["m"], "ref"),
        lambda d: factorize_window(d["m"], tree_chunks=8, options=REF).ctsf.Dr,
        lambda d: J.factorize_window(d["jm"], "ref").ctsf.Dr),
    "factorize_window_batched": (
        lambda d: factorize_window_batched([d["m"], d["m"]], "ref"),
        lambda d: factorize_window_batched([d["m"], d["m"]], tree_chunks=8, bucket=True,
                                           options=REF).ctsf.R,
        lambda d: J.factorize_window_batched([d["jm"], d["jm"]], "ref").ctsf.R),
    "forward_solve_many": (
        lambda d: forward_solve_many(d["f"], _t(d["B"]), "ref"),
        lambda d: forward_solve_many(d["f"], _t(d["B"]), start_tile=0, options=REF),
        lambda d: J.forward_solve_many(d["jf"], jnp.asarray(d["B"]), "ref")),
    "backward_solve_many": (
        lambda d: backward_solve_many(d["f"], _t(d["B"]), "ref"),
        lambda d: backward_solve_many(d["f"], _t(d["B"]), options=REF),
        lambda d: J.backward_solve_many(d["jf"], jnp.asarray(d["B"]), "ref")),
    "solve_many": (
        lambda d: solve_many(d["f"], _t(d["B"]), "ref"),
        lambda d: solve_many(d["f"], _t(d["B"]), options=REF),
        lambda d: J.solve_many(d["jf"], jnp.asarray(d["B"]), "ref")),
    "forward_solve": (
        lambda d: forward_solve(d["f"], _t(d["B"][:, 0]), "ref"),
        lambda d: forward_solve(d["f"], _t(d["B"][:, 0]), options=REF),
        lambda d: J.forward_solve(d["jf"], jnp.asarray(d["B"][:, 0]), "ref")),
    "backward_solve": (
        lambda d: backward_solve(d["f"], _t(d["B"][:, 0]), "ref"),
        lambda d: backward_solve(d["f"], _t(d["B"][:, 0]), options=REF),
        lambda d: J.backward_solve(d["jf"], jnp.asarray(d["B"][:, 0]), "ref")),
    "solve": (
        lambda d: solve(d["f"], _t(d["B"][:, 0]), "ref"),
        lambda d: solve(d["f"], _t(d["B"][:, 0]), options=REF),
        lambda d: J.solve(d["jf"], jnp.asarray(d["B"][:, 0]), "ref")),
    # torch cannot draw jax.random's numbers: the reference's z is passed in
    "sample_gmrf": (
        lambda d: sample_gmrf(d["f"], torch.Generator().manual_seed(0)),
        lambda d: sample_gmrf(d["f"], z=_t(d["z1"]), options=REF),
        lambda d: J.sample_gmrf(d["jf"], d["key"], "ref")),
    "sample_gmrf_many": (
        lambda d: sample_gmrf_many(d["f"], torch.Generator().manual_seed(0), 4),
        lambda d: sample_gmrf_many(d["f"], num=4, z=_t(d["z4"]), options=REF),
        lambda d: J.sample_gmrf_many(d["jf"], d["key"], 4, "ref")),
    "marginal_variances": (
        lambda d: marginal_variances(d["f"], d["idx"], "panels"),
        lambda d: marginal_variances(d["f"], d["idx"],
                                     options=SolverOptions(impl="ref", method="panels")),
        lambda d: J.marginal_variances(d["jf"], jnp.asarray(d["idx"]), "panels", "ref")),
    "selected_inverse": (
        lambda d: selected_inverse(d["f"], "ref"),
        lambda d: selected_inverse(d["f"], options=REF).R,
        lambda d: J.selected_inverse(d["jf"], "ref").R),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_options_are_keyword_only(name):
    """The reference's positional call raises ``TypeError`` in the port; the
    keyword call gives the reference's result."""
    positional, keyword, reference = CASES[name]
    d = _inputs()
    with pytest.raises(TypeError):
        positional(d)
    np.testing.assert_allclose(keyword(d).numpy(), np.asarray(reference(d)), err_msg=name,
                               **TOL)


def test_sample_gmrf_many_checks_z_against_num():
    """A given z must be the (padded_n, num) panel its count says."""
    d = _inputs()
    with pytest.raises(ValueError, match="num|4"):
        sample_gmrf_many(d["f"], num=3, z=_t(d["z4"]))


# ---------------------------------------------------------------------------
# SolverOptions against the reference's (field order, compile_key, the
# policy's type, resolve_options) and the refusals of the batched calls
# ---------------------------------------------------------------------------

def test_solver_options_fields_in_the_reference_order():
    """``SolverOptions(*args)`` means the same in both packages."""
    import dataclasses
    names = [f.name for f in dataclasses.fields(SolverOptions)]
    assert names == [f.name for f in dataclasses.fields(J.SolverOptions)]
    assert names == ["policy", "regularize", "impl", "sweep", "partition_plan", "method"]
    from repro_torch.core import GridBucketPolicy
    pol = GridBucketPolicy()
    got = SolverOptions(pol, True, "ref", "window", None, "panels")
    want = J.SolverOptions(J.GridBucketPolicy(), True, "ref", "window", None, "panels")
    assert [getattr(got, n) == getattr(want, n) for n in names[1:]] == [True] * 5
    assert got.policy == pol


COMPILE_KEY_CASES = [
    dict(),
    dict(impl="ref", method="panels"),
    dict(regularize=True, sweep="window"),
    dict(policy="default", regularize=True, impl="ref", method="selinv"),
    dict(policy="default", sweep="partitioned", plan=(0, 3, 6)),
]


@pytest.mark.parametrize("case", range(len(COMPILE_KEY_CASES)))
def test_compile_key_matches_reference(case):
    """``compile_key`` clears policy, regularize and method, as the
    reference's; ``replace`` is ``dataclasses.replace``."""
    import dataclasses
    from repro_torch.core import GridBucketPolicy, PartitionPlan
    kw = dict(COMPILE_KEY_CASES[case])
    plan = kw.pop("plan", None)
    pol = kw.pop("policy", None)
    got = SolverOptions(policy=GridBucketPolicy() if pol else None,
                        partition_plan=PartitionPlan(plan) if plan else None, **kw)
    want = J.SolverOptions(policy=J.GridBucketPolicy() if pol else None,
                           partition_plan=J.PartitionPlan(plan) if plan else None, **kw)
    gk, wk = got.compile_key(), want.compile_key()
    for f in dataclasses.fields(SolverOptions):
        g, w = getattr(gk, f.name), getattr(wk, f.name)
        assert (g.boundaries == w.boundaries) if f.name == "partition_plan" and g else g == w
    assert gk.policy is None and gk.regularize is None and gk.method is None
    assert hash(gk) == hash(SolverOptions(**{f.name: getattr(gk, f.name)
                                              for f in dataclasses.fields(gk)}))
    assert got.replace(impl="ref").impl == "ref" and got.replace().compile_key() == gk


@pytest.mark.parametrize("policy", ["default", 3, object(), J.GridBucketPolicy()])
def test_policy_must_be_a_grid_bucket_policy(policy):
    with pytest.raises(TypeError, match="GridBucketPolicy"):
        SolverOptions(policy=policy)


def test_resolve_options_warns_once_per_legacy_field():
    """Each legacy field passed warns once and overrides its field, as the
    reference's; none passed is the options object as it is."""
    import warnings
    from repro_torch.core import GridBucketPolicy, resolve_options
    from repro_torch.core.options import UNSET
    base = SolverOptions(impl="ref")
    assert resolve_options(base, impl=UNSET, policy=UNSET) is base
    assert resolve_options() == SolverOptions()
    for mod, opts, pol in ((None, base, GridBucketPolicy()),
                           (J, J.SolverOptions(impl="ref"), J.GridBucketPolicy())):
        resolve = resolve_options if mod is None else J.resolve_options
        unset = UNSET if mod is None else J.options.UNSET
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            out = resolve(opts, _where="solve", impl=unset, policy=pol, method="panels",
                          regularize=True)
        assert len(caught) == 3 and all(w.category is DeprecationWarning for w in caught)
        assert sorted(str(w.message).split("`")[1] for w in caught) == \
            ["method=", "policy=", "regularize="]
        assert (out.impl, out.method, out.regularize, out.policy) == ("ref", "panels", True, pol)
    with pytest.raises(TypeError, match="SolverOptions"):
        resolve_options("ref")
    assert not UNSET and repr(UNSET) == "<UNSET>"


def test_policy_and_start_tile_are_refused_together():
    from repro_torch.core import GridBucketPolicy
    d = _inputs()
    with pytest.raises(ValueError, match="start_tile"):
        factorize_window_batched([d["m"], d["m"]], start_tile=1,
                                 options=SolverOptions(impl="ref", policy=GridBucketPolicy()))
    with pytest.raises(ValueError, match="start_tile"):
        J.factorize_window_batched([d["jm"], d["jm"]], start_tile=1,
                                   options=J.SolverOptions(impl="ref",
                                                           policy=J.GridBucketPolicy()))


def _batched_factor():
    d = _inputs()
    return factorize_window_batched([d["m"], d["m"]], options=REF)


# the batched and concurrent entry points: the reference's positional call
# (impl, or mesh, after the data) written against the port, and the
# keyword call
BATCHED_CASES = {
    "solve_many_batched": (
        lambda f, B: solve_many_batched(f, B, "ref"),
        lambda f, B: solve_many_batched(f, B, start_tile=None, bucket=True, options=REF)),
    "selinv_batched": (
        lambda f, B: selinv_batched(f, "ref"),
        lambda f, B: selinv_batched(f, bucket=False, options=REF).Dr),
    "concurrent_solve": (
        lambda f, B: concurrent_solve(f, B[0], "ref"),
        lambda f, B: concurrent_solve(f, B[0], options=REF)),
    "concurrent_quadratic_forms": (
        lambda f, B: concurrent_quadratic_forms(f, B[0, :, 0], "ref"),
        lambda f, B: concurrent_quadratic_forms(f, B[0, :, 0], options=REF)),
    "concurrent_selinv": (
        lambda f, B: concurrent_selinv(f, None),
        lambda f, B: concurrent_selinv(f, mesh=None, options=REF).R),
}


@pytest.mark.parametrize("name", sorted(BATCHED_CASES))
def test_batched_entry_points_are_keyword_only(name):
    positional, keyword = BATCHED_CASES[name]
    f = _batched_factor()
    d = _inputs()
    B = torch.from_numpy(np.stack([d["B"], d["B"]]))
    with pytest.raises(TypeError):
        positional(f, B)
    assert torch.isfinite(keyword(f, B)).all()
