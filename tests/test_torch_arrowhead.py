"""The port's arrowhead preconditioner (``optim/arrowhead.py``) against the
JAX package's, on the CPU, where the window factorization takes its plain
``"ring"`` path in both packages: ``build_precond``'s plans (names and
index arrays, exactly), ``update_stats``, ``factorize`` and
``precondition`` at rtol 1e-5 (relative to each array's largest entry),
a forced plan whose top-up entry samples a leaf already in the plan at
shared indices (the repeated indices accumulate in both), band 2 over 2
layers (the grid clips the band to ``bt = ndt - 1 = 1``: every layer
block couples to every other), and the reference's three
preconditioner tests (``tests/test_substrate.py:55-110``) mirrored.
Sketch dim r = 8, the small model of the other LM tests."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from repro.configs.base import ModelConfig as JModelConfig
from repro.core.ctsf import BandedCTSF as JBandedCTSF
from repro.models import transformer as JT
from repro.optim import arrowhead as JA
from repro_torch import pytree
from repro_torch.configs.base import ModelConfig
from repro_torch.core.ctsf import BandedCTSF
from repro_torch.models.convert import params_from_numpy
from repro_torch.optim import arrowhead as A

SMALL = dict(name="tiny", family="dense", n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
             d_ff=96, vocab=128, head_dim=16)
LM100M = dict(name="lm-100m", family="dense", n_layers=12, d_model=768, n_heads=12,
              n_kv_heads=4, d_ff=2048, vocab=8192, head_dim=64, qk_norm=True)


def _close(got, want, rtol=1e-5):
    got = got.detach().cpu().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * (np.abs(want).max() or 1.0))


def _same_plans(tp, jp):
    for got, want in ((tp.layer_plan, jp.layer_plan), (tp.arrow_plan, jp.arrow_plan)):
        assert [n for n, _ in got] == [n for n, _ in want]
        for (_, a), (_, b) in zip(got, want):
            np.testing.assert_array_equal(a, b)
    assert (tp.grid.t, tp.grid.n_diag_tiles, tp.grid.band_tiles, tp.grid.n_arrow_tiles) == (
        jp.grid.t, jp.grid.n_diag_tiles, jp.grid.band_tiles, jp.grid.n_arrow_tiles)


@pytest.mark.parametrize("cfg,r,band,seed", [(SMALL, 8, 1, 0), (SMALL, 8, 2, 3),
                                             (LM100M, 32, 2, 0), (LM100M, 8, 1, 7)])
def test_plans_equal_the_reference(cfg, r, band, seed):
    """Shapes only: the reference's ``eval_shape`` tree against the
    port's tree of meta tensors of the same shapes (lm-100m at full
    width)."""
    jshape = jax.eval_shape(lambda k: JT.init(k, JModelConfig(**cfg)), jax.random.PRNGKey(0))
    tshape = jax.tree.map(lambda s: torch.empty(s.shape, device="meta"), jshape)
    _same_plans(A.build_precond(tshape, r=r, band=band, seed=seed),
                JA.build_precond(jshape, r=r, band=band, seed=seed))


def _case(band=2, seed=0, n_grads=3, ema=0.5, damping=1e-2):
    """Both packages' preconditioners on the small model's converted
    parameters, and a few seeded gradient trees (jax arrays; the port
    takes them through ``params_from_numpy``)."""
    jp = jax.tree.map(np.asarray, JT.init(jax.random.PRNGKey(seed), JModelConfig(**SMALL)))
    tparams = params_from_numpy(jp)
    jpre = JA.build_precond(jp, r=8, band=band, ema=ema, damping=damping, seed=seed)
    tpre = A.build_precond(tparams, r=8, band=band, ema=ema, damping=damping, seed=seed)
    rng = np.random.default_rng(seed + 10)
    grads = [jax.tree.map(lambda x: jnp.asarray(rng.standard_normal(x.shape), jnp.float32), jp)
             for _ in range(n_grads)]
    return jpre, tpre, grads


def _run_both(jpre, tpre, grads):
    js, ts = jpre.init_state(), tpre.init_state("cpu")
    for g in grads:
        js = jpre.update_stats(js, g)
        ts = tpre.update_stats(ts, params_from_numpy(g))
    return js, ts


@pytest.mark.parametrize("band", [1, 2])
def test_stats_factor_and_preconditioned_gradient_match_reference(band):
    """band 2 over the 2 layers: the band clipped to ``bt = ndt - 1``."""
    jpre, tpre, grads = _case(band=band)
    js, ts = _run_both(jpre, tpre, grads)
    for k in ("Dr", "R", "C"):
        _close(ts[k], js[k])
    assert int(ts["count"]) == int(js["count"]) == len(grads)
    R_before = ts["R"].clone()
    jf, tf = jpre.factorize(js), tpre.factorize(ts)
    assert torch.equal(ts["R"], R_before)              # the state is not written
    for k in ("Dr", "R", "C"):
        _close(tf[k], jf[k])
    g = grads[-1]
    tg = params_from_numpy(g)
    jd = jpre.precondition(jf, g)
    td = tpre.precondition(tf, tg)
    for (path, a), b in zip(jax.tree_util.tree_leaves_with_path(jd), pytree.leaves(td)):
        _close(b, a)
    assert all(torch.equal(a, b) for a, b in zip(pytree.leaves(tg),
                                                 pytree.leaves(params_from_numpy(g))))
    lsk, ask = tpre.sketch(tg)
    jl, ja = jpre.sketch(g)
    _close(lsk, jl)
    _close(ask, ja)


def test_repeated_indices_accumulate_as_the_reference():
    """A forced plan whose top-up entry samples ``layers/mlp/wi`` again at
    indices 5 and 9 of its first entry: the lift adds both corrections
    there (``index_add_``, as the reference's ``.at[idx].add``), and the
    whole preconditioned tree equals the reference's."""
    jpre, tpre, grads = _case(band=2, seed=1)
    plan = [("layers/mlp/wi", np.array([0, 5, 9])), ("layers/attn/wq", np.array([1, 2, 3])),
            ("layers/mlp/wi", np.array([5, 9]))]
    jpre.layer_plan = tpre.layer_plan = plan
    js, ts = _run_both(jpre, tpre, grads)
    jf, tf = jpre.factorize(js), tpre.factorize(ts)
    g = params_from_numpy(grads[0])
    jd = jpre.precondition(jf, grads[0])
    td = tpre.precondition(tf, g)
    for a, b in zip(jax.tree.leaves(jd), pytree.leaves(td)):
        _close(b, a)
    # d = g + (x - lsk) at each sampled column: twice at the shared ones
    lsk, ask = tpre.sketch(g)
    dl = tpre.solve_sketch(tf, lsk, ask)[0] - lsk
    got = td["layers"]["mlp"]["wi"].reshape(2, -1)
    base = g["layers"]["mlp"]["wi"].reshape(2, -1)
    torch.testing.assert_close(got[:, 5], base[:, 5] + dl[:, 1] + dl[:, 6])
    torch.testing.assert_close(got[:, 0], base[:, 0] + dl[:, 0])


# ---- the reference's preconditioner tests, mirrored -------------------------

def _toy_params(L=6, d=40, seed=0):
    k = jax.random.PRNGKey(seed)
    return {"embed": np.asarray(jax.random.normal(k, (32, 8))),
            "layers": {"w": np.asarray(jax.random.normal(k, (L, d)))}}


def test_precond_identity_when_unit_curvature():
    """With A = I (damping-dominated, fresh stats), d == g (the
    reference's atol 1e-4)."""
    params = params_from_numpy(_toy_params())
    pre = A.build_precond(params, r=8, band=2, damping=1.0)
    factor = pre.factorize(pre.init_state("cpu"))
    grads = pytree.tree_map(lambda p: torch.ones_like(p) * 0.5, params)
    out = pre.precondition(factor, grads)
    for a, b in zip(pytree.leaves(out), pytree.leaves(grads)):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-4)


def test_precond_shrinks_high_curvature_directions():
    """Directions with accumulated curvature are damped relative to A=I."""
    params = params_from_numpy(_toy_params())
    pre = A.build_precond(params, r=8, band=1, damping=1e-2, ema=0.0)
    state = pre.init_state("cpu")
    grads = pytree.tree_map(torch.ones_like, params)
    for _ in range(5):
        state = pre.update_stats(state, grads)
    out = pre.precondition(pre.factorize(state), grads)
    lsk_g, _ = pre.sketch(grads)
    lsk_o, _ = pre.sketch(out)
    assert float(torch.linalg.norm(lsk_o)) < float(torch.linalg.norm(lsk_g))


def test_precond_solves_assembled_system():
    """The factor of the damped statistics is a Cholesky factor of an SPD
    matrix, and equal to the reference's on the same gradients."""
    jparams = _toy_params()
    params = params_from_numpy(jparams)
    jpre = JA.build_precond(jparams, r=8, band=2, damping=0.1, ema=0.5)
    pre = A.build_precond(params, r=8, band=2, damping=0.1, ema=0.5)
    js, state = jpre.init_state(), pre.init_state("cpu")
    rng = np.random.default_rng(0)
    for _ in range(4):
        g = jax.tree.map(lambda p: jnp.asarray(rng.standard_normal(p.shape), jnp.float32),
                         jparams)
        js = jpre.update_stats(js, g)
        state = pre.update_stats(state, params_from_numpy(g))
    factor = pre.factorize(state)
    L = np.tril(BandedCTSF(pre.grid, factor["Dr"], factor["R"], factor["C"]).to_dense())
    Ad = L @ L.T
    assert np.isfinite(Ad).all()
    assert np.linalg.eigvalsh(Ad).min() > 0
    jf = jpre.factorize(js)
    Lj = np.tril(JBandedCTSF(jpre.grid, jf["Dr"], jf["R"], jf["C"]).to_dense())
    _close(L, Lj)
