"""The port's Zamba2 hybrid (``models/zamba2.py``) against the JAX package's,
on the CPU (``_lm_parity.py``'s steps): at float32 the loss at rtol 1e-5,
every gradient at rtol 1e-4 relative to the leaf's largest entry (the shared
block's accumulated over its applications), the prefill's logits and every
cache leaf (the SSM states and conv tails of 12 layers, the 2 key/value
caches), then three decode steps' logits and caches, at rtol 1e-5; one
bfloat16 loss at rtol 2e-2.  Remat (nested checkpoints: a superblock, and
each Mamba2 layer inside it) gives the same loss and gradients; the
arrowhead preconditioner sees 2 diagonal blocks.  Model: 2 superblocks of 6
Mamba2 layers, d_model 64, the shared block on 128 with 4 heads of 32,
d_ff 96, state 16, heads of 16, vocab 128, seq 16."""
import numpy as np
import pytest
import torch

import jax
from repro.models import zamba2 as JZ
from repro.optim.arrowhead import build_precond as jbuild_precond
from repro_torch.models import registry as R
from repro_torch.models import zamba2 as Z
from repro_torch.models.convert import params_from_numpy
from repro_torch.optim.arrowhead import build_precond

import _lm_parity as P

BASE = dict(name="tiny-hybrid", family="hybrid", n_layers=12, d_model=64, n_heads=4,
            n_kv_heads=4, d_ff=96, vocab=128, head_dim=32, ssm_state=16, ssm_head_dim=16,
            shared_attn_every=6)


@pytest.fixture(scope="module")
def results():
    jc, tc = P.cfgs(BASE)
    jr, tr = P.runs()
    p = P.ref_params(jc)
    batch = P.make_batch(tc)
    ref = P.reference(jc, jr, p, batch)
    return {"ref": ref, "port": P.port(tc, tr, p, batch, ref["tokens"]), "p": p,
            "cfgs": (jc, tc)}


def test_loss_matches_reference(results):
    P.close(results["port"]["loss"], results["ref"]["loss"], 1e-5)


def test_gradients_match_reference(results):
    paths = [path for path, _ in results["ref"]["grads"]]
    assert "['shared']['attn']['wq']" in paths
    for (path, want), got in zip(results["ref"]["grads"], results["port"]["grads"]):
        P.close(got, want, 1e-4, path)


def test_prefill_matches_reference(results):
    ref, got = results["ref"], results["port"]
    P.close(got["prefill"], ref["prefill"], 1e-5)
    assert [a.shape for a in got["prefill_caches"]] == [b.shape for b in ref["prefill_caches"]]
    for a, b in zip(got["prefill_caches"], ref["prefill_caches"]):
        P.close(a, b, 1e-5)


def test_decode_steps_match_reference(results):
    ref, got = results["ref"], results["port"]
    for a, b in zip(got["decode"], ref["decode"]):
        P.close(a, b, 1e-5)
    for a, b in zip(got["decode_caches"], ref["decode_caches"]):
        P.close(a, b, 1e-5)


def test_bfloat16_loss_matches_reference_loosely(results):
    jc, tc = results["cfgs"]
    jr, tr = P.runs(compute_dtype="bfloat16")
    batch = P.make_batch(tc, seed=1)
    want = jax.jit(lambda q, b: JZ.loss(q, b, jc, jr))(results["p"], batch)
    got = Z.loss(params_from_numpy(results["p"]), P.tb(batch), tc, tr)
    np.testing.assert_allclose(float(got), float(want), rtol=2e-2)


@pytest.mark.parametrize("remat", ["full", "dots"])
def test_nested_remat_gives_the_same_loss_and_gradients(results, remat):
    _, tc = results["cfgs"]
    _, tr0 = P.runs()
    _, tr1 = P.runs(remat=remat)
    params = Z.init(torch.Generator().manual_seed(0), tc)
    batch = P.make_batch(tc, seed=2)
    l0, g0 = P.port_loss_and_grads(tc, tr0, params, batch)
    l1, g1 = P.port_loss_and_grads(tc, tr1, params, batch)
    torch.testing.assert_close(l1, l0, rtol=1e-6, atol=0)
    for a, b in zip(g1, g0):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-7)


def test_layout_caches_and_the_arrowhead_grid():
    """init's leaves (the Mamba2 layers stacked (n_super, per, ...)) and
    the caches (12 SSM layers, 2 key/value caches) as the reference's; the
    arrowhead's plans and grid equal the reference's: 2 diagonal blocks, the
    shared block in the arrow group."""
    jc, tc = P.cfgs(BASE)
    jp = jax.jit(lambda k: JZ.init(k, jc))(jax.random.PRNGKey(0))
    tp = Z.init(torch.Generator().manual_seed(0), tc)
    P.check_layout(jp, tp)
    assert tp["mamba"]["w_in"].shape[:2] == (2, 6)
    cache = Z.init_cache(tc, 2, 10, device="cpu")
    P.check_layout(JZ.init_cache(jc, 2, 10), cache)
    assert cache["k"].shape[0] == 2 and cache["ssm"]["state"].shape[0] == 12
    assert isinstance(R.build_module(tc, P.runs()[1], tp), Z.Zamba2)
    pre, jpre = build_precond(tp, r=8, band=2, seed=0), jbuild_precond(jp, r=8, band=2, seed=0)
    assert pre.n_layers == jpre.n_layers == 2
    g = pre.grid
    assert (g.t, g.n_diag_tiles, g.band_tiles, g.n_arrow_tiles) == (8, 2, 1, 1)
    assert [n for n, _ in pre.arrow_plan] == [n for n, _ in jpre.arrow_plan]
    assert any(n.startswith("shared/") for n, _ in pre.arrow_plan)
    for (n, a), (m, b) in zip(pre.layer_plan + pre.arrow_plan, jpre.layer_plan + jpre.arrow_plan):
        assert n == m and np.array_equal(a, b)
