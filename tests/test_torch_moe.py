"""The port's MoE family (``models/moe.py`` inside ``models/transformer.py``)
against the JAX package's, on the CPU (``_lm_parity.py``'s steps).  The
model routes 8 experts top-2 with ``capacity_factor=0.5`` (assignments are
dropped at every capacity) and ``expert_pad_to=12`` (4 dead experts): at
float32 the loss at rtol 1e-5, every gradient (the router's through the
gates included) at rtol 1e-4 relative to the leaf's largest entry, the
prefill's logits and caches, then three decode steps' logits and caches, at
rtol 1e-5; one bfloat16 loss at rtol 2e-2.  ``moe_apply`` alone, with and
without drops and padding: its output and gradients against the
reference's, and its dispatch: the same assignments dropped, every
buffer row holding the reference's token, and the dispatch's gathered
backward equal to a gather's own.  Model: 2 layers, d_model 64, 4
heads, 2 KV heads, d_ff 48 an expert, vocab 128, seq 16."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from repro.models import moe as JMoE
from repro.models import transformer as JT
from repro_torch.models import moe as MoE
from repro_torch.models import registry as R
from repro_torch.models import transformer as T
from repro_torch.models.convert import params_from_numpy

import _lm_parity as P

BASE = dict(name="tiny-moe", family="moe", n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
            d_ff=48, vocab=128, head_dim=16, n_experts=8, top_k=2, capacity_factor=0.5,
            expert_pad_to=12)


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
    assert "['layers']['moe']['router']" in paths
    for (path, want), got in zip(results["ref"]["grads"], results["port"]["grads"]):
        P.close(got, want, 1e-4, path)
        if "router" in path:
            assert np.abs(want).max() > 0


def test_prefill_and_decode_match_reference(results):
    ref, got = results["ref"], results["port"]
    P.close(got["prefill"], ref["prefill"], 1e-5)
    for a, b in zip(got["prefill_caches"], ref["prefill_caches"]):
        P.close(a, b, 1e-5)
    for a, b in zip(got["decode"], ref["decode"]):
        P.close(a, b, 1e-5)
    for a, b in zip(got["decode_caches"], ref["decode_caches"]):
        P.close(a, b, 1e-5)


def test_bfloat16_loss_matches_reference_loosely(results):
    jc, tc = results["cfgs"]
    jr, tr = P.runs(compute_dtype="bfloat16")
    batch = P.make_batch(tc, seed=1)
    want = jax.jit(lambda q, b: JT.loss(q, b, jc, jr))(results["p"], batch)
    got = T.loss(params_from_numpy(results["p"]), P.tb(batch), tc, tr)
    np.testing.assert_allclose(float(got), float(want), rtol=2e-2)


# ---------------------------------------------------------------------------
# moe_apply alone
# ---------------------------------------------------------------------------

# (capacity_factor, expert_pad_to): no drops (capacity 12 of an average 4);
# drops; padded experts; both
APPLY_CASES = [(3.0, 0), (0.5, 0), (3.0, 12), (0.5, 12)]


def _moe_case(cf, pad, seed=7):
    p = JMoE.moe_params(jax.random.PRNGKey(seed), 32, 24, 8, pad_to=pad)
    p = jax.tree.map(lambda x: np.asarray(x + 0.05), p)
    x = np.random.default_rng(seed).standard_normal((2, 16, 32)).astype(np.float32)
    return p, x, dict(top_k=2, capacity_factor=cf)


@pytest.mark.parametrize("cf,pad", APPLY_CASES)
def test_moe_apply_and_gradients_match_reference(cf, pad):
    p, x, kw = _moe_case(cf, pad)
    f = lambda q, x_: jnp.sum(JMoE.moe_apply(q, x_, **kw) ** 2)
    want = jax.jit(lambda q, x_: JMoE.moe_apply(q, x_, **kw))(p, x)
    wg, wx = jax.jit(jax.grad(f, argnums=(0, 1)))(p, x)
    tp = {k: v.requires_grad_() for k, v in params_from_numpy(p).items()}
    tx = torch.from_numpy(x).requires_grad_()
    got = MoE.moe_apply(tp, tx, **kw)
    P.close(got.detach(), want, 1e-5)
    grads = torch.autograd.grad((got ** 2).sum(), [tp[k] for k in sorted(tp)] + [tx])
    for k, g in zip(sorted(tp) + ["x"], grads):
        P.close(g, wg[k] if k != "x" else wx, 1e-4, k)
    if pad:
        assert not grads[sorted(tp).index("wi")][8:].any()      # dead experts never routed


@pytest.mark.parametrize("cf,pad", APPLY_CASES)
def test_dispatch_backward_equals_the_gathers_own(cf, pad):
    """``_Dispatch``'s backward (each token's kept rows gathered and summed
    in slot order) against autograd through ``torch.gather`` and the
    empty rows' mask, in float64."""
    p, x, kw = _moe_case(cf, pad)
    tp = params_from_numpy(p)
    r = MoE.moe_routing(tp, torch.from_numpy(x), **kw)
    k, n = kw["top_k"], r["src"].shape[1]
    tok = torch.div(r["src"].clamp_min(0), k, rounding_mode="floor")
    gbuf = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (2, n, 32))).to(torch.float64)
    got_x = torch.from_numpy(x).double().requires_grad_()
    buf = MoE._Dispatch.apply(got_x, tok, r["src"] >= 0, r["slot"], r["keep"], k)
    got, = torch.autograd.grad(buf, got_x, gbuf)
    want_x = torch.from_numpy(x).double().requires_grad_()
    plain = torch.gather(want_x, 1, tok[..., None].expand(-1, -1, 32))
    plain = torch.where((r["src"] >= 0)[..., None], plain, torch.zeros((), dtype=torch.float64))
    want, = torch.autograd.grad(plain, want_x, gbuf)
    assert torch.equal(buf.detach(), plain.detach())
    torch.testing.assert_close(got, want, rtol=1e-12, atol=1e-12)
    assert want.abs().max() > 0


@pytest.mark.parametrize("cf,pad", APPLY_CASES)
def test_dispatch_drops_the_reference_assignments(cf, pad):
    """The kept (token, expert) pairs and the token in every buffer row
    equal the reference's ``_dispatch_one``'s, sequence by sequence."""
    p, x, kw = _moe_case(cf, pad)
    r = MoE.moe_routing(params_from_numpy(p), torch.from_numpy(x), **kw)
    cap, Ep, k = r["cap"], r["ep"], kw["top_k"]
    logits = np.einsum("bsd,de->bse", x, p["router"])
    dispatch = jax.jit(lambda x_, lg: JMoE._dispatch_one(x_, lg, k, cap, Ep)[1])
    dropped = 0
    for b in range(x.shape[0]):
        keep, dest, st, _ = dispatch(x[b], logits[b])
        keep, dest, st = (np.asarray(a) for a in (keep, dest, st))
        want = {(int(t), int(d) // cap) for t, d, kp in zip(st, dest, keep) if kp}
        ex, kp = r["expert"][b].numpy(), r["keep"][b].numpy()
        got = {(i // k, int(ex[i])) for i in range(len(ex)) if kp[i]}
        assert got == want
        rows = {int(d): int(t) for t, d, kp_ in zip(st, dest, keep) if kp_}
        src = r["src"][b].numpy()
        assert {j: int(s) // k for j, s in enumerate(src) if s >= 0} == rows
        dropped += int((~keep).sum())
    assert (dropped > 0) == (cf < 1)


def test_the_moe_layer_is_laid_out_as_the_reference():
    jc, tc = P.cfgs(BASE)
    jp = jax.jit(lambda key: JT.init(key, jc))(jax.random.PRNGKey(0))
    tp = T.init(torch.Generator().manual_seed(0), tc)
    P.check_layout(jp, tp)
    assert "mlp" not in tp["layers"]
    assert tp["layers"]["moe"]["router"].shape == (2, 64, 8)          # routable experts
    assert tp["layers"]["moe"]["wi"].shape == (2, 12, 64, 48)         # padded
    assert isinstance(R.build_module(tc, P.runs()[1], tp), T.Transformer)
