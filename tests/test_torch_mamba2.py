"""The port's Mamba2 LM (``models/mamba2.py``) against the JAX package's, on
the CPU (``_lm_parity.py``'s steps): at float32 the loss at rtol 1e-5,
every gradient at rtol 1e-4 relative to the leaf's largest entry, the
prefill's logits and every cache leaf (SSM state, conv tail), then three
decode steps' logits and caches, at rtol 1e-5; one bfloat16 loss at rtol
2e-2.  The SSD core alone: the port's chunked scan against its own
recurrent decode stepped token by token (chunks that divide the sequence
and ones that do not), and each against the reference's; the masked
exponential (the port's deliberate departure) gives the reference's values
where they are finite and finite gradients where the reference's are NaN.
Model: 2 layers, d_model 64, 2 groups of 4 heads of 16, state 16, vocab
128, seq 16, chunks of 8."""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from repro.models import mamba2 as JM
from repro_torch import pytree
from repro_torch.models import mamba2 as M
from repro_torch.models import registry as R

import _lm_parity as P

BASE = dict(name="tiny-ssm", family="ssm", n_layers=2, d_model=64, n_heads=0, n_kv_heads=0,
            d_ff=0, vocab=128, head_dim=16, ssm_state=16, ssm_head_dim=16, ssm_groups=2,
            attn_kind="none")


@pytest.fixture(scope="module")
def results():
    jc, tc = P.cfgs(BASE)
    jr, tr = P.runs()
    p = P.ref_params(jc)
    batch = P.make_batch(tc)
    ref = P.reference(jc, jr, p, batch)
    return {"ref": ref, "port": P.port(tc, tr, p, batch, ref["tokens"]), "p": p,
            "batch": batch, "cfgs": (jc, tc)}


def test_loss_matches_reference(results):
    P.close(results["port"]["loss"], results["ref"]["loss"], 1e-5)


def test_gradients_match_reference(results):
    for (path, want), got in zip(results["ref"]["grads"], results["port"]["grads"]):
        P.close(got, want, 1e-4, path)


def test_prefill_matches_reference(results):
    ref, got = results["ref"], results["port"]
    P.close(got["prefill"], ref["prefill"], 1e-5)
    assert len(got["prefill_caches"]) == len(ref["prefill_caches"]) == 2     # conv, state
    for a, b in zip(got["prefill_caches"], ref["prefill_caches"]):
        assert a.shape == b.shape and a.dtype == b.dtype
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
    p, batch = results["p"], P.make_batch(tc, seed=1)
    want = jax.jit(lambda q, b: JM.loss(q, b, jc, jr))(p, batch)
    from repro_torch.models.convert import params_from_numpy
    got = M.loss(params_from_numpy(p), P.tb(batch), tc, tr)
    np.testing.assert_allclose(float(got), float(want), rtol=2e-2)


@pytest.mark.parametrize("remat", ["full", "dots"])
def test_remat_gives_the_same_loss_and_gradients(results, remat):
    _, tc = results["cfgs"]
    _, tr0 = P.runs()
    _, tr1 = P.runs(remat=remat)
    params = M.init(torch.Generator().manual_seed(0), tc)
    batch = P.make_batch(tc, seed=2)
    l0, g0 = P.port_loss_and_grads(tc, tr0, params, batch)
    l1, g1 = P.port_loss_and_grads(tc, tr1, params, batch)
    torch.testing.assert_close(l1, l0, rtol=1e-6, atol=0)
    for a, b in zip(g1, g0):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-7)


# ---------------------------------------------------------------------------
# the SSD core
# ---------------------------------------------------------------------------

def _ssd_inputs(S, seed=3, Bn=2, H=6, P_=8, G=2, N=5, dt_scale=1.0):
    r = np.random.default_rng(seed)
    f = lambda *shape: r.standard_normal(shape).astype(np.float32)
    return dict(x=f(Bn, S, H, P_), dt=(dt_scale * np.abs(f(Bn, S, H))).astype(np.float32),
                a_log=0.3 * f(H), bmat=f(Bn, S, G, N), cmat=f(Bn, S, G, N), d_skip=f(H))


def _stepped(inp, decode):
    """y and the final state by the one-token recurrence, token by token."""
    x, dt, bm, cm = inp["x"], inp["dt"], inp["bmat"], inp["cmat"]
    Bn, S, H, P_ = x.shape
    G, N = bm.shape[2:]
    state = torch.zeros((Bn, G, H // G, P_, N))
    ys = []
    for s in range(S):
        y, state = decode(state, x[:, s], dt[:, s], inp["a_log"], bm[:, s], cm[:, s],
                          inp["d_skip"])
        ys.append(y)
    return torch.stack(ys, 1), state


# (S, chunk): one chunk, chunks that divide S, chunks that do not (8 -> 5
# for 15 tokens, 5 -> 4 for 12)
SSD_CASES = [(16, 16), (16, 8), (15, 8), (12, 5)]


@pytest.mark.parametrize("S,chunk", SSD_CASES)
def test_chunked_scan_matches_its_stepped_decode(S, chunk):
    inp = {k: torch.from_numpy(v) for k, v in _ssd_inputs(S).items()}
    y, final = M.ssd_chunked(**inp, chunk=chunk)
    ys, state = _stepped(inp, M.ssd_decode)
    P.close(y, ys, 1e-5)
    P.close(final, state, 1e-5)


@pytest.mark.parametrize("S,chunk", SSD_CASES)
def test_ssd_matches_reference(S, chunk):
    inp = _ssd_inputs(S, seed=4)
    tin = {k: torch.from_numpy(v) for k, v in inp.items()}
    y, final = M.ssd_chunked(**tin, chunk=chunk)
    jy, jfinal = JM.ssd_chunked(**inp, chunk=chunk)
    P.close(y, jy, 1e-5)
    P.close(final, jfinal, 1e-5)
    st = np.random.default_rng(5).standard_normal(np.asarray(jfinal).shape).astype(np.float32)
    args = (inp["x"][:, 0], inp["dt"][:, 0], inp["a_log"], inp["bmat"][:, 0],
            inp["cmat"][:, 0], inp["d_skip"])
    got = M.ssd_decode(torch.from_numpy(st), *(torch.from_numpy(a) for a in args))
    want = JM.ssd_decode(st, *args)
    for a, b in zip(got, want):
        P.close(a, b, 1e-5)


def test_masked_exponential_departure():
    """Large steps (``dt`` ~ 30, chunks of 8) make ``seg`` above the
    diagonal some 200: the reference's ``exp`` overflows there, its forward
    still finite (the mask selects 0) but its gradient NaN.  The port fills
    those entries with -inf before the exponential: the same forward
    values, finite gradients."""
    inp = _ssd_inputs(16, seed=6, dt_scale=30.0)
    f = lambda x, dt: jnp.sum(JM.ssd_chunked(x, dt, inp["a_log"], inp["bmat"], inp["cmat"],
                                             inp["d_skip"], chunk=8)[0])
    want_y = np.asarray(JM.ssd_chunked(**inp, chunk=8)[0])
    want_g = jax.grad(f, argnums=(0, 1))(inp["x"], inp["dt"])
    assert np.isfinite(want_y).all()
    assert not all(np.isfinite(np.asarray(g)).all() for g in want_g)   # the reference's NaN
    tin = {k: torch.from_numpy(v) for k, v in inp.items()}
    tin["x"].requires_grad_()
    tin["dt"].requires_grad_()
    y, _ = M.ssd_chunked(**tin, chunk=8)
    P.close(y.detach(), want_y, 1e-5)
    gx, gdt = torch.autograd.grad(y.sum(), (tin["x"], tin["dt"]))
    assert torch.isfinite(gx).all() and torch.isfinite(gdt).all()


# ---------------------------------------------------------------------------
# layout
# ---------------------------------------------------------------------------

def test_parameters_and_caches_are_laid_out_as_the_reference():
    """init's names, shapes and stacked layer axis in the reference's leaf
    order; the module's parameters under the same names; the decode
    caches' shapes and dtypes; the registry's entry points."""
    jc, tc = P.cfgs(BASE)
    jp = jax.jit(lambda k: JM.init(k, jc))(jax.random.PRNGKey(0))
    tp = M.init(torch.Generator().manual_seed(0), tc)
    P.check_layout(jp, tp)
    assert tp["layers"]["w_in"].shape == (2, 64, 2 * 128 + 2 * 2 * 16 + 8)
    model = R.build_module(tc, P.runs()[1], tp)
    assert isinstance(model, M.Mamba2)
    assert sorted(n.replace(".", "/") for n, _ in model.named_parameters()) == sorted(
        "tree/" + p for p in P.leaf_paths(jp))
    batch = P.tb(P.make_batch(tc))
    assert torch.equal(model(batch), M.loss(tp, batch, tc, P.runs()[1]))
    P.check_layout(JM.init_cache(jc, 2, 10), M.init_cache(tc, 2, 10, device="cpu"))
    api = R.get_model(tc)
    assert (api.loss, api.decode_step, api.init_cache) == (M.loss, M.decode_step, M.init_cache)
    assert dataclasses.replace(tc).d_inner == 128 and tc.ssm_heads == 8
    assert [p for p, _ in pytree.leaves_with_path(model.params())] == P.leaf_paths(jp)
