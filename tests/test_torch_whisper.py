"""The port's whisper encoder-decoder (``models/whisper.py``) against the JAX
package's, on the CPU (``_lm_parity.py``'s steps): at float32 the loss at
rtol 1e-5, every gradient at rtol 1e-4 relative to the leaf's largest
entry, the prefill's logits and every cache leaf (the self-attention
``k``/``v`` and the cross ``xk``/``xv``), then three decode steps' logits
and caches, at rtol 1e-5; one bfloat16 loss at rtol 2e-2; the encoder
alone.  The key biases' gradients vanish in exact arithmetic (without
rotary positions a key bias shifts a query's scores alike, which the
softmax cancels), so both packages' are rounding noise: each is held to
1e-6 of the largest gradient instead of to the other.  Model: 2 encoder
and 2 decoder layers, d_model 64, 4 heads of 16, d_ff 96, vocab 128, 16
frames, seq 16."""
import numpy as np
import pytest
import torch

import jax
from repro.models import whisper as JW
from repro.optim.arrowhead import build_precond as jbuild_precond
from repro_torch.models import registry as R
from repro_torch.models import whisper as W
from repro_torch.models.convert import params_from_numpy
from repro_torch.optim.arrowhead import build_precond

import _lm_parity as P

BASE = dict(name="tiny-encdec", family="encdec", n_layers=2, d_model=64, n_heads=4,
            n_kv_heads=4, d_ff=96, vocab=128, head_dim=16, norm="layernorm", act="gelu",
            encoder_layers=2, encoder_seq=16)


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
    gmax = max(np.abs(g).max() for _, g in results["ref"]["grads"])
    key_biases = 0
    for (path, want), got in zip(results["ref"]["grads"], results["port"]["grads"]):
        if path.endswith("['bk']"):
            key_biases += 1
            assert np.abs(want).max() <= 1e-6 * gmax and np.abs(got).max() <= 1e-6 * gmax, path
            continue
        P.close(got, want, 1e-4, path)
    assert key_biases == 3          # encoder self, decoder self and cross


def test_prefill_matches_reference(results):
    ref, got = results["ref"], results["port"]
    P.close(got["prefill"], ref["prefill"], 1e-5)
    # k, v, xk, xv in key order
    assert [a.shape for a in got["prefill_caches"]] == [(2, 2, 12, 4, 16)] * 2 + [
        (2, 2, 16, 4, 16)] * 2
    for a, b in zip(got["prefill_caches"], ref["prefill_caches"]):
        P.close(a, b, 1e-5)


def test_decode_steps_match_reference(results):
    ref, got = results["ref"], results["port"]
    for a, b in zip(got["decode"], ref["decode"]):
        P.close(a, b, 1e-5)
    for a, b in zip(got["decode_caches"], ref["decode_caches"]):
        P.close(a, b, 1e-5)


def test_encoder_matches_reference(results):
    jc, tc = results["cfgs"]
    jr, tr = P.runs()
    frames = results["batch"]["frame_embeds"]
    want = jax.jit(lambda q, f: JW.encode(q, f, jc, jr))(results["p"], frames)
    got = W.encode(params_from_numpy(results["p"]), torch.from_numpy(frames), tc, tr)
    P.close(got, want, 1e-5)


def test_bfloat16_loss_matches_reference_loosely(results):
    jc, tc = results["cfgs"]
    jr, tr = P.runs(compute_dtype="bfloat16")
    batch = P.make_batch(tc, seed=1)
    want = jax.jit(lambda q, b: JW.loss(q, b, jc, jr))(results["p"], batch)
    got = W.loss(params_from_numpy(results["p"]), P.tb(batch), tc, tr)
    np.testing.assert_allclose(float(got), float(want), rtol=2e-2)


@pytest.mark.parametrize("remat", ["full", "dots"])
def test_remat_gives_the_same_loss_and_gradients(results, remat):
    _, tc = results["cfgs"]
    _, tr0 = P.runs()
    _, tr1 = P.runs(remat=remat)
    params = W.init(torch.Generator().manual_seed(0), tc, P.WINDOW)
    batch = P.make_batch(tc, seed=2)
    l0, g0 = P.port_loss_and_grads(tc, tr0, params, batch)
    l1, g1 = P.port_loss_and_grads(tc, tr1, params, batch)
    torch.testing.assert_close(l1, l0, rtol=1e-6, atol=0)
    for a, b in zip(g1, g0):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-7)


def test_layout_caches_and_the_arrowhead_grid():
    """init's leaves (``dec_pos`` of max_seq rows) and the caches as the
    reference's; the arrowhead reads the decoder's depth off the first layer
    leaf (``dec_layers``) and the encoder's leaves on the same axis, so its
    plans and grid equal the reference's while the two depths are equal."""
    jc, tc = P.cfgs(BASE)
    jp = jax.jit(lambda k: JW.init(k, jc, 24))(jax.random.PRNGKey(0))
    tp = W.init(torch.Generator().manual_seed(0), tc, 24)
    P.check_layout(jp, tp)
    assert tp["dec_pos"].shape == (24, 64) and tp["enc_pos"].shape == (16, 64)
    P.check_layout(JW.init_cache(jc, 2, 10), W.init_cache(tc, 2, 10, device="cpu"))
    assert isinstance(R.build_module(tc, P.runs()[1], tp), W.Whisper)
    api = R.get_model(tc)
    assert (api.prefill, api.decode_step) == (W.prefill, W.decode_step)
    pre, jpre = build_precond(tp, r=8, band=2, seed=0), jbuild_precond(jp, r=8, band=2, seed=0)
    assert pre.n_layers == jpre.n_layers == tc.encoder_layers == tc.n_layers
    assert {n.split("/")[0] for n, _ in pre.layer_plan} <= {"dec_layers", "enc_layers"}
    for (n, a), (m, b) in zip(pre.layer_plan + pre.arrow_plan, jpre.layer_plan + jpre.arrow_plan):
        assert n == m and np.array_equal(a, b)
    grads = {k: v for k, v in tp.items()}
    lsk, ask = pre.sketch(grads)
    assert lsk.shape == (2, 8) and ask.shape == (8,)
