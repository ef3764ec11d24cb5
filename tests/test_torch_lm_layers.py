"""The port's ``models/layers.py`` against the JAX package's, on the CPU:
the same numpy inputs (from a seed) through each block of both packages,
float32, rtol 1e-5 unless stated.  The flash attention
``autograd.Function``'s gradients are held to ``jax.grad`` of the
reference's custom-VJP ``_flash`` (causal and not, GQA, chunk sizes that do
not divide the sequence, so both packages shrink them) at rtol 1e-5; the
gelu branch is the tanh approximation, ``jax.nn.gelu``'s default."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from repro.models import layers as JL
from repro_torch.models import layers as L
from repro_torch.models.convert import params_from_numpy

RTOL = 1e-5


def _rng(seed=0):
    return np.random.default_rng(seed)


def _close(got, want, rtol=RTOL, atol=None):
    got = got.detach().cpu().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    scale = float(np.abs(want).max()) or 1.0
    np.testing.assert_allclose(got, want, rtol=rtol, atol=(atol if atol is not None
                                                          else rtol * scale))


def _t(x):
    return torch.from_numpy(np.asarray(x))


def test_norms_match_reference():
    r = _rng()
    x = r.standard_normal((2, 5, 24)).astype(np.float32)
    scale = (1 + 0.1 * r.standard_normal(24)).astype(np.float32)
    bias = (0.1 * r.standard_normal(24)).astype(np.float32)
    _close(L.rms_norm(_t(x), _t(scale)), JL.rms_norm(x, scale))
    _close(L.layer_norm(_t(x), _t(scale), _t(bias)), JL.layer_norm(x, scale, bias))
    p = {"scale": scale, "bias": bias}
    for kind in ("rms", "layernorm"):
        _close(L.norm_apply(params_from_numpy(p), _t(x), kind), JL.norm_apply(p, x, kind))
    # bf16 in, bf16 out, computed in float32
    xb = torch.from_numpy(x).to(torch.bfloat16)
    assert L.rms_norm(xb, _t(scale)).dtype == torch.bfloat16


@pytest.mark.parametrize("batched_pos", [False, True])
def test_rope_matches_reference(batched_pos):
    r = _rng(1)
    x = r.standard_normal((2, 7, 3, 16)).astype(np.float32)
    pos = (np.stack([np.arange(7), np.arange(7) + 5]) if batched_pos
           else np.arange(7) + 3).astype(np.int32)
    _close(L.apply_rope(_t(x), _t(pos), 1e6), JL.apply_rope(x, pos, 1e6))


def _qkv(seed, B=2, Sq=12, Skv=12, H=4, KV=2, D=8):
    r = _rng(seed)
    q = r.standard_normal((B, Sq, H, D)).astype(np.float32)
    k = r.standard_normal((B, Skv, KV, D)).astype(np.float32)
    v = r.standard_normal((B, Skv, KV, D)).astype(np.float32)
    return q, k, v


# (causal, q_chunk, kv_chunk): one block; chunks that divide; chunks that
# do not (5 -> 4, 7 -> 6) and a key block wider than a query block
FLASH_CASES = [(True, 512, 1024), (True, 4, 4), (True, 5, 7), (False, 5, 7), (False, 3, 12)]


@pytest.mark.parametrize("causal,qc,kc", FLASH_CASES)
def test_chunked_attention_matches_reference(causal, qc, kc):
    q, k, v = _qkv(2)
    got = L.chunked_attention(_t(q), _t(k), _t(v), causal=causal, q_chunk=qc, kv_chunk=kc)
    want = JL.chunked_attention(q, k, v, causal=causal, q_chunk=qc, kv_chunk=kc)
    _close(got, want)


@pytest.mark.parametrize("causal,qc,kc", FLASH_CASES)
def test_flash_gradients_match_jax_grad(causal, qc, kc):
    """dq, dk, dv of the autograd Function against jax.grad of the
    reference's custom-VJP core, for one random cotangent."""
    q, k, v = _qkv(3)
    do = _rng(4).standard_normal(q.shape).astype(np.float32)
    f = lambda q_, k_, v_: jnp.sum(JL._flash(q_, k_, v_, causal, qc, kc, 0) * do)
    want = jax.grad(f, argnums=(0, 1, 2))(q, k, v)
    tq, tk, tv = (_t(x).requires_grad_() for x in (q, k, v))
    out = L._Flash.apply(tq, tk, tv, causal, qc, kc, 0)
    got = torch.autograd.grad((out * _t(do)).sum(), (tq, tk, tv))
    for g, w in zip(got, want):
        _close(g, w)


def test_flash_backward_keeps_no_score_matrix():
    """The saved residuals are q, k, v, out and the O(S) log-sum-exp."""
    q, k, v = _qkv(5, Sq=16, Skv=16)
    tq = _t(q).requires_grad_()
    out = L._Flash.apply(tq, _t(k), _t(v), True, 4, 4, 0)
    saved = out.grad_fn.saved_tensors
    assert [tuple(s.shape) for s in saved][-1] == (4, 2, 2, 2, 4)    # (nq, B, KV, G, qc)
    assert max(s.numel() for s in saved) == q.size


def test_unroll_waits_for_the_dry_run():
    q, k, v = _qkv(0)
    with pytest.raises(NotImplementedError, match="dryrun"):
        L.chunked_attention(_t(q), _t(k), _t(v), unroll=True)


@pytest.mark.parametrize("cache_len", [5, "per_batch"])
@pytest.mark.parametrize("softcap", [0.0, 30.0])
def test_decode_attention_matches_reference(cache_len, softcap):
    r = _rng(6)
    q = r.standard_normal((2, 1, 4, 8)).astype(np.float32)
    kc = r.standard_normal((2, 9, 2, 8)).astype(np.float32)
    vc = r.standard_normal((2, 9, 2, 8)).astype(np.float32)
    cl = np.array([3, 7], np.int32) if cache_len == "per_batch" else cache_len
    got = L.decode_attention(_t(q), _t(kc), _t(vc), _t(cl) if isinstance(cl, np.ndarray) else cl,
                             softcap)
    _close(got, JL.decode_attention(q, kc, vc, cl, softcap))


def _attn_params(bias, qk_norm, seed=7):
    p = JL.attention_params(jax.random.PRNGKey(seed), 32, 4, 2, 8, bias=bias, qk_norm=qk_norm)
    # non-trivial biases and norm scales
    p = jax.tree.map(lambda x: x + 0.1 * jax.random.normal(jax.random.PRNGKey(seed + 1),
                                                           x.shape), p)
    return jax.tree.map(np.asarray, p)


@pytest.mark.parametrize("bias,qk_norm", [(False, False), (True, False), (False, True)])
def test_attention_block_matches_reference(bias, qk_norm):
    """Training mode, prefill (k/v handed back) and one decode step at
    cache_len 6 (the cache written in place in the port)."""
    p = _attn_params(bias, qk_norm)
    tp = params_from_numpy(p)
    x = _rng(8).standard_normal((2, 6, 32)).astype(np.float32)
    kw = dict(n_heads=4, n_kv=2, head_dim=8, rope_theta=1e4, q_chunk=4, kv_chunk=2)
    got, gc = L.attention_apply(tp, _t(x), cache_len=6, **kw)
    want, wc = JL.attention_apply(p, x, cache_len=6, **kw)
    _close(got, want)
    for a, b in zip(gc, wc):
        _close(a, b)
    kcache = np.zeros((2, 10, 2, 8), np.float32)
    kcache[:, :6], vcache = np.asarray(wc[0]), np.zeros((2, 10, 2, 8), np.float32)
    vcache[:, :6] = np.asarray(wc[1])
    x1 = _rng(9).standard_normal((2, 1, 32)).astype(np.float32)
    tk, tv = _t(kcache.copy()), _t(vcache.copy())
    got, (nk, nv) = L.attention_apply(tp, _t(x1), cache=(tk, tv), cache_len=6, **kw)
    want, (wk, wv) = JL.attention_apply(p, x1, cache=(kcache, vcache), cache_len=6, **kw)
    _close(got, want)
    _close(tk, wk)
    _close(tv, wv)


@pytest.mark.parametrize("act,bias", [("silu", False), ("gelu", True), ("gelu", False)])
def test_mlp_matches_reference(act, bias):
    p = JL.mlp_params(jax.random.PRNGKey(3), 16, 40, act=act, bias=bias)
    p = jax.tree.map(lambda x: np.asarray(x + 0.05), p)
    x = _rng(10).standard_normal((2, 5, 16)).astype(np.float32)
    _close(L.mlp_apply(params_from_numpy(p), _t(x), act), JL.mlp_apply(p, x, act))


def test_gelu_is_the_tanh_approximation():
    x = np.linspace(-4, 4, 101).astype(np.float32)
    _close(torch.nn.functional.gelu(_t(x), approximate="tanh"), jax.nn.gelu(x))
    assert np.abs(np.asarray(jax.nn.gelu(x))
                  - torch.nn.functional.gelu(_t(x)).numpy()).max() > 1e-5


@pytest.mark.parametrize("softcap,transpose_w,chunk", [(0.0, False, 4), (30.0, True, 3),
                                                       (0.0, True, 16)])
def test_chunked_cross_entropy_and_gradient_match_reference(softcap, transpose_w, chunk):
    r = _rng(11)
    h = r.standard_normal((2, 12, 16)).astype(np.float32)
    w = (r.standard_normal((40, 16) if transpose_w else (16, 40)) * 0.3).astype(np.float32)
    labels = r.integers(-1, 40, (2, 12)).astype(np.int32)
    f = lambda h_, w_: JL.chunked_cross_entropy(h_, w_, labels, softcap, chunk, transpose_w)
    want, (wh, ww) = jax.value_and_grad(f, argnums=(0, 1))(h, w)
    th, tw = _t(h).requires_grad_(), _t(w).requires_grad_()
    got = L.chunked_cross_entropy(th, tw, _t(labels), softcap, chunk, transpose_w)
    gh, gw = torch.autograd.grad(got, (th, tw))
    _close(got, want)
    _close(gh, wh, rtol=1e-4)
    _close(gw, ww, rtol=1e-4)


@pytest.mark.parametrize("remat", ["full", "dots"])
def test_layer_loop_remat_gives_the_same_loss_and_gradient(remat):
    """``remat`` changes what is kept for the backward pass, not the
    result: the same loss and gradient as ``"none"``."""
    r = _rng(12)
    ws = torch.from_numpy(r.standard_normal((3, 8, 8)).astype(np.float32) * 0.3)

    def run(mode):
        w = ws.clone().requires_grad_()
        x = torch.ones(2, 8)
        body = lambda h, lw: (torch.tanh(torch.matmul(h, lw["w"])), None)
        h, ys = L.scan_or_unroll(body, x, {"w": w}, remat=mode)
        assert ys is None
        loss = (h ** 2).sum()
        return loss.detach(), torch.autograd.grad(loss, w)[0]

    l0, g0 = run("none")
    l1, g1 = run(remat)
    assert torch.equal(l0, l1)
    torch.testing.assert_close(g1, g0, rtol=1e-6, atol=1e-7)
    with pytest.raises(ValueError):
        L.scan_or_unroll(lambda h, x: (h, None), torch.ones(1), {"w": ws}, remat="some")


def test_initialisers_follow_the_reference_distributions():
    g = torch.Generator().manual_seed(0)
    w = L.dense_init(g, 400, 300)
    e = L.embed_init(g, 500, 64)
    assert w.shape == (400, 300) and w.dtype == torch.float32
    assert abs(float(w.std()) - 1 / 20) < 1e-3 and abs(float(w.mean())) < 1e-3
    assert abs(float(e.std()) - 0.02) < 1e-3
    p = L.attention_params(torch.Generator().manual_seed(1), 32, 4, 2, 8, bias=True,
                           qk_norm=True)
    jp = JL.attention_params(jax.random.PRNGKey(0), 32, 4, 2, 8, bias=True, qk_norm=True)
    assert {k: tuple(v.shape) for k, v in p.items()} == {k: v.shape for k, v in jp.items()}
