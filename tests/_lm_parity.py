"""Shared steps of the LM families' parity tests (``test_torch_moe.py``,
``test_torch_mamba2.py``, ``test_torch_zamba2.py``,
``test_torch_whisper.py``): one model's reference results computed once
(jitted) and the port's on the same parameters and numpy batch.

The reference's parameters come from its own ``init``, every leaf
perturbed so biases, norm scales and SSM constants are not trivial, and
cross to the port through ``params_from_numpy``.  Both packages then run
at ``compute_dtype="float32"``: the loss and every gradient on a batch of
2 × 16; the prefill of its first 12 tokens (last logits and every cache
leaf); the caches' ``k``/``v`` padded to a window of 20 positions; three
greedy decode steps on the reference's tokens (logits, then every cache
leaf)."""
import numpy as np
import torch

import jax
import jax.numpy as jnp
from repro.configs.base import ModelConfig as JModelConfig, RunConfig as JRunConfig
from repro.models import registry as JR
from repro_torch import pytree
from repro_torch.configs.base import ModelConfig, RunConfig
from repro_torch.models import registry as R
from repro_torch.models.convert import params_from_numpy

RUN = dict(compute_dtype="float32", remat="none", q_chunk=8, kv_chunk=4, loss_chunk=8,
           ssd_chunk=8)
B, S, PROMPT, WINDOW, STEPS = 2, 16, 12, 20, 3


def cfgs(base, **over):
    kw = {**base, **over}
    return JModelConfig(**kw), ModelConfig(**kw)


def runs(**over):
    kw = {**RUN, **over}
    return JRunConfig(**kw), RunConfig(**kw)


def ref_params(jc, seed=0):
    """The reference's init (``dec_pos`` of WINDOW rows for whisper), every
    leaf perturbed, as numpy arrays."""
    @jax.jit
    def make(key):
        p = JR.get_model(jc).init(key, jc, WINDOW)
        leaves, tree = jax.tree.flatten(p)
        keys = jax.random.split(jax.random.fold_in(key, 1), len(leaves))
        return jax.tree.unflatten(tree, [x + 0.05 * jax.random.normal(k, x.shape)
                                         for x, k in zip(leaves, keys)])
    return jax.tree.map(np.asarray, make(jax.random.PRNGKey(seed)))


def make_batch(cfg, seed=0, b=B, s=S):
    r = np.random.default_rng(seed)
    batch = {"tokens": r.integers(0, cfg.vocab, (b, s)).astype(np.int32),
             "labels": r.integers(-1, cfg.vocab, (b, s)).astype(np.int32)}
    if cfg.family == "encdec":
        batch["frame_embeds"] = r.standard_normal((b, cfg.encoder_seq, cfg.d_model)).astype(
            np.float32)
    return batch


def _prompt(batch):
    return {k: (v[:, :PROMPT] if k == "tokens" else v) for k, v in batch.items()
            if k != "labels"}


def pad_kv(caches, pad):
    """Grow the top-level attention caches ``k``/``v`` (5-D) along their
    sequence axis, as both servers' ``_pad_caches`` do."""
    return {k: (pad(v) if k in ("k", "v") and v.ndim == 5 else v) for k, v in caches.items()}


def reference(jc, jr, p, batch):
    """The reference's loss, gradients (with their paths), prefill and
    decode steps, all under ``jax.jit``."""
    api = JR.get_model(jc)
    loss, grads = jax.jit(jax.value_and_grad(lambda q, b: api.loss(q, b, jc, jr)))(p, batch)
    logits, caches = jax.jit(lambda q, b: api.prefill(q, b, jc, jr))(p, _prompt(batch))
    out = {"loss": float(loss),
           "grads": [(jax.tree_util.keystr(k), np.asarray(g))
                     for k, g in jax.tree_util.tree_leaves_with_path(grads)],
           "prefill": np.asarray(logits),
           "prefill_caches": [np.asarray(x) for x in jax.tree.leaves(caches)]}
    w = WINDOW - PROMPT
    caches = pad_kv(caches, lambda x: jnp.pad(x, [(0, 0), (0, 0), (0, w), (0, 0), (0, 0)]))
    step = jax.jit(lambda q, c, t, pos: api.decode_step(q, c, t, pos, jc, jr))
    tokens, logs = [], []
    tok = np.argmax(out["prefill"], -1)[:, None].astype(np.int32)
    for i in range(STEPS):
        tokens.append(tok)
        logits, caches = step(p, caches, tok, jnp.int32(PROMPT + i))
        logs.append(np.asarray(logits))
        tok = np.argmax(logs[-1], -1)[:, None].astype(np.int32)
    out.update(tokens=tokens, decode=logs,
               decode_caches=[np.asarray(x) for x in jax.tree.leaves(caches)])
    return out


def tb(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def port_loss_and_grads(tc, tr, params, batch):
    api = R.get_model(tc)
    leaves = [x.detach().clone().requires_grad_() for x in pytree.leaves(params)]
    loss = api.loss(pytree.unflatten(params, leaves), tb(batch), tc, tr)
    return loss.detach(), torch.autograd.grad(loss, leaves)


def port(tc, tr, p, batch, tokens):
    """The port's results on the reference's parameters ``p``, decoding
    the reference's ``tokens``."""
    api = R.get_model(tc)
    params = params_from_numpy(p)
    loss, grads = port_loss_and_grads(tc, tr, params, batch)
    with torch.no_grad():
        logits, caches = api.prefill(params, tb(_prompt(batch)), tc, tr)
        out = {"loss": float(loss), "grads": [g.numpy() for g in grads],
               "prefill": logits.numpy(),
               "prefill_caches": [x.clone().numpy() for x in pytree.leaves(caches)]}
        w = WINDOW - PROMPT
        caches = pad_kv(caches, lambda x: torch.nn.functional.pad(x, (0, 0, 0, 0, 0, w)))
        logs = []
        for i, tok in enumerate(tokens):
            logits, caches = api.decode_step(params, caches, torch.from_numpy(tok), PROMPT + i,
                                             tc, tr)
            logs.append(logits.numpy())
    out.update(decode=logs, decode_caches=[x.numpy() for x in pytree.leaves(caches)])
    return out


def close(got, want, rtol, what=""):
    """``got`` against ``want`` at ``rtol``, relative to want's largest
    entry."""
    got = got.detach().cpu().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rtol * (float(np.abs(want).max()) or 1.0), err_msg=what)


def leaf_paths(tree):
    return ["/".join(str(k.key) for k in path)
            for path, _ in jax.tree_util.tree_leaves_with_path(tree)]


def check_layout(jtree, ttree):
    """The port's tree has the reference's leaf paths, in its order, with
    the same shapes and dtypes."""
    assert [p for p, _ in pytree.leaves_with_path(ttree)] == leaf_paths(jtree)
    assert [(tuple(x.shape), str(x.dtype).replace("torch.", "")) for x in pytree.leaves(ttree)] \
        == [(tuple(x.shape), str(x.dtype)) for x in jax.tree.leaves(jtree)]
