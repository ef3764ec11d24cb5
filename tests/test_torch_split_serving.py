"""Prefill and decode under the split (``prefill(constrain=)``,
``launch/serve.py::grow_caches``, ``decode_step(constrain=)``) on a gloo
world of 4 ranks (one ``run_local`` spawn for the file) against the JAX
package's jitted ``prefill`` and ``decode_step`` under the rules'
``param_shardings`` and ``cache_shardings`` with ``constrain=
rules.constrain``, the caches grown by its server's ``_pad_caches`` and
donated, on 4 forced XLA CPU devices (one ``tests/_mdev.py`` subprocess),
from the same numpy initialisation (the port's ``init`` from a CPU
generator of seed 0, carried to the reference as arrays).  Float32 at the
reduced widths of
``tests/test_torch_tensor_parallel.py``: a prompt of 16 tokens (4 a
sequence; whisper's frame embeddings from ``default_rng(0)``), a serving
window of 32, 3 greedy decode steps at positions 16–18, in a cache block
past the prompt's last (blocks of 8 on ``model`` 4, of 16 on ``model`` 2).

For each case and rank: the prefill's and every step's logits within
1e-5 of the reference's max|logit| (this rank's batch block, the logits
whole over ``model``), the same greedy tokens, and each cache block after
the last step equal, within 1e-5 of the leaf's max, to the reference's
shard at that device position; during the decode steps no rank makes a
tensor of a sharded cache's whole shape (the whole leaf, or one layer of
it, with any of the batch's cuts); with ``ssm_head_shard`` the prefill
makes no tensor of the SSD mixer's whole heads, and with the flag off
(every head on this rank's sequence block) no operation of a Mamba2
layer's prefill makes a tensor over the whole sequence.  The cases:

* ``seqsplit``: the dense model whose 6 query and 2 key/value heads do not
  divide ``model`` of 4 (the sequence-split prefill; decode's q/k/v
  columns do divide) at (data 1, model 4);
* ``heads``: the same heads at (data 2, model 2), where they divide (the
  head split's caches moved to sequence blocks by one all-to-all);
* ``moe_ep``: reduced granite-moe, 8 experts on ``model`` (EP), (2, 2);
* ``mamba2`` with ``ssm_head_shard`` off at (2, 2) and on at (1, 4);
* ``zamba2`` with the flag off and on at (2, 2);
* ``whisper`` at (2, 2) with 63 encoder frames, a cross cache ``model``
  does not divide (kept whole on every rank) beside a self-attention cache
  it does;
* ``vlm``: reduced phi-3-vision at (1, 4), the prompt's first 8 positions
  its image embeddings (``default_rng(0)``), across the blocks of ranks 0
  and 1; ``tied``: reduced command-r-plus at (2, 2), one embedding leaf
  for the lookup and the transposed logits.
"""
import os
import tempfile

import numpy as np
import pytest
import torch

import _torch_ranks
from _mdev import run_multidevice
from repro_torch import pytree
from repro_torch.launch.mesh import run_local
from repro_torch.models.convert import params_from_numpy
from repro_torch.models.registry import get_model

DENSE = dict(n_heads=6, n_kv_heads=2, head_dim=8)
# name -> (arch, config update, mesh shape, run fields)
CASES = {
    "seqsplit": ("qwen2-7b", DENSE, (1, 4), {}),
    "heads": ("qwen2-7b", dict(DENSE, d_ff=128), (2, 2), {}),
    "moe_ep": ("granite-moe-1b-a400m", {}, (2, 2), {}),
    "mamba2": ("mamba2-1.3b", {}, (2, 2), {}),
    "mamba2_heads": ("mamba2-1.3b", {}, (1, 4), dict(ssm_head_shard=True)),
    "zamba2": ("zamba2-2.7b", {}, (2, 2), {}),
    "zamba2_heads": ("zamba2-2.7b", {}, (2, 2), dict(ssm_head_shard=True)),
    "whisper": ("whisper-medium", dict(encoder_seq=63), (2, 2), {}),
    "vlm": ("phi-3-vision-4.2b", {}, (1, 4), {}),
    "tied": ("command-r-plus-104b", {}, (2, 2), {}),
}
SSM = ("mamba2", "mamba2_heads", "zamba2", "zamba2_heads")
BATCH, PROMPT, WINDOW, STEPS = 4, 16, 32, 3
TOL = 1e-5

_REFERENCE = """
import dataclasses, numpy as np, jax, jax.numpy as jnp
from jax.sharding import Mesh
from repro import configs
from repro.checkpoint.checkpointer import _flatten
from repro.configs.base import RunConfig
from repro.launch import train as T
from repro.launch.serve import _pad_caches
from repro.models.registry import get_model
from repro.sharding.partition import make_rules
def nest(flat):
    out = {}
    for path, leaf in flat.items():
        *head, last = path.split("/")
        node = out
        for k in head:
            node = node.setdefault(k, {})
        node[last] = leaf
    return out
inputs = dict(np.load(INPUTS_NPZ))
out = {}
for name, (arch, upd, shape, rupd) in CASES.items():
    cfg = dataclasses.replace(T.reduce_config(configs.get(arch), layers=2, d_model=64,
                                              vocab=256), **upd)
    run = RunConfig(**dict(dict(compute_dtype="float32", remat="none"), **rupd))
    mesh = Mesh(np.array(jax.devices()).reshape(*shape), ("data", "model"))
    rules = make_rules(mesh, cfg, run)
    api = get_model(cfg)
    params = nest({k[len(name) + 6:]: jnp.asarray(v) for k, v in inputs.items()
                   if k.startswith(f"{name}/init/")})
    batch = {k[len(name) + 7:]: v for k, v in inputs.items() if k.startswith(f"{name}/batch/")}
    psh = rules.param_shardings(params)
    tok_sh = rules.batch_specs(jax.ShapeDtypeStruct((BATCH, 1), jnp.int32))
    log_sh = rules.batch_specs(jax.ShapeDtypeStruct((BATCH, cfg.vocab_padded), jnp.float32))
    with mesh:
        pre = jax.jit(lambda p, b: api.prefill(p, b, cfg, run, constrain=rules.constrain),
                      in_shardings=(psh, rules.batch_specs(batch)))
        logits, caches = pre(params, batch)
        caches = _pad_caches(caches, WINDOW)
        csh = rules.cache_shardings(caches)
        caches = jax.device_put(caches, csh)
        dec = jax.jit(lambda p, c, t, pos: api.decode_step(p, c, t, pos, cfg, run,
                                                           constrain=rules.constrain),
                      in_shardings=(psh, csh, tok_sh, rules.replicated()),
                      out_shardings=(log_sh, csh), donate_argnums=(1,))
        tok = jax.device_put(jnp.argmax(logits, -1)[:, None].astype(jnp.int32), tok_sh)
        out[f"{name}/logits/0"] = np.asarray(logits)
        toks = [np.asarray(tok)]
        for i in range(STEPS):
            logits, caches = dec(params, caches, tok, jnp.int32(PROMPT + i))
            tok = jax.device_put(jnp.argmax(logits, -1)[:, None].astype(jnp.int32), tok_sh)
            out[f"{name}/logits/{i + 1}"] = np.asarray(logits)
            toks.append(np.asarray(tok))
    out[f"{name}/tokens"] = np.concatenate(toks, axis=1)
    for k, leaf in _flatten(caches).items():
        for i, d in enumerate(mesh.devices.flat):
            shard = [x for x in leaf.addressable_shards if x.device == d][0]
            out[f"{name}/{i}/{k}"] = np.asarray(shard.data)
np.savez(OUTPUT_NPZ, **out)
print("OK")
"""


def _nest(flat):
    out = {}
    for path, leaf in flat.items():
        *head, last = path.split("/")
        node = out
        for k in head:
            node = node.setdefault(k, {})
        node[last] = leaf
    return out


def _sub(ref, pre):
    return {k[len(pre):]: v for k, v in ref.items() if k.startswith(pre)}


def _inputs():
    """Each case's parameters (the port's ``init`` from a seeded CPU
    generator) and batch (``default_rng(0)``), as numpy arrays by path."""
    out = {}
    for name, (arch, upd, _, _) in CASES.items():
        cfg = _torch_ranks.tp_case_config(arch, upd)
        params = get_model(cfg).init(torch.Generator().manual_seed(0), cfg, WINDOW)
        for k, v in pytree.leaves_with_path(params):
            out[f"{name}/init/{k}"] = v.numpy()
        rng = np.random.default_rng(0)
        out[f"{name}/batch/tokens"] = rng.integers(0, cfg.vocab, (BATCH, PROMPT)).astype(np.int32)
        if cfg.family == "encdec":
            out[f"{name}/batch/frame_embeds"] = rng.standard_normal(
                (BATCH, cfg.encoder_seq, cfg.d_model)).astype(np.float32)
        if cfg.family == "vlm":
            out[f"{name}/batch/image_embeds"] = rng.standard_normal(
                (BATCH, cfg.n_image_tokens, cfg.d_model)).astype(np.float32)
    return out


@pytest.fixture(scope="module")
def runs():
    inputs = _inputs()
    with tempfile.TemporaryDirectory(prefix="repro_torch_serving_") as tmp:
        src, path = os.path.join(tmp, "in.npz"), os.path.join(tmp, "ref.npz")
        np.savez(src, **inputs)
        code = _REFERENCE
        for k, v in (("CASES", CASES), ("BATCH", BATCH), ("PROMPT", PROMPT),
                     ("WINDOW", WINDOW), ("STEPS", STEPS), ("OUTPUT_NPZ", path), ("INPUTS_NPZ", src)):
            code = code.replace(k, repr(v))
        run_multidevice(code, n_devices=4)
        with np.load(path) as f:
            ref = dict(f)
    inits = {name: params_from_numpy(_nest(_sub(inputs, f"{name}/init/"))) for name in CASES}
    batches = {name: {k: torch.from_numpy(v) for k, v in _sub(inputs, f"{name}/batch/").items()}
               for name in CASES}
    port = run_local(_torch_ranks.split_serving, CASES, inits, batches, WINDOW, STEPS,
                     world_size=4)
    return {"ref": ref, "port": port}


def _close(got, want, what):
    got = got.detach().cpu().numpy().astype(np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = np.abs(got - want).max() / (np.abs(want).max() or 1.0)
    assert err <= TOL, (what, err)


@pytest.mark.parametrize("name", list(CASES))
def test_logits_and_greedy_tokens_match_the_reference(runs, name):
    ref = runs["ref"]
    for rank, out in enumerate(runs["port"]):
        r = out[name]
        n = r["tokens"].shape[0]
        rows = slice(r["data_rank"] * n, (r["data_rank"] + 1) * n)
        for i, logits in enumerate(r["logits"]):
            _close(logits, ref[f"{name}/logits/{i}"][rows], (name, rank, i))
        assert np.array_equal(r["tokens"].numpy(), ref[f"{name}/tokens"][rows]), (name, rank)


@pytest.mark.parametrize("name", list(CASES))
def test_each_rank_cache_block_equals_the_reference_shard(runs, name):
    ref = runs["ref"]
    for rank, out in enumerate(runs["port"]):
        r = out[name]
        assert set(r["caches"]) == {k[len(f"{name}/{rank}/"):] for k in ref
                                    if k.startswith(f"{name}/{rank}/")}
        for path, block in r["caches"].items():
            _close(block, ref[f"{name}/{rank}/{path}"], (name, rank, path))


def _forbidden(ref, name, shape):
    """The whole shapes of every cache leaf the reference cuts over
    ``model``, and of one layer of it, with the batch whole or cut over
    ``data``: the reference's shards at ``model`` ranks 0 and 1 of the
    first ``data`` row differ in content only, so a leaf is cut over
    ``model`` where its shard is smaller than the whole the port's
    ``init_cache`` shape gives."""
    from repro_torch.models.registry import get_model
    cfg = _torch_ranks.tp_case_config(*CASES[name][:2])
    full = get_model(cfg).init_cache(cfg, BATCH, WINDOW, device="meta")
    dp, tp = shape
    out = set()
    for path, leaf in _paths(full):
        block = ref[f"{name}/0/{path}"].shape
        dims = [d for d, (a, b) in enumerate(zip(leaf.shape, block)) if a != b and d != 1]
        if not dims:
            continue
        for b in {leaf.shape[1], leaf.shape[1] // dp}:
            whole = (leaf.shape[0], b) + tuple(leaf.shape[2:])
            out |= {whole, whole[1:]}
    return out


def _paths(tree, pre=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _paths(v, f"{pre}{k}/")
        else:
            yield f"{pre}{k}", v


@pytest.mark.parametrize("name", list(CASES))
def test_decode_makes_no_whole_sharded_cache(runs, name):
    forbidden = _forbidden(runs["ref"], name, CASES[name][2])
    assert forbidden, name                    # every case cuts some cache over model
    for out in runs["port"]:
        made = set(out[name]["decode_shapes"])
        assert not forbidden & made, (name, forbidden & made)


def _ssd_whole(name):
    """The shapes of the SSD mixer's whole heads in a prefill of the case
    (one chunk of the 16 positions): its intra-chunk decay ``(B, 1, S, S,
    G, HG)`` and its final state ``(B, G, HG, P, N)``, the batch as one
    rank holds it."""
    cfg = _torch_ranks.tp_case_config(*CASES[name][:2])
    b = BATCH // CASES[name][2][0]
    g, hg = cfg.ssm_groups, cfg.ssm_heads // cfg.ssm_groups
    return {(b, 1, PROMPT, PROMPT, g, hg), (b, g, hg, cfg.ssm_head_dim, cfg.ssm_state)}


@pytest.mark.parametrize("name", SSM)
def test_head_parallel_ssd_computes_only_its_heads(runs, name):
    whole = _ssd_whole(name)
    for out in runs["port"]:
        made = whole & set(out[name]["prefill_shapes"])
        if CASES[name][3].get("ssm_head_shard"):
            assert not made, (name, made)
        else:
            # every head on this rank's sequence block: the heads' whole
            # state, never the whole sequence's decay
            b, s = BATCH // CASES[name][2][0], PROMPT
            assert made == {x for x in whole if x[2:4] != (s, s)}, (name, made)


@pytest.mark.parametrize("name", [n for n in SSM if not CASES[n][3].get("ssm_head_shard")])
def test_sequence_split_ssd_never_makes_the_whole_sequence(runs, name):
    cfg = _torch_ranks.tp_case_config(*CASES[name][:2])
    whole = _torch_ranks.ssd_whole_sequence(cfg, BATCH // CASES[name][2][0], PROMPT)
    for out in runs["port"]:
        shapes = set(out[name]["layer_shapes"])
        assert shapes, name
        assert not whole & shapes, (name, whole & shapes)
