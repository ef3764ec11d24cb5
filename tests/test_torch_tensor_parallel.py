"""The split train step (``sharding/split.py`` through
``launch/train.py::make_train_step(rules=)``) on a gloo world of 4 ranks
(one ``run_local`` spawn for the file) against the JAX package's
``shard_train_step`` on 4 forced XLA CPU devices (one ``tests/_mdev.py``
subprocess), one step of each case from the reference's initialisation on
the same Markov batch (4 × 16; whisper's frame embeddings from
``default_rng(0)``), float32: each rank's block of every state leaf equals
the reference's shard of the same device position within 1e-5 of the
leaf's max (after one step the parameters are the initial ones, the
learning rate of step 0 being 0, and AdamW's moments are the clipped
gradient: ``m = 0.1·g``, ``v = 0.05·g²``, so ``v`` is held as ``√v``, whose
relative error is g's; moments the reference has below
1e-9, a gradient zero in exact arithmetic, below 1e-9 in the port too),
the loss and the gradient norm within 1e-5.  The cases:

* (a) ``seqsplit``: a dense model whose 6 query and 2 key/value heads of
  width 8 do not divide ``model`` of 4 while their columns do, at (data 1,
  model 4), remat "full": the sequence-split attention (and, d_ff 338 not
  dividing 4, the MLP on each rank's sequence block);
* (b) ``moe_ep`` and ``moe_ff``: reduced granite-moe at (data 2, model 2),
  8 experts on ``model`` (EP) and 3, which ``model`` does not divide (each
  expert's d_ff on ``model``);
* (c) ``whisper``, ``zamba2`` and ``mamba2`` at (data 2, model 2): the two
  streams of the encoder-decoder, the shared block, and the SSD mixer on
  each rank's sequence block (mamba2 under remat "full"), ``mamba2_m4``
  the same at (data 1, model 4); ``mamba2_heads``, mamba2 at (2, 2) under
  ``ssm_head_shard``: the SSD mixer split by heads over ``model``.  With
  the flag off no operation of a Mamba2 layer's forward (the remat's
  recompute included) makes a tensor over the whole sequence;
* (g) ``vlm``: reduced phi-3-vision at (data 1, model 4), its 8 image
  embeddings (``default_rng(0)``, in both packages' batches) over the
  first 8 of 16 positions, which cross the sequence blocks of ``model``
  ranks 0 and 1; ``tied``: reduced command-r-plus at (2, 2), whose one
  embedding leaf serves the vocabulary-parallel lookup and the transposed
  loss, its gradient the sum of both uses; both again with every
  piecewise gather, reduce-scatter, lookup and flash block one batch row a
  piece (``collectives.PIECE_BYTES`` at 64), bit for bit the step that
  takes each whole;
* (h) ``softcap``: the dense model at (data 2, model 2) with
  ``logit_softcap`` 1.0 (a cap the reduced model's logits reach): the
  vocabulary-parallel loss through the cap's ``tanh`` and its gradient.

Then, against the one-process step of the port (no reference run):
``replicated``, the dense model at (data 2, model 2) with
``activation_sharding="replicated"`` (plain TP, the heads dividing); (d)
the reduced qwen2-7b of ``test_torch_sharded_train.py`` at (data 2, model
2) under remat "full" with a dispatch mode recording every operation's
output: no rank ever makes a tensor of a sharded leaf's whole shape (nor of
one layer's whole shape of a leaf cut over ``model``), and the largest
parameter-shaped one is one layer's block gathered over ``data``; (e) at
(data 1, model 4) a rank's FLOPs (``FlopCounterMode``) at most 0.3 of the
one-process step's; (f) ``reduce_scatter`` along dimensions 0 and 1
equal, bit for bit, to ``ordered_allreduce``'s slice, which is the same on
every rank; and ``Rules.constrain`` cutting a whole activation to this
rank's sequence block ("act" under SP), a kind without a rule left
whole."""
import math
import os
import tempfile

import numpy as np
import pytest
import torch

import _torch_ranks
from _mdev import run_multidevice
from repro_torch import pytree
from repro_torch.configs.base import RunConfig
from repro_torch.data import MarkovStream
from repro_torch.launch.mesh import fake_world, make_local_mesh, run_local
from repro_torch.models.convert import params_from_numpy
from repro_torch.models.registry import get_model
from repro_torch.sharding.partition import make_rules

DENSE = dict(n_heads=6, n_kv_heads=2, head_dim=8)
# name -> (arch, config update, mesh shape, run fields); the reference runs
# REFERENCE's, the port all
REFERENCE = {
    "seqsplit": ("qwen2-7b", DENSE, (1, 4), dict(remat="full")),
    "moe_ep": ("granite-moe-1b-a400m", {}, (2, 2), {}),
    "moe_ff": ("granite-moe-1b-a400m", dict(n_experts=3), (2, 2), {}),
    "whisper": ("whisper-medium", {}, (2, 2), {}),
    "zamba2": ("zamba2-2.7b", {}, (2, 2), {}),
    "mamba2": ("mamba2-1.3b", {}, (2, 2), dict(remat="full")),
    "mamba2_m4": ("mamba2-1.3b", {}, (1, 4), dict(remat="full")),
    "mamba2_heads": ("mamba2-1.3b", {}, (2, 2), dict(remat="full", ssm_head_shard=True)),
    "vlm": ("phi-3-vision-4.2b", {}, (1, 4), {}),
    "tied": ("command-r-plus-104b", {}, (2, 2), {}),
    "softcap": ("qwen2-7b", dict(logit_softcap=1.0), (2, 2), {}),
}
PORT_ONLY = {
    "replicated": ("qwen2-7b", dict(DENSE, d_ff=128), (2, 2),
                   dict(activation_sharding="replicated")),
    "meter": ("qwen2-7b", {}, (2, 2), dict(remat="full")),
}
# the cases run again with every piecewise collective, lookup and flash
# block one batch row a piece
PIECES = ("tied", "vlm")
TOL = 1e-5
# the moments of a gradient that is zero in exact arithmetic (m = 0.1·g,
# g rounding noise of some 1e-11 here)
NOISE = 1e-9

_REFERENCE = """
import dataclasses, numpy as np, jax
from jax.sharding import Mesh
from repro import configs
from repro.checkpoint.checkpointer import _flatten
from repro.configs.base import RunConfig
from repro.data.synthetic import MarkovStream
from repro.launch import train as T
from repro.sharding.partition import make_rules
out = {}
for name, (arch, upd, shape, rupd) in CASES.items():
    cfg = dataclasses.replace(T.reduce_config(configs.get(arch), layers=2, d_model=64,
                                              vocab=256), **upd)
    run = RunConfig(**dict(dict(compute_dtype="float32", remat="none", loss_chunk=16), **rupd))
    mesh = Mesh(np.array(jax.devices()).reshape(*shape), ("data", "model"))
    rules = make_rules(mesh, cfg, run)
    state = T.init_state(jax.random.PRNGKey(0), cfg, run, 16)
    for k, v in _flatten(state.params).items():
        out[f"{name}/init/{k}"] = np.asarray(v)
    batch = MarkovStream(cfg.vocab, seed=0).batch(0, 4, 16)
    if cfg.family == "encdec":
        batch["frame_embeds"] = np.random.default_rng(0).standard_normal(
            (4, cfg.encoder_seq, cfg.d_model)).astype(np.float32)
    if cfg.family == "vlm":
        batch["image_embeds"] = np.random.default_rng(0).standard_normal(
            (4, cfg.n_image_tokens, cfg.d_model)).astype(np.float32)
    fn, _ = T.shard_train_step(T.make_train_step(cfg, run, rules, None, total_steps=10),
                               mesh, rules, state, batch)
    with mesh:
        state, m = fn(state, batch)
    out[f"{name}/loss"] = np.asarray(m["loss"])
    out[f"{name}/grad_norm"] = np.asarray(m["grad_norm"])
    for k, leaf in _flatten(state).items():
        for i, d in enumerate(mesh.devices.flat):
            shard = [x for x in leaf.addressable_shards if x.device == d][0]
            out[f"{name}/{i}/{k}"] = np.asarray(shard.data)
np.savez(OUT, **out)
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


def _batch(cfg):
    b = MarkovStream(cfg.vocab, seed=0).batch(0, 4, 16)
    if cfg.family == "encdec":
        b["frame_embeds"] = np.random.default_rng(0).standard_normal(
            (4, cfg.encoder_seq, cfg.d_model)).astype(np.float32)
    if cfg.family == "vlm":
        b["image_embeds"] = np.random.default_rng(0).standard_normal(
            (4, cfg.n_image_tokens, cfg.d_model)).astype(np.float32)
    return b


RS_DATA = torch.from_numpy(np.random.default_rng(3).standard_normal((4, 8, 12))
                           .astype(np.float32))


@pytest.fixture(scope="module")
def runs():
    with tempfile.TemporaryDirectory(prefix="repro_torch_tp_") as tmp:
        path = os.path.join(tmp, "ref.npz")
        run_multidevice(_REFERENCE.replace("CASES", repr(REFERENCE)).replace("OUT", repr(path)),
                        n_devices=4)
        with np.load(path) as f:
            ref = dict(f)
    cases = dict(REFERENCE, **PORT_ONLY)
    inits, batches = {}, {}
    for name, (arch, upd, _, _) in cases.items():
        cfg = _torch_ranks.tp_case_config(arch, upd)
        batches[name] = _batch(cfg)
        if name in REFERENCE:
            pre = f"{name}/init/"
            inits[name] = params_from_numpy(_nest({k[len(pre):]: v for k, v in ref.items()
                                                   if k.startswith(pre)}))
        else:
            inits[name] = get_model(cfg).init(torch.Generator().manual_seed(0), cfg, 16)
    port = run_local(_torch_ranks.tp_cases, cases, inits, batches,
                     ("replicated", "meter", "seqsplit"), "meter", "seqsplit", RS_DATA,
                     PIECES, world_size=4)
    return {"ref": ref, "port": port, "inits": inits, "cases": cases}


def _close(got, want, rtol, what):
    got = got.detach().cpu().numpy().astype(np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, what
    scale = np.abs(want).max() or 1.0
    err = np.abs(got - want).max() / scale
    assert err <= rtol, (what, err)


@pytest.mark.parametrize("name", list(REFERENCE))
def test_each_rank_block_equals_the_reference_shard(runs, name):
    ref, port = runs["ref"], runs["port"]
    for rank, out in enumerate(port):
        r = out[name]
        for path, block in r["blocks"].items():
            want = ref[f"{name}/{rank}/{path}"]
            if np.abs(want).max() <= NOISE and not path.startswith("0/"):
                # a gradient zero in exact arithmetic (the key bias where
                # no rotary follows it: softmax ignores it): its moments
                # are rounding noise in both packages
                assert float(block.abs().max()) <= NOISE, (name, rank, path)
                continue
            if path.startswith("1/1/"):
                # v = 0.05·g² doubles g's relative error: held as √v, |g|
                block, want = torch.sqrt(block), np.sqrt(want)
            _close(block, want, TOL, (name, rank, path))
        _close(r["metrics"]["loss"], ref[f"{name}/loss"], TOL, "loss")
        _close(r["metrics"]["grad_norm"], ref[f"{name}/grad_norm"], TOL, "grad_norm")


@pytest.mark.parametrize("name", PIECES)
def test_pieces_give_the_same_bits(runs, name):
    """A step whose gathers, reduce-scatters, vocabulary lookup and flash
    blocks go a batch row at a time equals, bit for bit, the step that
    takes each whole (the pieces' bound only limits what a rank holds)."""
    for out in runs["port"]:
        r = out[name]
        blocks, metrics = r["pieces"]
        assert set(blocks) == set(r["blocks"])
        for path, block in blocks.items():
            assert torch.equal(block, r["blocks"][path]), (name, path)
        for k, v in metrics.items():
            assert torch.equal(v, r["metrics"][k]), (name, k)


def _slice(full, placements, coords, mesh):
    for md, p in enumerate(placements):
        if p.startswith("S("):
            d = int(p[2:-1])
            n = full.shape[d] // mesh[md]
            full = full.narrow(d, coords[md] * n, n)
    return full


@pytest.mark.parametrize("name", ["replicated", "meter", "seqsplit"])
def test_each_rank_block_equals_the_one_process_step(runs, name):
    shape = runs["cases"][name][2]
    for rank, out in enumerate(runs["port"]):
        r = out[name]
        whole, loss = r["whole"]
        _close(r["metrics"]["loss"], loss.numpy(), TOL, "loss")
        for path, block in r["blocks"].items():
            want = _slice(whole[path], r["placements"][path], divmod(rank, shape[1]), shape)
            _close(block, want.numpy(), TOL, (name, rank, path))


@pytest.mark.parametrize("name", list(REFERENCE) + list(PORT_ONLY))
def test_replicated_leaves_and_metrics_are_the_same_bits_on_every_rank(runs, name):
    port = runs["port"]
    for out in port[1:]:
        r, r0 = out[name], port[0][name]
        assert torch.equal(r["metrics"]["loss"], r0["metrics"]["loss"])
        assert torch.equal(r["metrics"]["grad_norm"], r0["metrics"]["grad_norm"])
        for path, block in r["blocks"].items():
            if all(p == "R" for p in r["placements"].get(path, ("R",))):
                assert torch.equal(block, r0["blocks"][path]), (name, path)


@pytest.mark.parametrize("name", ["mamba2", "mamba2_m4", "zamba2"])
def test_sequence_split_ssd_never_makes_the_whole_sequence(runs, name):
    arch, upd, shape, _ = runs["cases"][name]
    cfg = _torch_ranks.tp_case_config(arch, upd)
    b, seq = 4 // shape[0], 16                  # _batch's 4 x 16, the batch cut over data
    whole = _torch_ranks.ssd_whole_sequence(cfg, b, seq)
    for out in runs["port"]:
        shapes = set(out[name]["layer_shapes"])
        assert shapes, name
        assert not whole & shapes, (name, whole & shapes)


def _layouts(per, pspec, sizes):
    """Every shape a leaf's (or a layer's) ``per`` can take with any of
    the mesh axes its spec names cut or gathered."""
    import itertools
    axes = sorted({a for e in pspec if e is not None for a in ((e,) if isinstance(e, str) else e)})
    out = set()
    for keep in itertools.product((False, True), repeat=len(axes)):
        cut = {a for a, k in zip(axes, keep) if k}
        out.add(tuple(s // math.prod(sizes[a] for a in ((e,) if isinstance(e, str) else e or ())
                                     if a in cut) for s, e in zip(per, pspec)))
    return out


def test_no_rank_holds_a_whole_sharded_leaf(runs):
    """(d): the shapes every operation of the step made on each rank."""
    arch, upd, shape, rupd = runs["cases"]["meter"]
    cfg = _torch_ranks.tp_case_config(arch, upd)
    params = runs["inits"]["meter"]
    with fake_world(4):
        rules = make_rules(make_local_mesh(*shape), cfg, RunConfig(**rupd))
        specs = dict(pytree.leaves_with_path(rules.param_specs(params)))
    sizes = {"data": shape[0], "model": shape[1]}
    forbidden, gathered, layouts = set(), set(), set()
    for path, leaf in pytree.leaves_with_path(params):
        spec, full = tuple(specs[path]), tuple(leaf.shape)
        stacked = "layers" in path
        per, pspec = (full[1:], spec[1:]) if stacked else (full, spec)
        if any(e is not None for e in spec):
            forbidden.add(full)                          # the whole leaf
            if stacked and "model" in pspec:
                forbidden.add(per)                       # a whole layer
        lay = _layouts(per, pspec, sizes)
        layouts |= lay | ({(full[0],) + s for s in lay} if stacked else set())
        # one layer's (a leaf's) block gathered over data
        gathered.add(tuple(s // (sizes["model"] if e == "model" else 1)
                           for s, e in zip(per, pspec)))
    largest = max(math.prod(s) for s in gathered)
    for out in runs["port"]:
        shapes = set(out["meter"]["shapes"])
        assert not forbidden & shapes, forbidden & shapes
        held = [s for s in shapes if s in layouts - forbidden]
        assert max(math.prod(s) for s in held) == largest
        assert any(s in gathered and math.prod(s) == largest for s in held)


def test_a_rank_computes_a_share_of_the_flops(runs):
    """(e): at (data 1, model 4)."""
    for out in runs["port"]:
        split, whole = out["seqsplit"]["flops"]
        assert 0 < split <= 0.3 * whole, (split, whole)


@pytest.mark.parametrize("dim", [0, 1])
def test_reduce_scatter_is_the_ordered_allreduce_slice(runs, dim):
    """(f)."""
    port = runs["port"]
    for rank, out in enumerate(port):
        got, full = out["rs"][dim]
        assert torch.equal(full, port[0]["rs"][dim][1])
        n = full.shape[dim] // 4
        assert torch.equal(got, full.narrow(dim, rank * n, n))
    assert torch.allclose(port[0]["rs"][dim][1], RS_DATA.sum(0), rtol=1e-6, atol=1e-6)


def test_constrain_lays_an_activation_out_by_the_rules(runs):
    x = RS_DATA[:, :, :4]                       # (B 4, S 8, D 4), whole on every rank
    for rank, out in enumerate(runs["port"]):
        assert torch.equal(out["constrain"]["act"], x[:, 2 * rank:2 * rank + 2])
        assert torch.equal(out["constrain"]["qkv"], x)
