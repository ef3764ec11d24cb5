"""The port's dense model (``models/transformer.py``, ``convert.py``), the
registry of all six families and the configs against the JAX package's,
on the CPU: the
reference's parameters carried over by ``params_from_numpy``, the same
numpy batch through both.  At ``compute_dtype="float32"``: the loss at
rtol 1e-5 and every gradient at rtol 1e-4 (relative to the leaf's largest
entry) in three variants (plain; ``qkv_bias``; ``qk_norm`` +
``tie_embeddings``), the prefill's logits and caches and three decode
steps' logits at rtol 1e-5.  One bfloat16 case: the loss at rtol 2e-2
(bfloat16 keeps 8 bits; the two packages round the same products in
different orders).  Model: 2 layers, d_model 64, 4 heads, 2 KV heads,
vocab 128, seq 16."""
import dataclasses
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import repro.configs as jconfigs
from repro.configs.base import ModelConfig as JModelConfig, RunConfig as JRunConfig
from repro.models import transformer as JT
from repro_torch import configs, pytree
from repro_torch.configs.base import ModelConfig, RunConfig
from repro_torch.models import transformer as T
from repro_torch.models.convert import ParamTree, params_from_numpy, params_to_numpy
from repro_torch.models.registry import build_module, get_model

ROOT = Path(__file__).resolve().parents[1]
BASE = dict(name="tiny", family="dense", n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
            d_ff=96, vocab=128, head_dim=16)
VARIANTS = {"plain": {}, "qkv_bias": {"qkv_bias": True},
            "qk_norm_tied": {"qk_norm": True, "tie_embeddings": True}}
RUN = dict(compute_dtype="float32", remat="none", q_chunk=8, kv_chunk=4, loss_chunk=8)


def _cfgs(variant, **extra):
    kw = {**BASE, **VARIANTS[variant], **extra}
    return JModelConfig(**kw), ModelConfig(**kw)


def _runs(**over):
    kw = {**RUN, **over}
    return JRunConfig(**kw), RunConfig(**kw)


def _ref_params(jcfg, seed=0):
    """The reference's init, every leaf perturbed so biases and norm scales
    are not trivial."""
    p = JT.init(jax.random.PRNGKey(seed), jcfg)
    leaves, tree = jax.tree.flatten(p)
    keys = jax.random.split(jax.random.PRNGKey(seed + 1), len(leaves))
    return jax.tree.unflatten(tree, [x + 0.05 * jax.random.normal(k, x.shape)
                                     for x, k in zip(leaves, keys)])


def _batch(seed=0, B=2, S=16, vocab=128):
    r = np.random.default_rng(seed)
    return {"tokens": r.integers(0, vocab, (B, S)).astype(np.int32),
            "labels": r.integers(-1, vocab, (B, S)).astype(np.int32)}


def _tb(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _port_loss_and_grads(params, batch, cfg, run):
    leaves = [x.detach().clone().requires_grad_() for x in pytree.leaves(params)]
    loss = T.loss(pytree.unflatten(params, leaves), _tb(batch), cfg, run)
    return loss.detach(), torch.autograd.grad(loss, leaves)


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_loss_and_gradients_match_reference(variant):
    jc, tc = _cfgs(variant)
    jr, tr = _runs()
    p = _ref_params(jc)
    batch = _batch()
    jl, jg = jax.value_and_grad(lambda q: JT.loss(q, batch, jc, jr))(p)
    tl, tg = _port_loss_and_grads(params_from_numpy(jax.tree.map(np.asarray, p)), batch,
                                  tc, tr)
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    for (path, a), b in zip(jax.tree_util.tree_leaves_with_path(jg), tg):
        a = np.asarray(a)
        np.testing.assert_allclose(b.numpy(), a, rtol=1e-4, atol=1e-4 * np.abs(a).max(),
                                   err_msg=jax.tree_util.keystr(path))


def test_bfloat16_loss_matches_reference_loosely():
    jc, tc = _cfgs("qk_norm_tied")
    jr, tr = _runs(compute_dtype="bfloat16")
    p = _ref_params(jc)
    batch = _batch(1)
    jl = JT.loss(p, batch, jc, jr)
    tl = T.loss(params_from_numpy(jax.tree.map(np.asarray, p)), _tb(batch), tc, tr)
    np.testing.assert_allclose(float(tl), float(jl), rtol=2e-2)


@pytest.mark.parametrize("remat", ["full", "dots"])
def test_remat_gives_the_same_loss_and_gradients(remat):
    _, tc = _cfgs("qkv_bias")
    _, tr0 = _runs()
    _, tr1 = _runs(remat=remat)
    params = T.init(torch.Generator().manual_seed(0), tc)
    batch = _batch(2)
    l0, g0 = _port_loss_and_grads(params, batch, tc, tr0)
    l1, g1 = _port_loss_and_grads(params, batch, tc, tr1)
    torch.testing.assert_close(l1, l0, rtol=1e-6, atol=0)
    for a, b in zip(g1, g0):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("variant", ["plain", "qk_norm_tied"])
def test_prefill_and_decode_match_reference(variant):
    """The prefill's last logits and its caches, then three greedy decode
    steps against the reference's on caches padded to 20 positions."""
    jc, tc = _cfgs(variant)
    jr, tr = _runs()
    p = _ref_params(jc, seed=3)
    tp = params_from_numpy(jax.tree.map(np.asarray, p))
    toks = _batch(3, S=12)["tokens"]
    jlog, jcache = JT.prefill(p, toks, jc, jr)
    tlog, tcache = T.prefill(tp, torch.from_numpy(toks), tc, tr)
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), rtol=1e-5,
                               atol=1e-5 * np.abs(np.asarray(jlog)).max())
    for k in ("k", "v"):
        np.testing.assert_allclose(tcache[k].numpy(), np.asarray(jcache[k]), rtol=1e-5,
                                   atol=1e-5)
    pad = lambda x: np.pad(np.asarray(x), [(0, 0), (0, 0), (0, 8), (0, 0), (0, 0)])
    jcache = {k: pad(v) for k, v in jcache.items()}
    tcache = {k: torch.from_numpy(pad(v.numpy())) for k, v in tcache.items()}
    tok = np.argmax(np.asarray(jlog), -1)[:, None].astype(np.int32)
    for i in range(3):
        jlog, jcache = JT.decode_step(p, jcache, tok, 12 + i, jc, jr)
        tlog, tcache = T.decode_step(tp, tcache, torch.from_numpy(tok), 12 + i, tc, tr)
        np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), rtol=1e-5,
                                   atol=1e-5 * np.abs(np.asarray(jlog)).max())
        tok = np.argmax(np.asarray(jlog), -1)[:, None].astype(np.int32)
    np.testing.assert_allclose(tcache["k"].numpy(), np.asarray(jcache["k"]), rtol=1e-5,
                               atol=1e-5)


def test_vlm_stub_matches_reference():
    """Precomputed patch embeddings in the first positions."""
    jc, tc = _cfgs("plain", family="vlm", n_image_tokens=3)
    jr, tr = _runs()
    p = _ref_params(jc, seed=4)
    batch = _batch(4)
    batch["image_embeds"] = np.random.default_rng(5).standard_normal(
        (2, 3, 64)).astype(np.float32)
    jl = JT.loss(p, batch, jc, jr)
    tl = T.loss(params_from_numpy(jax.tree.map(np.asarray, p)), _tb(batch), tc, tr)
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)


def test_parameters_are_stacked_and_ordered_as_the_reference():
    """init's names, shapes and stacked layer axis in the reference's leaf
    order, the module's parameters under the same names, the converter both
    ways."""
    jc, tc = _cfgs("qkv_bias")
    jp = JT.init(jax.random.PRNGKey(0), jc)
    tp = T.init(torch.Generator().manual_seed(0), tc)
    jpaths = ["/".join(str(k.key) for k in path)
              for path, _ in jax.tree_util.tree_leaves_with_path(jp)]
    assert [p for p, _ in pytree.leaves_with_path(tp)] == jpaths
    assert [tuple(x.shape) for x in pytree.leaves(tp)] == [x.shape for x in jax.tree.leaves(jp)]
    assert tp["layers"]["attn"]["wq"].shape == (2, 64, 64)
    model = T.Transformer(tc, RunConfig(**RUN), tp)
    assert sorted(n.replace(".", "/") for n, _ in model.named_parameters()) == sorted(
        "tree/" + p for p in jpaths)
    assert [p for p, _ in pytree.leaves_with_path(model.params())] == jpaths
    assert all(a.data_ptr() == b.data_ptr()          # the module shares init's storage
               for a, b in zip(pytree.leaves(model.params()), pytree.leaves(tp)))
    back = params_to_numpy(params_from_numpy(jax.tree.map(np.asarray, jp)))
    for a, b in zip(jax.tree.leaves(jp), pytree.leaves(back)):
        np.testing.assert_array_equal(np.asarray(a), b)
    batch = _tb(_batch())
    assert torch.equal(model(batch), T.loss(tp, batch, tc, RunConfig(**RUN)))
    jcache, tcache = JT.init_cache(jc, 2, 10), T.init_cache(tc, 2, 10, device="cpu")
    assert {k: (tuple(v.shape), str(v.dtype)) for k, v in tcache.items()} == {
        k: (v.shape, "torch." + str(v.dtype)) for k, v in jcache.items()}
    assert isinstance(model.tree, ParamTree)


def test_registry_resolves_every_family():
    """``get_model`` resolves each of the six families to its module's
    entry points and ``build_module`` to its ``nn.Module``; the
    transformer's init builds a MoE layer where the family says so."""
    from repro_torch.models import mamba2, whisper, zamba2
    want = {"qwen2-7b": (T, T.Transformer), "phi-3-vision-4.2b": (T, T.Transformer),
            "granite-moe-1b-a400m": (T, T.Transformer), "mamba2-1.3b": (mamba2, mamba2.Mamba2),
            "zamba2-2.7b": (zamba2, zamba2.Zamba2), "whisper-medium": (whisper, whisper.Whisper)}
    assert {configs.get(a).family for a in want} == {"dense", "vlm", "moe", "ssm", "hybrid",
                                                     "encdec"}
    for arch, (module, cls) in want.items():
        api = get_model(configs.get(arch))
        assert (api.loss, api.decode_step, api.init_cache) == (
            module.loss, module.decode_step, module.init_cache), arch
        assert cls.__name__ in module.__all__
    cfg = dataclasses.replace(configs.get("granite-moe-3b-a800m"), n_layers=1, d_model=32,
                              n_heads=2, n_kv_heads=1, head_dim=16, d_ff=8, vocab=64)
    p = T.init(torch.Generator().manual_seed(0), cfg)
    assert "mlp" not in p["layers"] and p["layers"]["moe"]["wi"].shape == (1, 48, 32, 8)
    assert p["layers"]["moe"]["router"].shape == (1, 32, 40)
    assert isinstance(build_module(cfg, RunConfig(**RUN), p), T.Transformer)
    with pytest.raises(ValueError, match="dense, moe and vlm"):
        T.init(torch.Generator(), configs.get("mamba2-1.3b"))


def test_configs_are_the_reference_configs():
    assert configs.ARCH_IDS == jconfigs.ARCH_IDS
    for arch in configs.ARCH_IDS:
        a, b = configs.get(arch), jconfigs.get(arch)
        assert dataclasses.asdict(a) == dataclasses.asdict(b)
        assert (a.hd, a.vocab_padded, a.param_count(), a.active_param_count()) == (
            b.hd, b.vocab_padded, b.param_count(), b.active_param_count())
    assert dataclasses.asdict(RunConfig()) == dataclasses.asdict(JRunConfig())
    assert configs.SHAPES == {k: configs.ShapeConfig(**dataclasses.asdict(v))
                              for k, v in jconfigs.SHAPES.items()}
    with pytest.raises(KeyError):
        configs.get("nope")


def test_port_sources_import_no_jax_nor_the_reference():
    """No module of src/repro_torch/ and not chip_smoke.py imports jax or
    anything of the JAX package (grep), and importing the LM substrate
    loads neither (a fresh interpreter)."""
    pat = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|repro)(\.|\s|$)", re.M)
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    bad = [str(f.relative_to(ROOT)) for f in files if pat.search(f.read_text())]
    assert not bad, bad
    code = ("import sys, repro_torch.launch.train, repro_torch.launch.serve, "
            "repro_torch.examples.train_lm, repro_torch.examples.inla_gmrf, "
            "repro_torch.examples.distributed_factorization, repro_torch.checkpoint.checkpointer; "
            "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'repro')]; "
            "print(bad); sys.exit(1 if bad else 0)")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, cwd=ROOT, env={**__import__("os").environ,
                                                     "PYTHONPATH": str(ROOT / "src")})
    assert out.returncode == 0, out.stdout + out.stderr
