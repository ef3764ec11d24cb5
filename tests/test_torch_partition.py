"""The port's ``sharding/partition.py`` against the JAX package's: every
leaf's parameter spec of every architecture of ``configs.ARCH_IDS`` at its
full config, the decode caches' specs (``decode_32k``, ``long_500k``), the
batch specs of every shape's inputs and the activation specs of every kind,
on the production meshes 16 × 16 and 2 × 16 × 16, equal exactly.  The
reference's side runs in one ``tests/_mdev.py`` subprocess with 512 forced
XLA devices (``jax.eval_shape``, no compile); the port's in this process,
on a fake world of 256 and of 512 ranks (``launch/mesh.py::fake_world``),
its shapes from ``init`` and ``init_cache`` under ``FakeTensorMode``.  Also
the placements a spec gives (``("pod", "data")`` is ``Shard(d)`` on both,
pod-major) and ``shard_tensor`` / ``gather_tensor`` on a fake world's
coordinates."""
import json

import pytest
import torch

from _mdev import run_multidevice
from repro_torch import configs, pytree
from repro_torch.configs.base import RunConfig, SHAPES
from repro_torch.launch.mesh import fake_world, make_production_mesh
from repro_torch.models.registry import get_model, input_specs
from repro_torch.sharding.partition import P, make_rules, shard_shape

MAX_SEQ = 4096
CACHE_SHAPES = ("decode_32k", "long_500k")
KINDS = ("act", "ff", "experts", "experts_ff", "ssm_x", "other")
RUNS = {"default": {}, "heads": {"ssm_head_shard": True, "activation_sharding": "replicated"}}

_REFERENCE = f"""
import json, numpy as np, jax
from jax.sharding import Mesh
from repro import configs
from repro.checkpoint.checkpointer import _flatten
from repro.configs.base import RunConfig, SHAPES
from repro.models.registry import get_model, input_specs
from repro.sharding.partition import make_rules
devs = np.array(jax.devices())
meshes = {{"16x16": Mesh(devs[:256].reshape(16, 16), ("data", "model")),
          "2x16x16": Mesh(devs.reshape(2, 16, 16), ("pod", "data", "model"))}}
def enc(spec):
    return None if spec is None else [list(e) if isinstance(e, tuple) else e for e in spec]
out = {{}}
for arch in configs.ARCH_IDS:
    cfg = configs.get(arch)
    api = get_model(cfg)
    params = _flatten(jax.eval_shape(lambda k: api.init(k, cfg, {MAX_SEQ}), jax.random.PRNGKey(0)))
    caches = {{s: _flatten(jax.eval_shape(lambda: api.init_cache(cfg, SHAPES[s].global_batch,
                                                                 SHAPES[s].seq_len)))
              for s in {CACHE_SHAPES!r}}}
    for mname, mesh in meshes.items():
        for rname, kw in {RUNS!r}.items():
            rules = make_rules(mesh, cfg, RunConfig(**kw))
            rec = {{"act": {{f"{{k}}/{{n}}": enc(rules.act_pspec(k, n))
                            for k in {KINDS!r} for n in (3, 4)}}}}
            if rname == "default":
                rec["params"] = {{k: enc(rules.param_pspec(k, v)) for k, v in params.items()}}
                for s, c in caches.items():
                    rec["cache/" + s] = {{k: enc(rules.cache_pspec(k, v)) for k, v in c.items()}}
                for s in SHAPES:
                    rec["batch/" + s] = {{k: enc(sh.spec) for k, sh in
                                          rules.batch_specs(input_specs(cfg, SHAPES[s])).items()}}
            out[f"{{arch}}/{{mname}}/{{rname}}"] = rec
print("JSON" + json.dumps(out))
"""


def _enc(spec):
    return None if spec is None else [list(e) if isinstance(e, tuple) else e for e in spec]


def _shapes(arch):
    """Fake full-size parameters and caches of ``arch``."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    cfg = configs.get(arch)
    api = get_model(cfg)
    with FakeTensorMode():
        params = dict(pytree.leaves_with_path(api.init(torch.Generator(), cfg, MAX_SEQ)))
        caches = {s: dict(pytree.leaves_with_path(api.init_cache(
            cfg, SHAPES[s].global_batch, SHAPES[s].seq_len, device="cpu")))
            for s in CACHE_SHAPES}
    return cfg, params, caches


@pytest.fixture(scope="module")
def specs():
    stdout = run_multidevice(_REFERENCE, n_devices=512)
    ref = json.loads(stdout[stdout.index("JSON") + 4:])
    shapes = {arch: _shapes(arch) for arch in configs.ARCH_IDS}
    port = {}
    for multi_pod, mname in ((False, "16x16"), (True, "2x16x16")):
        with fake_world(512 if multi_pod else 256):
            mesh = make_production_mesh(multi_pod=multi_pod)
            for arch, (cfg, params, caches) in shapes.items():
                for rname, kw in RUNS.items():
                    rules = make_rules(mesh, cfg, RunConfig(**kw))
                    rec = {"act": {f"{k}/{n}": _enc(rules.act_pspec(k, n))
                                   for k in KINDS for n in (3, 4)}}
                    if rname == "default":
                        rec["params"] = {k: _enc(rules.param_pspec(k, v))
                                         for k, v in params.items()}
                        for s, c in caches.items():
                            rec["cache/" + s] = {k: _enc(rules.cache_pspec(k, v))
                                                 for k, v in c.items()}
                        for s in SHAPES:
                            rec["batch/" + s] = {
                                k: _enc(sh.spec) for k, sh in
                                rules.batch_specs(input_specs(cfg, SHAPES[s])).items()}
                    port[f"{arch}/{mname}/{rname}"] = rec
    return ref, port


@pytest.mark.parametrize("arch", configs.ARCH_IDS)
def test_specs_equal_the_reference_for_every_leaf_on_both_meshes(specs, arch):
    ref, port = specs
    for mname in ("16x16", "2x16x16"):
        for rname in RUNS:
            key = f"{arch}/{mname}/{rname}"
            assert port[key].keys() == ref[key].keys()
            for part in ref[key]:
                assert port[key][part] == ref[key][part], (key, part)


def test_placements_and_blocks_on_a_fake_world():
    with fake_world(512):
        mesh = make_production_mesh(multi_pod=True)
        cfg = configs.get("qwen2-7b")
        rules = make_rules(mesh, cfg, RunConfig())
        sh = rules.batch_specs({"tokens": torch.empty((256, 8), device="meta")})["tokens"]
        assert sh.spec == P(("pod", "data"), None)
        assert [str(p) for p in sh.placements] == ["S(0)", "S(0)", "R"]
        assert shard_shape((256, 8), sh) == (8, 8)
        w = rules.param_shardings({"wq": torch.empty((3584, 3584), device="meta")})["wq"]
        assert w.spec == P("data", "model")
        assert [str(p) for p in w.placements] == ["R", "S(0)", "S(1)"]
        assert rules.replicated().spec == P()
        # rank 0 holds the first block, pod-major
        from repro_torch.sharding.partition import shard_tensor
        x = torch.arange(256 * 2).reshape(256, 2)
        assert torch.equal(shard_tensor(x, sh), x[:8])
    assert P(("data",), None) == P("data", None) and P((), None) == P(None, None)
