"""The port's example twins and LM entry points on the CPU: the INLA twin's
``objective_terms`` against the reference's (``examples/inla_gmrf.py``,
loaded by path, its precision built at the same reduced ``nt``/``ns``) at
rtol 1e-5, and its ``main`` at that size (the objective falling, finite
posterior summaries); the distributed twin on gloo worlds of 1 and 2
(its factor against the dense Cholesky and ``factorize_window``); the
train_lm twin's ``main`` (its config registered for the run and removed
after); the dense LM server's ``main`` and its ``serve.*`` telemetry, the
reference's names."""
import functools
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from repro.core import TileGrid as JTileGrid
from repro_torch import configs
from repro_torch.configs.base import RunConfig
from repro_torch.core import TileGrid
from repro_torch.examples import distributed_factorization, inla_gmrf, train_lm
from repro_torch.launch import serve
from repro_torch.launch.train import reduce_config
from repro_torch.runtime import telemetry

ROOT = Path(__file__).resolve().parents[1]
NT, NS = 6, 12           # the INLA twin at a reduced size: n = 72 latents + 16


@functools.lru_cache(maxsize=None)
def _reference_inla():
    spec = importlib.util.spec_from_file_location("_ref_inla_gmrf",
                                                  ROOT / "examples" / "inla_gmrf.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_inla_objective_terms_match_reference():
    ref = _reference_inla()
    thetas = [np.array([0.0, 0.5, 0.0]), np.array([0.05, 0.5, 0.0]),
              np.array([0.0, 0.45, -0.1])]
    _, struct = inla_gmrf.build_precision(thetas[0], NT, NS)
    y = np.random.default_rng(1).standard_normal(TileGrid(struct, t=8).padded_n) * 0.1
    want, _, _ = _ref_terms(ref, thetas, struct, y)
    got, factor, _ = inla_gmrf.objective_terms(thetas, TileGrid(struct, t=8),
                                               torch.as_tensor(y, dtype=torch.float32), NT, NS)
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5)
    assert factor.ctsf.Dr.shape[0] == len(thetas)


def _ref_terms(ref, thetas, struct, y):
    """The reference's objective_terms with its precision built at the
    reduced size (its module global swapped for the call)."""
    orig = ref.build_precision
    ref.build_precision = functools.partial(orig, nt=NT, ns=NS)
    try:
        return ref.objective_terms(thetas, JTileGrid(struct, t=8), jnp.asarray(y, jnp.float32))
    finally:
        ref.build_precision = orig


def test_inla_twin_main_fits_theta():
    out = inla_gmrf.main(["--device", "cpu"], nt=NT, ns=NS, iters=3)
    f = out["objective"]
    assert all(np.isfinite(f)) and all(b <= a for a, b in zip(f, f[1:]))
    assert np.isfinite([out["sd_min"], out["sd_max"]] + out["corr"]).all()
    assert out["samples_finite"] and out["samples_shape"][1] == 32


@pytest.mark.parametrize("world", [1, 2])
def test_distributed_twin_on_gloo_worlds(world):
    out = distributed_factorization.main(["--device", "cpu", "--world", str(world)])
    assert out["world"] == world and out["backend"] == "gloo"
    assert out["dense_max_err"] <= 1e-4 and out["window_rel_err"] <= 1e-4


def test_train_lm_twin_main_passes_its_config_to_train():
    out = train_lm.main(["--device", "cpu", "--steps", "2", "--batch", "2", "--seq", "16"])
    assert out["cfg"].name == "lm-10m" and len(out["losses"]) == 2
    assert np.isfinite(out["losses"]).all()
    with pytest.raises(KeyError):
        configs.get("lm-10m")
    assert 8e7 < train_lm.model_100m().param_count() < 1.2e8


def test_serve_main_and_telemetry_names():
    out = serve.main(["--device", "cpu", "--batch", "2", "--prompt-len", "8", "--gen", "4"])
    assert out["tokens"].shape == (2, 4)
    cfg = reduce_config(configs.get("qwen2-7b"))
    server = serve.Server(cfg, RunConfig(remat="none", compute_dtype="float32"), max_len=12,
                          device="cpu")
    telemetry.reset()
    telemetry.enable()
    try:
        batch = {"tokens": np.random.default_rng(0).integers(0, cfg.vocab, (2, 8))}
        res = server.generate(batch, 4)
        snap = telemetry.snapshot()
    finally:
        telemetry.disable()
        telemetry.reset()
    names = {s["name"] for s in snap["spans"]}
    assert "serve.request" in names
    keys = " ".join(list(snap["counters"]) + list(snap["histograms"]))
    for name in ("serve.requests", "serve.tokens_generated", "serve.prefill_seconds",
                 "serve.decode_seconds", "serve.request_seconds"):
        assert name in keys, (name, keys)
    # greedy decode is the argmax of a full forward at every position
    seq = torch.cat([torch.as_tensor(batch["tokens"]), torch.as_tensor(res["tokens"])], 1)
    with torch.no_grad():
        logits, _ = server.api.prefill(server.params, {"tokens": seq[:, :-1]}, server.cfg,
                                       server.run)
    assert torch.equal(torch.argmax(logits, -1), torch.as_tensor(res["tokens"][:, -1]))
