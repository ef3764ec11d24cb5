"""The SSD mixer on a sequence split over ``model`` (the rules' default
``ssm_x`` layout, ``run.ssm_head_shard`` off: ``models/mamba2.py::
_mamba_seq`` and ``_SeqCarry``, ``Split.halo`` and ``Split.stacked``) on
a gloo world of 4 ranks (one ``run_local`` spawn for the file) against the
JAX package's whole-sequence functions in this process, from the same
seeded numpy inputs, float32:

* the SSD core: ``repro.models.mamba2.ssd_chunked`` on the whole sequence
  against the port's ``ssd_chunked`` on each rank's block, the carry
  folding the blocks before it: each rank's output block, the sequence's
  final state, and the gradients (``jax.grad`` against autograd) of
  ``Σ y·cy + Σ final·cs``: each rank's block of the x, dt, B and C
  gradients, the a_log and d_skip gradients summed over the ``model``
  ranks;
* the layer: ``repro.models.mamba2.mamba_apply(return_state=True)`` against
  the port's ``mamba_apply(constrain=)`` on each rank's block of the stream
  (the causal conv's halo crossing the block boundaries): the output
  block, the cache blocks in ``Rules.cache_pspec``'s layout (the final
  state by heads, the conv tail by channels), and the gradients of every
  parameter (whole on every rank, its gradient summed over ``model``) and
  of the stream's block;

every array within 1e-5 of its largest entry.  The cases (mesh, S,
chunk): 2 blocks of 64 at (data 2, model 2) with chunk 16 (4 chunks a
block), 2 blocks of 60 with chunk 64, 4 blocks of 30 with chunk 64 (the
reference chunks the 120 positions by 60, a block by 30), 4 blocks of 32
with chunk 16, and 4 blocks of 2 (S = 8: the conv's halo of 3 positions
reaches two blocks back).  At S = 120 on 4 blocks no operation of the
layer's forward or backward makes a tensor with a dimension of 120, 60 or
360 (the whole sequence, the whole sequence's chunk, or the batch's
positions flattened)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import _torch_ranks
from repro import configs as jconfigs
from repro.models import mamba2 as jm
from repro_torch import configs
from repro_torch.launch.mesh import run_local

SMALL = dict(d_model=32, ssm_head_dim=8, ssm_state=16, ssm_groups=2, n_layers=1)
# name -> (mesh shape, S, chunk)
CASES = {
    "b2_q16": ((2, 2), 128, 16),
    "b2_s120": ((2, 2), 120, 64),
    "b4_s120": ((1, 4), 120, 64),
    "b4_q16": ((1, 4), 128, 16),
    "b4_s8": ((1, 4), 8, 64),
}
BATCH = 3
TOL = 1e-5


def _cfg(pkg):
    return dataclasses.replace(pkg.get("mamba2-1.3b"), **SMALL)


def _inputs(seq, seed):
    cfg = _cfg(configs)
    rng = np.random.default_rng(seed)
    f = lambda *shape: rng.standard_normal(shape).astype(np.float32)
    B, H, P, G, N = BATCH, cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_groups, cfg.ssm_state
    D, di, w = cfg.d_model, cfg.d_inner, cfg.ssm_conv
    conv_ch, K = di + 2 * G * N, 2 * di + 2 * G * N + H
    softplus = lambda v: np.log1p(np.exp(v)).astype(np.float32)
    return {
        "x": f(B, seq, H, P), "dt": softplus(f(B, seq, H) - 1), "a_log": 0.5 * f(H),
        "b": f(B, seq, G, N), "c": f(B, seq, G, N), "d": f(H),
        "cy": f(B, seq, H, P), "cs": f(B, G, H // G, P, N),
        "p/ln": 1 + 0.1 * f(D), "p/w_in": f(D, K) / np.sqrt(D), "p/conv": 0.2 * f(w, conv_ch),
        "p/conv_b": 0.1 * f(conv_ch), "p/a_log": 0.5 * f(H) - 1, "p/d_skip": f(H),
        "p/dt_bias": f(H) - 3, "p/gate_norm": 1 + 0.1 * f(di), "p/w_out": f(di, D) / np.sqrt(di),
        "h": f(B, seq, D), "co": f(B, seq, D), "ct": f(B, w, conv_ch),
    }


def _reference(inp, chunk):
    """The JAX package's whole-sequence SSD and layer, their outputs and
    gradients (jitted)."""
    j = {k: jnp.asarray(v) for k, v in inp.items()}

    def ssd(x, dt, a_log, b, c, d):
        y, fin = jm.ssd_chunked(x, dt, a_log, b, c, d, chunk=chunk)
        return (y * j["cy"]).sum() + (fin * j["cs"]).sum(), (y, fin)

    args = [j[k] for k in ("x", "dt", "a_log", "b", "c", "d")]
    (_, (y, fin)), g = jax.jit(jax.value_and_grad(ssd, argnums=tuple(range(6)),
                                                  has_aux=True))(*args)
    cfg = _cfg(jconfigs)
    names = [k for k in inp if k.startswith("p/")]

    def layer(pv, h):
        p = dict(zip((k[2:] for k in names), pv))
        p["ln"] = {"scale": p.pop("ln")}
        out, (state, tail) = jm.mamba_apply(p, h, cfg, chunk=chunk, return_state=True)
        loss = (out * j["co"]).sum() + (state * j["cs"]).sum() + (tail * j["ct"]).sum()
        return loss, (out, state, tail)

    (_, (out, state, tail)), (gp, gh) = jax.jit(jax.value_and_grad(
        layer, argnums=(0, 1), has_aux=True))([j[k] for k in names], j["h"])
    return {"ssd": {"y": y, "final": fin,
                    "grads": dict(zip(("x", "dt", "a_log", "b", "c", "d"), g))},
            "layer": {"out": out, "state": state, "tail": tail,
                      "grads": dict(dict(zip(names, gp)), h=gh)}}


@pytest.fixture(scope="module")
def runs():
    inputs = {name: _inputs(seq, i) for i, (name, (_, seq, _)) in enumerate(CASES.items())}
    port = run_local(_torch_ranks.ssd_sequence, _cfg(configs), CASES, inputs, world_size=4)
    ref = {name: _reference(inputs[name], CASES[name][2]) for name in CASES}
    return {"port": port, "ref": ref}


def _close(got, want, what):
    got = got.detach().cpu().numpy().astype(np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = np.abs(got - want).max() / (np.abs(want).max() or 1.0)
    assert err <= TOL, (what, err)


def _block(a, r, tp, dim=1):
    n = a.shape[dim] // tp
    return np.take(np.asarray(a), np.arange(r * n, (r + 1) * n), axis=dim)


def _groups(port, name):
    """The ranks of each ``model`` group, in ``model`` order."""
    tp = port[0][name]["tp"]
    return [port[i:i + tp] for i in range(0, len(port), tp)]


@pytest.mark.parametrize("name", list(CASES))
def test_blockwise_ssd_matches_the_whole_sequence(runs, name):
    want = runs["ref"][name]["ssd"]
    for group in _groups(runs["port"], name):
        for out in group:
            r, tp, got = out[name]["rank"], out[name]["tp"], out[name]["ssd"]
            _close(got["y"], _block(want["y"], r, tp), (name, r, "y"))
            _close(got["final"], want["final"], (name, r, "final"))
            for k in ("x", "dt", "b", "c"):
                _close(got["grads"][k], _block(want["grads"][k], r, tp), (name, r, k))
        for k in ("a_log", "d"):
            total = sum(out[name]["ssd"]["grads"][k] for out in group)
            _close(total, want["grads"][k], (name, k))


@pytest.mark.parametrize("name", list(CASES))
def test_sequence_split_layer_matches_the_whole_sequence(runs, name):
    want = runs["ref"][name]["layer"]
    for group in _groups(runs["port"], name):
        for out in group:
            r, tp, got = out[name]["rank"], out[name]["tp"], out[name]["layer"]
            _close(got["out"], _block(want["out"], r, tp), (name, r, "out"))
            _close(got["state"], _block(want["state"], r, tp, dim=2), (name, r, "state"))
            _close(got["tail"], _block(want["tail"], r, tp, dim=2), (name, r, "tail"))
            for k, g in got["grads"].items():
                w = _block(want["grads"][k], r, tp) if k == "h" else want["grads"][k]
                _close(g, w, (name, r, k))


def test_layer_never_makes_the_whole_sequence(runs):
    name = "b4_s120"
    for out in runs["port"]:
        shapes = out[name]["shapes"]
        assert shapes, name
        made = [s for s in shapes if {120, 60, 360} & set(s)]
        assert not made, made
