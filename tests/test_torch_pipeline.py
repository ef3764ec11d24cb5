"""The port's ``sharding/pipeline.py`` on a gloo world of 4 ranks, 4
stages over the ``model`` axis (``launch/mesh.py::run_local``), against the
sequential stack and against the JAX package's ``pipeline_forward`` on 8
forced XLA CPU devices, a ``(2, 4)`` mesh (one ``tests/_mdev.py``
subprocess): the reference's test (``tests/test_distributed_multidev.py::
test_pipeline_parallel_fwd_and_grad``: 8 tanh layers of 16 × 16, 4
microbatches of 4) — the output on every rank within 1e-5 of both, each
stage's gradient of ``(out ** 2).sum()`` within 1e-5 of their max, none
outside its own stage; and the reference's two refusals
(``tests/test_robustness.py``: layers not divisible by stages, a batch not
divisible by microbatches)."""
import os
import tempfile

import numpy as np
import pytest
import torch

import _torch_ranks
from _mdev import run_multidevice
from repro_torch.launch.mesh import fake_world, run_local
from repro_torch.sharding.pipeline import pipeline_forward, split_stages

_rng = np.random.default_rng(0)
WS = (_rng.standard_normal((8, 16, 16)) * 0.3).astype(np.float32)
X = _rng.standard_normal((16, 16)).astype(np.float32)
STAGES, MICRO = 4, 4

_REFERENCE = """
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import Mesh
from repro.sharding.pipeline import pipeline_forward, split_stages
d = np.load(IN)
mesh = Mesh(np.array(jax.devices()).reshape(2, 4), ("data", "model"))
Ws, x = jnp.asarray(d["ws"]), jnp.asarray(d["x"])
def stage_fn(wstack, h):
    def body(h, w): return jnp.tanh(h @ w), None
    return jax.lax.scan(body, h, wstack)[0]
out = pipeline_forward(stage_fn, split_stages(Ws, 4), x, mesh, axis="model", n_microbatches=4)
g = jax.grad(lambda w: (pipeline_forward(stage_fn, split_stages(w, 4), x, mesh, axis="model",
                                         n_microbatches=4) ** 2).sum())(Ws)
np.savez(OUT, out=np.asarray(out), grad=np.asarray(g))
print("OK")
"""


def _sequential(ws, x):
    h = x
    for w in ws:
        h = torch.tanh(h @ w)
    return h


@pytest.fixture(scope="module")
def runs():
    with tempfile.TemporaryDirectory(prefix="repro_torch_pipeline_") as tmp:
        src, dst = os.path.join(tmp, "in.npz"), os.path.join(tmp, "out.npz")
        np.savez(src, ws=WS, x=X)
        run_multidevice(_REFERENCE.replace("IN", repr(src)).replace("OUT", repr(dst)),
                        n_devices=8)
        with np.load(dst) as f:
            ref = dict(f)
    port = run_local(_torch_ranks.pipeline, torch.from_numpy(WS), torch.from_numpy(X), STAGES,
                     MICRO, world_size=STAGES)
    w = torch.from_numpy(WS).requires_grad_()
    seq = _sequential(w, torch.from_numpy(X))
    (g,) = torch.autograd.grad((seq ** 2).sum(), w)
    return ref, port, seq.detach(), g


def _rel(got, want):
    want = np.asarray(want, np.float64)
    return np.abs(np.asarray(got, np.float64) - want).max() / np.abs(want).max()


def test_forward_matches_the_sequential_stack_and_the_reference(runs):
    ref, port, seq, _ = runs
    for out in port:
        assert np.abs(out["out"].numpy() - seq.numpy()).max() < 1e-5
        assert np.abs(out["out"].numpy() - ref["out"]).max() < 1e-5
        assert torch.equal(out["out"], port[0]["out"])


def test_gradients_match_the_sequential_stack_and_the_reference(runs):
    ref, port, _, g = runs
    per = WS.shape[0] // STAGES
    got = torch.cat([o["grad"] for o in sorted(port, key=lambda o: o["stage"])])
    assert [o["stage"] for o in port] == list(range(STAGES))
    assert _rel(got, g) < 1e-5
    assert _rel(got, ref["grad"]) < 1e-5
    for o in port:
        assert float(o["grad_elsewhere"]) == 0.0
        assert o["grad"].shape == (per, 16, 16)


def test_refusals_match_the_reference():
    with pytest.raises(ValueError, match="not divisible"):
        split_stages({"w": torch.zeros((5, 2))}, 2)
    from torch.distributed.device_mesh import init_device_mesh
    with fake_world(1):
        mesh = init_device_mesh("cpu", (1,), mesh_dim_names=("model",))
        with pytest.raises(ValueError, match="microbatches"):
            pipeline_forward(lambda p, h: h, {"w": torch.zeros((1, 1, 2))},
                             torch.zeros((5, 2)), mesh, n_microbatches=2)
