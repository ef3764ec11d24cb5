"""The port's ``optim/compress.py`` and ``runtime/dp_compressed.py`` on a
gloo world of 4 ranks (``launch/mesh.py::run_local``, one spawn for the
file) against the JAX package's on 4 forced XLA CPU devices (one
``tests/_mdev.py`` subprocess): ``ef_compress_allreduce`` of each rank's
row of two seeded leaves with a seeded residual — the codes the same
integers, the mean within 1e-6 of its max and the new residuals within
1e-6 of the quantized input's max (a residual is the difference of x and
its dequantized code, so the packages' one-ulp differences in x's scale
are its error); and the reference's 30-step compressed data-parallel regression
(``tests/test_distributed_multidev.py::test_compressed_dp_trains`` at world
4): the losses within 1e-5 relative at every step, the parameters the same
bits on every rank and within 1e-5 of the reference's."""
import os
import tempfile

import numpy as np
import pytest
import torch

import _torch_ranks
from _mdev import run_multidevice
from repro_torch.launch.mesh import run_local

WORLD, STEPS = 4, 30
_rng = np.random.default_rng(0)
GRADS = {"a": _rng.standard_normal((WORLD, 6, 5)).astype(np.float32),
         "b": _rng.standard_normal((WORLD, 7)).astype(np.float32)}
EF = {k: (0.01 * _rng.standard_normal(v.shape)).astype(np.float32) for k, v in GRADS.items()}
# the reference test's problem: params (8, 1) * 0.1, batch x (32, 8), y (32, 1)
_rng = np.random.default_rng(0)
W0 = (_rng.standard_normal((8, 1)) * 0.1).astype(np.float32)
BX = _rng.standard_normal((32, 8)).astype(np.float32)
BY = _rng.standard_normal((32, 1)).astype(np.float32)

_REFERENCE = """
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P
from jax.experimental.shard_map import shard_map
from repro.optim.adamw import adamw_init
from repro.optim.compress import ef_compress_allreduce
from repro.runtime.dp_compressed import make_compressed_dp_step
d = np.load(IN)
mesh = Mesh(np.array(jax.devices()), ("x",))
grads = {k: jnp.asarray(d["g_" + k]) for k in ("a", "b")}
ef = {k: jnp.asarray(d["e_" + k]) for k in ("a", "b")}
def local(g, e):
    g = {k: v[0] for k, v in g.items()}
    e = {k: v[0] for k, v in e.items()}
    m, ne = ef_compress_allreduce(g, e, "x")
    return ({k: v[None] for k, v in m.items()}, {k: v[None] for k, v in ne.items()})
try:
    sm = shard_map(local, mesh=mesh, in_specs=(P("x"), P("x")), out_specs=(P("x"), P("x")),
                   check_vma=False)
except TypeError:
    sm = shard_map(local, mesh=mesh, in_specs=(P("x"), P("x")), out_specs=(P("x"), P("x")),
                   check_rep=False)
mean, new_ef = jax.jit(sm)(grads, ef)
out = {"m_" + k: np.asarray(v) for k, v in mean.items()}
out.update({"ne_" + k: np.asarray(v) for k, v in new_ef.items()})
dp_mesh = Mesh(np.array(jax.devices()).reshape(4, 1), ("data", "model"))
def loss_fn(params, batch):
    return jnp.mean((batch["x"] @ params["w"] - batch["y"]) ** 2)
params = {"w": jnp.asarray(d["w0"])}
batch = {"x": jnp.asarray(d["bx"]), "y": jnp.asarray(d["by"])}
step, ef_init_fn = make_compressed_dp_step(loss_fn, dp_mesh, axis="data", lr=0.05)
state = (params, adamw_init(params), ef_init_fn(params))
losses = []
for i in range(30):
    state, m = step(state, batch)
    losses.append(float(m["loss"]))
out["losses"] = np.array(losses)
out["w"] = np.asarray(state[0]["w"])
np.savez(OUT, **out)
print("OK")
"""


@pytest.fixture(scope="module")
def runs():
    with tempfile.TemporaryDirectory(prefix="repro_torch_compress_") as tmp:
        src, dst = os.path.join(tmp, "in.npz"), os.path.join(tmp, "out.npz")
        np.savez(src, w0=W0, bx=BX, by=BY, **{"g_" + k: v for k, v in GRADS.items()},
                 **{"e_" + k: v for k, v in EF.items()})
        run_multidevice(_REFERENCE.replace("IN", repr(src)).replace("OUT", repr(dst)),
                        n_devices=WORLD)
        with np.load(dst) as f:
            ref = dict(f)
    t = lambda a: torch.from_numpy(a)
    port = run_local(_torch_ranks.compress, {k: t(v) for k, v in GRADS.items()},
                     {k: t(v) for k, v in EF.items()}, t(W0), {"x": t(BX), "y": t(BY)}, STEPS,
                     world_size=WORLD)
    return ref, port


def _codes(x, residual):
    """The local int8 codes ``round((x − residual) / scale)`` at this
    rank's own scale, as the reference's residual is taken."""
    scale = np.abs(x).max() / 127.0 + 1e-30
    return np.round((x - residual) / scale).astype(np.int64)


@pytest.mark.parametrize("leaf", ["a", "b"])
def test_ef_compress_allreduce_matches_reference(runs, leaf):
    ref, port = runs
    for rank, out in enumerate(port):
        x = GRADS[leaf][rank] + EF[leaf][rank]
        mean, ne = out["mean"][leaf].numpy(), out["ef"][leaf].numpy()
        want_mean, want_ne = ref["m_" + leaf][rank], ref["ne_" + leaf][rank]
        np.testing.assert_array_equal(_codes(x, ne), _codes(x, want_ne))
        assert np.abs(mean - want_mean).max() <= 1e-6 * np.abs(want_mean).max()
        # a residual is x less its dequantized code: an ulp of x apart
        assert np.abs(ne - want_ne).max() <= 1e-6 * np.abs(x).max()
        assert torch.equal(out["mean"][leaf], port[0]["mean"][leaf])


def test_compressed_dp_trains_like_the_reference(runs):
    ref, port = runs
    want = ref["losses"]
    got = port[0]["losses"].numpy().astype(np.float64)
    assert got.shape == (STEPS,)
    assert np.all(np.abs(got - want) <= 1e-5 * np.abs(want)), np.abs(got - want) / np.abs(want)
    assert got[-1] < 0.9 * got[0]
    for out in port[1:]:
        assert torch.equal(out["w"], port[0]["w"])
        assert torch.equal(out["losses"], port[0]["losses"])
    w = port[0]["w"].numpy()
    assert np.abs(w - ref["w"]).max() <= 1e-5 * np.abs(ref["w"]).max()
