"""The port's ``sharding/collectives.py`` on gloo worlds of 1, 2, 3 and 4
ranks (``launch/mesh.py::run_local``, the plain ``geadd`` on the CPU):
``tree_allreduce``, ``ring_allreduce``, ``quantized_allreduce``,
``all_gather``, ``all_to_all`` and ``ordered_allreduce`` against numpy on
the same seeded rows, the tree and the ordered sum bit for bit the same on
every rank; at world 4 each against the JAX package's
collectives on 4 forced XLA CPU devices (one ``tests/_mdev.py`` subprocess
for the file) within 1e-6.  A world spawns once for all its checks."""
import json

import numpy as np
import pytest
import torch

import _torch_ranks
from _mdev import run_multidevice
from repro_torch.launch.mesh import run_local

WORLDS = [1, 2, 3, 4]
DATA = np.random.default_rng(0).standard_normal((4, 5)).astype(np.float32)
QDATA = np.random.default_rng(1).standard_normal((4, 64)).astype(np.float32)

_REFERENCE = f"""
import json
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P
from jax.experimental.shard_map import shard_map
from repro.sharding.collectives import tree_allreduce, ring_allreduce, quantized_allreduce
mesh = Mesh(np.array(jax.devices()), ("x",))
data = jnp.asarray(np.array({DATA.tolist()!r}, np.float32))
qdata = jnp.asarray(np.array({QDATA.tolist()!r}, np.float32))
def run(fn, x):
    try:
        sm = shard_map(lambda v: fn(v, "x"), mesh=mesh, in_specs=P("x"), out_specs=P("x"),
                       check_vma=False)
    except TypeError:
        sm = shard_map(lambda v: fn(v, "x"), mesh=mesh, in_specs=P("x"), out_specs=P("x"),
                       check_rep=False)
    return np.asarray(jax.jit(sm)(x)).tolist()
print(json.dumps({{"tree": run(tree_allreduce, data), "ring": run(ring_allreduce, data),
                  "quantized": run(quantized_allreduce, qdata)}}))
"""


@pytest.fixture(scope="module")
def reference():
    """The JAX package's collectives on 4 devices: a row a device."""
    out = run_multidevice(_REFERENCE, n_devices=4)
    return {k: np.asarray(v, np.float32) for k, v in json.loads(out.splitlines()[-1]).items()}


@pytest.fixture(scope="module")
def ranks():
    """Each world's ranks' results, one spawn a world."""
    return {w: run_local(_torch_ranks.collectives, torch.from_numpy(DATA[:w]),
                         torch.from_numpy(QDATA[:w]), world_size=w, timeout=120)
            for w in WORLDS}


@pytest.mark.parametrize("world", [1, 2, 4])
def test_tree_allreduce_sums_and_every_rank_has_the_same_bits(ranks, world):
    want = DATA[:world].sum(axis=0)
    outs = ranks[world]
    for o in outs:
        np.testing.assert_allclose(o["tree"].numpy(), want, rtol=1e-6, atol=1e-6)
        assert torch.equal(o["tree"], outs[0]["tree"])
        # log2(world) geadd a rank, the plain version's on the CPU
        assert o["launches"] == ({"geadd": world.bit_length() - 1} if world > 1 else {})


@pytest.mark.parametrize("world", WORLDS)
def test_ring_allreduce_sums(ranks, world):
    want = DATA[:world].sum(axis=0)
    for o in ranks[world]:
        np.testing.assert_allclose(o["ring"].numpy(), want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("world", WORLDS)
def test_quantized_allreduce_within_quantization_noise(ranks, world):
    want = QDATA[:world].sum(axis=0)
    for o in ranks[world]:
        err = np.abs(o["quantized"].numpy() - want).max() / np.abs(want).max()
        assert err < 0.02, err       # the reference's int8 noise bound


@pytest.mark.parametrize("kind", ["tree", "ring", "quantized"])
def test_world_of_four_matches_the_reference(ranks, reference, kind):
    for r, o in enumerate(ranks[4]):
        np.testing.assert_allclose(o[kind].numpy(), reference[kind][r], rtol=1e-6, atol=1e-6)


def test_tree_allreduce_refuses_a_world_that_is_not_a_power_of_two(ranks):
    for o in ranks[3]:
        assert o["tree_error"] == "ValueError: tree_allreduce needs power-of-two axis, got 3"


def test_tree_allreduce_over_each_axis_of_a_two_by_two_mesh(ranks):
    # ranks (data, model): 0 (0, 0), 1 (0, 1), 2 (1, 0), 3 (1, 1)
    for r, o in enumerate(ranks[4]):
        np.testing.assert_allclose(o["tree_model"].numpy(), DATA[r & 2] + DATA[(r & 2) + 1],
                                   rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(o["tree_data"].numpy(), DATA[r & 1] + DATA[(r & 1) + 2],
                                   rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("world", WORLDS)
def test_all_gather_stacks_the_ranks_in_order(ranks, world):
    for o in ranks[world]:
        assert torch.equal(o["gather"], torch.from_numpy(DATA[:world]))
        assert torch.equal(o["gather_bool"], torch.from_numpy(DATA[:world] > 0))


@pytest.mark.parametrize("world", WORLDS)
def test_all_to_all_sends_block_i_to_rank_i(ranks, world):
    for r, o in enumerate(ranks[world]):
        want = np.concatenate([[100 * i + 2 * r, 100 * i + 2 * r + 1] for i in range(world)])
        assert torch.equal(o["to_all"], torch.from_numpy(want.astype(np.float32)))


@pytest.mark.parametrize("world", WORLDS)
def test_ordered_allreduce_adds_in_rank_order_on_every_rank(ranks, world):
    # 5 elements: worlds 3 and 4 pad the chunks
    want = DATA[0]
    for i in range(1, world):
        want = want + DATA[i]
    for o in ranks[world]:
        assert torch.equal(o["ordered"], torch.from_numpy(want))


def test_ordered_allreduce_on_a_fake_world_records_its_two_collectives():
    from repro_torch.launch.mesh import fake_world, make_local_mesh
    from repro_torch.sharding import collectives
    collectives.fake_records.clear()
    with fake_world(8):
        group = make_local_mesh(8, 1).get_group("data")
        out = collectives.ordered_allreduce(torch.ones(3, 7), group)
    assert out.shape == (3, 7)
    # 21 elements padded to 8 chunks of 3
    assert collectives.fake_records == [
        {"op": "all-to-all", "dtype": "float32", "shape": (24,), "group": 8},
        {"op": "all-gather", "dtype": "float32", "shape": (24,), "group": 8}]
    collectives.fake_records.clear()
