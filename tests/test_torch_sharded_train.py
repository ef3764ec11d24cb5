"""The port's sharded train step (``launch/train.py::make_train_step(rules=)``
through ``shard_train_step``, ``sharding/partition.py``) on a gloo world of
4 ranks, a ``(data 2, model 2)`` mesh, against the JAX package's
``shard_train_step`` on 4 forced XLA CPU devices (one ``tests/_mdev.py``
subprocess for the file): a reduced qwen2-7b (2 layers, d_model 64, vocab
256, float32 compute) from the reference's initialisation, 2 steps of AdamW
and of the arrowhead optimizer on the same Markov batches.  Each rank's
block of every state leaf equals the reference's addressable shard of the
same device position within 1e-5 of the leaf's max, and the losses within
1e-5; two kinds of leaf are held otherwise, in both packages alike: the
attention key bias, whose gradient is zero in exact arithmetic, within the
step's learning rate; the query and value biases, which start at zero and
are one AdamW update after 2 steps, within 1e-4 of max.  Then the elastic restore: the world of 4 saves after 2 steps
(gathered, written by rank 0; in the writer thread and, by another
checkpointer, synchronously, the same arrays), a world of 2 on a ``(data 2, model 1)``
mesh restores it onto its own blocks (equal to the saved arrays, the
placements the target rules'), and ``TrainLoop(state_shardings=)`` takes
step 3 through a hard failure and a restore, bit for bit that mesh's step
3 taken straight from the restored state; against the unbroken world of
4's step 3 it is held by the tolerances of the reference comparison (the
step's compute is split over ``model``, so a mesh with another ``model``
size adds in another order).  Last, ``train()`` called inside a world of 2
runs data-parallel over it."""
import os
import tempfile

import numpy as np
import pytest
import torch

import _torch_ranks
from _mdev import run_multidevice
from repro_torch import configs, pytree
from repro_torch.configs.base import RunConfig
from repro_torch.data import MarkovStream
from repro_torch.launch import train as T
from repro_torch.launch.mesh import fake_world, make_local_mesh, run_local
from repro_torch.models.convert import params_from_numpy
from repro_torch.sharding.partition import make_rules

OPTS = ("adamw", "arrowhead")
STEPS = 3                  # the reference runs 2; the port's third is the restore's
RUN = dict(compute_dtype="float32", remat="none", loss_chunk=16, precond_proj_dim=8,
           precond_every=2)


# the learning rate of the one update in 2 steps (step 0's is 0 in the
# warm-up), which bounds the key bias; the query and value biases start at
# zero, so after one AdamW update lr·m/(√v + eps) they are the elementwise
# ratio at its most sensitive where a gradient element is near eps
LR1 = 1.5e-4 * (1 + 1e-6)
BIAS_RTOL = 1e-4


def _cfg():
    return T.reduce_config(configs.get("qwen2-7b"), layers=2, d_model=64, vocab=256)


_REFERENCE = """
import numpy as np, jax
from jax.sharding import Mesh
from repro import configs
from repro.checkpoint.checkpointer import _flatten
from repro.configs.base import RunConfig
from repro.data.synthetic import MarkovStream
from repro.launch import train as T
from repro.optim.arrowhead import build_precond
from repro.sharding.partition import make_rules
cfg = T.reduce_config(configs.get("qwen2-7b"), layers=2, d_model=64, vocab=256)
run = RunConfig(compute_dtype="float32", remat="none", loss_chunk=16, precond_proj_dim=8,
                precond_every=2)
mesh = Mesh(np.array(jax.devices()).reshape(2, 2), ("data", "model"))
rules = make_rules(mesh, cfg, run)
key = jax.random.PRNGKey(0)
stream = MarkovStream(cfg.vocab, seed=0)
batches = [stream.batch(s, 4, 16) for s in range(2)]
out = {}
for opt in ("adamw", "arrowhead"):
    pre = None
    if opt == "arrowhead":
        shapes = jax.eval_shape(lambda k: T.get_model(cfg).init(k, cfg, 16), key)
        pre = build_precond(shapes, r=8, band=2, seed=0)
    state = T.init_state(key, cfg, run, 16, pre)
    if opt == "adamw":
        for k, v in _flatten(state.params).items():
            out["init/" + k] = np.asarray(v)
    fn, _ = T.shard_train_step(T.make_train_step(cfg, run, rules, pre, total_steps=10),
                               mesh, rules, state, batches[0])
    with mesh:
        for s, b in enumerate(batches):
            state, m = fn(state, b)
            out[f"{opt}/loss/{s}"] = np.asarray(m["loss"])
    for k, leaf in _flatten(state).items():
        for i, d in enumerate(mesh.devices.flat):
            shard = [x for x in leaf.addressable_shards if x.device == d][0]
            out[f"{opt}/{i}/{k}"] = np.asarray(shard.data)
np.savez(OUT, **out)
print("OK")
"""


def _nest(flat):
    """Nested dicts from ``{"a/b/c": leaf}``."""
    out = {}
    for path, leaf in flat.items():
        *head, last = path.split("/")
        node = out
        for k in head:
            node = node.setdefault(k, {})
        node[last] = leaf
    return out


@pytest.fixture(scope="module")
def runs():
    with tempfile.TemporaryDirectory(prefix="repro_torch_sharded_") as tmp:
        path = os.path.join(tmp, "ref.npz")
        run_multidevice(_REFERENCE.replace("OUT", repr(path)), n_devices=4)
        with np.load(path) as f:
            ref = dict(f)
        cfg, run = _cfg(), RunConfig(**RUN)
        params = params_from_numpy(_nest({k[len("init/"):]: v for k, v in ref.items()
                                          if k.startswith("init/")}))
        stream = MarkovStream(cfg.vocab, seed=0)
        batches = [stream.batch(s, 4, 16) for s in range(STEPS)]
        ckpt = os.path.join(tmp, "ckpt")
        four = run_local(_torch_ranks.sharded_train, cfg, run, params, batches, OPTS, (2, 2),
                         ckpt, 2, world_size=4)
        two = run_local(_torch_ranks.elastic_restore, cfg, run, params, (2, 1), ckpt,
                        batches[2], world_size=2)
        yield {"ref": ref, "four": four, "two": two, "params": params, "cfg": cfg, "run": run,
               "ckpt": ckpt}


def _close(got, want, rtol):
    got = got.detach().cpu().numpy().astype(np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    scale = np.abs(want).max() or 1.0
    err = np.abs(got - want).max() / scale
    assert err <= rtol, err


@pytest.mark.parametrize("opt", OPTS)
def test_each_rank_block_equals_the_reference_shard(runs, opt):
    ref, four = runs["ref"], runs["four"]
    for rank, out in enumerate(four):
        state = out[opt]["states"][1]            # after 2 steps
        for path, block in state.items():
            want = ref[f"{opt}/{rank}/{path}"]
            name = path.split("/")[-1]
            if name == "bk":
                # zero gradient in exact arithmetic (softmax ignores a key
                # bias): its moments and its update are rounding noise in
                # both packages, bounded by the step's learning rate
                assert tuple(block.shape) == want.shape
                if path.startswith("0/"):
                    assert float(block.abs().max()) <= LR1 and np.abs(want).max() <= LR1
                continue
            _close(block, want, BIAS_RTOL if name in ("bq", "bv") and path.startswith("0/")
                   else 1e-5)
        for s in range(2):
            _close(out[opt]["metrics"][s]["loss"], ref[f"{opt}/loss/{s}"], 1e-5)


@pytest.mark.parametrize("opt", OPTS)
def test_replicated_leaves_and_metrics_are_the_same_bits_on_every_rank(runs, opt):
    four = runs["four"]
    for out in four[1:]:
        for s in range(STEPS):
            assert torch.equal(out[opt]["metrics"][s]["loss"], four[0][opt]["metrics"][s]["loss"])
            assert torch.equal(out[opt]["metrics"][s]["grad_norm"],
                               four[0][opt]["metrics"][s]["grad_norm"])
        placements = out[opt]["placements"]
        for path, block in out[opt]["states"][-1].items():
            if all(p == "R" for p in placements.get(path, ("R",))):
                assert torch.equal(block, four[0][opt]["states"][-1][path]), path


def _block(full, placements, coords, mesh=(2, 1)):
    """The block of ``full`` a rank at ``coords`` of a mesh of shape
    ``mesh`` holds by ``placements`` (one tensor dimension a mesh
    dimension at most, as the rules give them)."""
    for md, p in enumerate(placements):
        if p.startswith("S("):
            d = int(p[2:-1])
            n = full.shape[d] // mesh[md]
            full = full.narrow(d, coords[md] * n, n)
    return full


def _full(four, opt, step, path):
    """A leaf assembled from the world of 4's blocks after ``step`` steps."""
    placements = four[0][opt]["placements"][path]
    blocks = {divmod(r, 2): four[r][opt]["states"][step - 1][path] for r in range(4)}
    dims = [int(p[2:-1]) if p.startswith("S(") else None for p in placements]
    rows = []
    for i in range(2):
        row = [blocks[(i, j)] for j in range(2)] if dims[1] is not None else [blocks[(i, 0)]]
        rows.append(torch.cat(row, dim=dims[1]) if dims[1] is not None else row[0])
    return torch.cat(rows, dim=dims[0]) if dims[0] is not None else rows[0]


def test_elastic_restore_places_the_saved_arrays_by_the_target_rules(runs):
    four, two = runs["four"], runs["two"]
    with fake_world(2):
        rules = make_rules(make_local_mesh(2, 1), runs["cfg"], runs["run"])
        want = {p: tuple(str(x) for x in s.placements) for p, s in
                pytree.leaves_with_path(rules.param_shardings(runs["params"]))}
    for rank, out in enumerate(two):
        assert out["step"] == 2
        for path, block in out["restored"].items():
            full = _full(four, "adamw", 2, path)
            placements = out["placements"][path]
            if path.startswith("0/"):
                assert placements == want[path[2:]], path
            assert torch.equal(block, _block(full, placements, (rank, 0))), path


def test_async_and_synchronous_sharded_saves_write_the_same_arrays(runs):
    ckpt = runs["ckpt"]
    with np.load(os.path.join(ckpt, "step_2", "arrays.npz")) as a, \
            np.load(os.path.join(ckpt + "_sync", "step_2", "arrays.npz")) as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            np.testing.assert_array_equal(a[k], b[k])


# the learning rates of steps 1 and 2 (10 total steps, warm-up 2), which
# bound the key bias after step 3 as LR1 bounds it after step 2
LR12 = (1.5e-4 + 3e-4) * (1 + 1e-6)


def test_train_loop_restores_onto_another_mesh_and_continues_bit_for_bit(runs):
    """On the restored (data 2, model 1) mesh, step 3 through a hard failure
    and ``TrainLoop``'s restore is bit for bit that mesh's step 3 taken
    straight from the restored state: the loss and every block."""
    for out in runs["two"]:
        assert torch.equal(out["loss"], out["straight_loss"])
        assert out["after"].keys() == out["straight"].keys()
        for path, block in out["after"].items():
            assert torch.equal(block, out["straight"][path]), path


def test_restored_step_matches_the_unbroken_world_by_the_reference_tolerances(runs):
    """The restored world's step 3 against the unbroken world of 4's on
    (data 2, model 2), by the reference comparison's tolerances: the step
    is split over ``model``, and model sizes 1 and 2 add its sums in other
    orders, so the two meshes' bits differ."""
    four, two = runs["four"], runs["two"]
    for rank, out in enumerate(two):
        _close(out["loss"], four[0]["adamw"]["metrics"][2]["loss"].numpy(), 1e-5)
        for path, block in out["after"].items():
            want = _block(_full(four, "adamw", 3, path), out["placements"][path],
                          (rank, 0)).numpy()
            name = path.split("/")[-1]
            if name == "bk":
                # as in the reference comparison: rounding noise, bounded
                # by the learning rates of the updates so far
                assert tuple(block.shape) == want.shape
                if path.startswith("0/"):
                    assert float(block.abs().max()) <= LR12 and np.abs(want).max() <= LR12
                continue
            _close(block, want, BIAS_RTOL if name in ("bq", "bv") and path.startswith("0/")
                   else 1e-5)


def test_train_runs_data_parallel_over_the_world_it_is_called_in(tmp_path):
    """``train()`` inside a gloo world of 2 puts both ranks on ``data``:
    every rank has the same losses' bits and the final checkpoint is there
    (a synchronous sharded save; ``sharded_train`` above saves in the
    writer thread).  Against the world of one on the same global batches,
    in ``train()``'s bfloat16 compute, where the two halves' mean loss and
    summed gradient round otherwise than the whole batch's: the losses of
    steps 0-2 (no update, then one at the warm-up's first learning rate)
    within 1e-5; later steps part further as AdamW's updates carry the
    rounding differences into the parameters (2.8e-4 by step 8 on this
    config)."""
    cfg = _cfg()
    one = T.train(cfg, steps=3, batch=4, seq=32, reduced=False, device="cpu",
                  checkpoint_dir=str(tmp_path / "one"), log_every=0)
    two = run_local(_torch_ranks.train_world, cfg, 3, str(tmp_path / "two"), world_size=2)
    for out in two:
        assert torch.equal(out["losses"], two[0]["losses"])
        assert out["steps"] == [3]
    _close(two[0]["losses"], np.asarray(one["losses"]), 1e-5)
