"""The port's dry run (``launch/dryrun.py``) and the registry's
``input_specs`` / ``supports_shape``: every (arch × shape) cell's input
stand-ins (shapes and dtypes) and skip reason equal the JAX package's;
``collective_bytes`` on records built from the reference test's HLO lines
(``tests/test_train_serve_e2e.py::test_collective_bytes_parser``) gives its
numbers; ``python -m repro_torch.launch.dryrun --arch mamba2-1.3b --shape
long_500k --no-extrapolate`` on the CPU (the reference test's cell) exits
0 with status ok, under 16 GiB a device as the reference test asks, the
reference's record keys, and argument bytes equal to the reference rules'
shard bytes of that cell on the 16 × 16 mesh (parameters, caches, the
token and the position, from one ``tests/_mdev.py`` subprocess with 256
forced devices, ``jax.eval_shape``); the qwen2-7b decode_32k cell, whose
batch ``data`` cuts, exits 0 too, with the reference rules' shard bytes
from the same subprocess and under 4 GiB a device; a dense train cell at
one layer runs the split step, its per-device FLOPs within 25 % of the
split's count from the shapes, as the first and as the last rank of a
``model`` group; and so does mamba2-1.3b's train cell at one layer, the
SSD mixer on the rank's sequence block; command-r-plus-104b's train cell at 2
layers (``dryrun_cell(layers=2)``) holds at most 4 whole-sequence copies of
the stream beyond its arguments and saved layer inputs (the split's ends
and blocks cut); with ``parts`` a cell's peak is the sum of its parts."""
import json
import os
import subprocess
import sys

import pytest

from _mdev import REPO, run_multidevice
from repro.configs.base import SHAPES as JSHAPES
from repro.models import registry as jregistry
from repro import configs as jconfigs
from repro_torch import configs
from repro_torch.configs.base import SHAPES
from repro_torch.launch.dryrun import collective_bytes
from repro_torch.models.registry import input_specs, supports_shape

_SHARD_BYTES = """
import numpy as np, jax
from jax.sharding import Mesh
from repro import configs
from repro.configs.base import RunConfig, SHAPES
from repro.models.registry import get_model, input_specs
from repro.sharding.partition import make_rules
mesh = Mesh(np.array(jax.devices()).reshape(16, 16), ("data", "model"))
def nbytes(tree, shardings):
    return sum(int(np.prod(s.shard_shape(x.shape))) * x.dtype.itemsize
               for x, s in zip(jax.tree.leaves(tree), jax.tree.leaves(shardings)))
for arch, shape_name in CELLS:
    cfg, shape = configs.get(arch), SHAPES[shape_name]
    rules = make_rules(mesh, cfg, RunConfig(), shape)
    api = get_model(cfg)
    params = jax.eval_shape(lambda k: api.init(k, cfg, shape.seq_len), jax.random.PRNGKey(0))
    caches = jax.eval_shape(lambda: api.init_cache(cfg, shape.global_batch, shape.seq_len))
    spec = input_specs(cfg, shape)
    total = (nbytes(params, rules.param_shardings(params))
             + nbytes(caches, rules.cache_shardings(caches))
             + nbytes(spec["token"], rules.batch_specs(spec["token"]))
             + nbytes(spec["pos"], rules.replicated()))
    print("BYTES", arch, shape_name, total)
"""
# the decode cells the CLI tests run, their argument bytes by the reference's
# rules computed in one subprocess
DECODE_CELLS = [("mamba2-1.3b", "long_500k"), ("qwen2-7b", "decode_32k")]


@pytest.fixture(scope="module")
def shard_bytes():
    stdout = run_multidevice(_SHARD_BYTES.replace("CELLS", repr(DECODE_CELLS)), n_devices=256)
    out = {}
    for line in stdout.splitlines():
        if line.startswith("BYTES"):
            _, arch, shape, n = line.split()
            out[(arch, shape)] = int(n)
    return out


def _run_cli(tmp_path, arch, shape):
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch,
         "--shape", shape, "--no-extrapolate", "--out", str(tmp_path)],
        env=env, capture_output=True, text=True, timeout=600, cwd=REPO)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    with open(tmp_path / f"{arch}_{shape}_single.json") as f:
        return json.load(f)


@pytest.mark.parametrize("arch", configs.ARCH_IDS)
def test_input_specs_and_supports_shape_equal_the_reference(arch):
    cfg, jcfg = configs.get(arch), jconfigs.get(arch)
    for name in SHAPES:
        assert supports_shape(cfg, SHAPES[name]) == jregistry.supports_shape(jcfg, JSHAPES[name])
        got, want = input_specs(cfg, SHAPES[name]), jregistry.input_specs(jcfg, JSHAPES[name])
        assert got.keys() == want.keys()
        for k in want:
            assert tuple(got[k].shape) == tuple(want[k].shape), (name, k)
            assert str(got[k].dtype).replace("torch.", "") == str(want[k].dtype), (name, k)
            assert got[k].device.type == "meta"


def test_collective_bytes_of_the_reference_test_lines():
    # %ar f32[1024,16] all-reduce, groups [4,4]; %ag bf16[512] all-gather,
    # [8,2]; %rs f32[8] reduce-scatter, [2,8]; %ags (f32[64]) all-gather-start,
    # [1,4]; %cp f32[4] collective-permute (no groups: 1); the -done and the
    # add carry no bytes
    records = [
        {"op": "all-reduce", "dtype": "float32", "shape": (1024, 16), "group": 4},
        {"op": "all-gather", "dtype": "bfloat16", "shape": (512,), "group": 2},
        {"op": "reduce-scatter", "dtype": "float32", "shape": (8,), "group": 8},
        {"op": "all-gather", "dtype": "float32", "shape": (64,), "group": 4},
        {"op": "collective-permute", "dtype": "float32", "shape": (4,), "group": 1},
    ]
    out = collective_bytes(records)
    assert out["all-reduce"] == 1024 * 16 * 4
    assert out["all-gather"] == 512 * 2 / 2 + 64 * 4 / 4
    assert out["reduce-scatter"] == 8 * 4 * 8
    assert out["collective-permute"] == 4 * 4
    assert out["total"] == sum(v for k, v in out.items() if k != "total")


def test_dryrun_cell_on_the_cpu(tmp_path, shard_bytes):
    rec = _run_cli(tmp_path, "mamba2-1.3b", "long_500k")
    assert rec["status"] == "ok"
    assert rec["mesh"] == "16x16"
    assert rec["rank"] == 15            # the last rank of the first model group
    assert rec["memory"]["total_per_device_gib"] < 16.0
    assert rec["memory"]["argument_bytes"] == shard_bytes[("mamba2-1.3b", "long_500k")]
    for key in ("argument_bytes", "output_bytes", "temp_bytes", "alias_bytes"):
        assert rec["memory"][key] >= 0
    assert rec["cost_scanned"]["flops"] > 0 and rec["cost_scanned"]["bytes"] > 0
    # decode gathers each layer's blocks over data (FSDP), one layer at a time
    assert rec["collectives_scanned"]["all-gather"] > 0


def test_dense_decode_cell_runs_on_the_blocks(tmp_path, shard_bytes):
    """qwen2-7b decode_32k: the batch of 128 cut over ``data``, the K/V
    caches' sequence over ``model`` (flash decoding): ``status ok``, the
    argument bytes the reference rules' blocks, under 4 GiB a device."""
    rec = _run_cli(tmp_path, "qwen2-7b", "decode_32k")
    assert rec["status"] == "ok"
    assert rec["memory"]["argument_bytes"] == shard_bytes[("qwen2-7b", "decode_32k")]
    assert rec["memory"]["total_per_device_gib"] < 4.0
    # the row max of the flash-decoding softmax, combined over model
    assert rec["collectives_scanned"]["all-reduce"] > 0


def _split_flops(cfg, shape, run, tp, dp, rank=0):
    """The split train step's FLOPs on one rank of a dense model, counted
    from the shapes: every matmul a forward, a recompute (remat "full") and
    a backward of two (input and weight) on this rank's share (its
    sequence block of the projections, its column blocks of the MLP, its
    vocabulary block of the loss, whose chunks recompute their logits
    too); the flash blocks this rank's causal queries visit, 2 products
    each forward and again in the recompute, 5 in the backward."""
    B, S = shape.global_batch // dp, shape.seq_len
    T = B * S
    D, H, KV, hd, F, V = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd, cfg.d_ff,
                          cfg.vocab_padded)
    dense = 2 * T / tp * (D * (2 * H + 2 * KV) * hd + 3 * D * F) * cfg.n_layers
    sb = S // tp
    qc, kc = min(run.q_chunk, sb), min(run.kv_chunk, S)
    visited = sum(1 for qi in range(sb // qc) for ki in range(S // kc)
                  if ki * kc <= qi * qc + rank * sb + qc - 1)
    flash = 2 * B * H * qc * kc * hd * visited * cfg.n_layers
    loss = 2 * T * D * V / tp
    return 4 * dense + 9 * flash + 4 * loss


@pytest.mark.parametrize("rank", [0, 15])
def test_dense_train_cell_at_one_layer_splits_the_flops(rank):
    """qwen2-7b at its published widths cut to one layer, train_4k on the
    16 × 16 mesh of a fake world of 256, as the first and as the last rank
    of a ``model`` group (the first and the last sequence block: causal
    queries visit 1 and 4 key blocks, the dry run's own rank being the
    last): the per-device FLOPs within 25 % of that rank's split count from
    the shapes, and nothing near the whole step's (16 times that, and
    more)."""
    import dataclasses
    from repro_torch.configs.base import RunConfig
    from repro_torch.launch.dryrun import _run_cell
    from repro_torch.launch.mesh import fake_world, make_production_mesh
    from repro_torch.sharding.partition import make_rules
    cfg = dataclasses.replace(configs.get("qwen2-7b"), n_layers=1)
    shape, run = SHAPES["train_4k"], RunConfig()
    with fake_world(256, rank=rank):
        rules = make_rules(make_production_mesh(), cfg, run, shape)
        got = _run_cell(cfg, shape, run, rules, "cpu")
    want = _split_flops(cfg, shape, run, tp=16, dp=16, rank=rank)
    assert abs(got["flops"] - want) <= 0.25 * want, (got["flops"], want)


def _ssm_split_flops(cfg, shape, run, tp, dp):
    """The split train step's FLOPs on one rank of the attention-free
    Mamba2 model, counted from the shapes, the SSD mixer on this rank's
    sequence block (``run.ssm_head_shard`` off): every matmul a forward, a
    recompute (remat "full") and a backward of two, on the rank's block of
    the projections (``w_in``, ``w_out``) and of the SSD's einsums (the
    chunk's scores and its quadratic output, the chunk states, the carried
    state's output; chunks of ``min(ssd_chunk, S / tp)``), the fold over
    the blocks' states, and the vocabulary block of the loss."""
    B, S = shape.global_batch // dp, shape.seq_len
    sl = S // tp
    T = B * sl
    D, di, G, N, H, P, V = (cfg.d_model, cfg.d_inner, cfg.ssm_groups, cfg.ssm_state,
                            cfg.ssm_heads, cfg.ssm_head_dim, cfg.vocab_padded)
    K = 2 * di + 2 * G * N + H
    Q = min(run.ssd_chunk, sl)
    proj = 2 * T * (D * K + di * D)
    ssd = 2 * T * Q * (G * N + H * P) + 2 * T * H * P * N * 2 + 2 * tp * B * H * P * N
    loss = 2 * B * S * D * V / tp
    return 4 * (proj + ssd) * cfg.n_layers + 4 * loss


def test_ssm_train_cell_at_one_layer_splits_the_flops():
    """mamba2-1.3b at its published widths cut to one layer, train_4k on
    the 16 × 16 mesh of a fake world of 256, as the dry run's rank (the
    last of the first ``model`` group): with ``ssm_head_shard`` off (the
    rules' sequence layout of ``ssm_x``) the per-device FLOPs within 25 %
    of the split count from the shapes, the SSD mixer on the rank's
    sequence block (the layer run on the whole sequence on every
    ``model`` rank reads about four times that at one layer, the loss's
    share unchanged)."""
    import dataclasses
    from repro_torch.configs.base import RunConfig
    from repro_torch.launch.dryrun import _run_cell
    from repro_torch.launch.mesh import fake_world, make_production_mesh
    from repro_torch.sharding.partition import make_rules
    cfg = dataclasses.replace(configs.get("mamba2-1.3b"), n_layers=1)
    shape, run = SHAPES["train_4k"], RunConfig()
    assert not run.ssm_head_shard
    with fake_world(256, rank=15):
        rules = make_rules(make_production_mesh(), cfg, run, shape)
        got = _run_cell(cfg, shape, run, rules, "cpu")
    want = _ssm_split_flops(cfg, shape, run, tp=16, dp=16)
    assert abs(got["flops"] - want) <= 0.25 * want, (got["flops"], want)


# the depth-independent part of a train cell's peak, in copies of one data
# rank's stream whole over the sequence in bf16 (B · S · D · 2 bytes): the
# split holds one such tensor at a time (the lookup's partial sums, the
# stream the loss gathers, or the output gradient a row-parallel block
# gathers) beside a layer's recomputed working set or the loss's vocabulary
# block, its gradient and one chunk's logits; command-r-plus-104b at 2
# layers reads 3.2 copies (9.8 before the split's ends were cut)
FIXED_COPIES = 4


def test_tied_train_cell_holds_few_whole_sequence_copies():
    """command-r-plus-104b (tied embeddings, the widest model) at its
    published widths cut to 2 layers, train_4k as the dry run's rank of a
    fake world of 256: the peak less the arguments and the layers' saved
    inputs (a sequence block each under remat "full") is at most
    FIXED_COPIES whole-sequence copies of the stream."""
    from repro_torch.launch.dryrun import dryrun_cell
    rec = dryrun_cell("command-r-plus-104b", "train_4k", extrapolate=False, verbose=False,
                      device="cpu", layers=2)
    assert rec["status"] == "ok" and rec["layers"] == 2, rec
    cfg, shape = configs.get("command-r-plus-104b"), SHAPES["train_4k"]
    whole = shape.global_batch // 16 * shape.seq_len * cfg.d_model * 2
    mem = rec["memory"]
    fixed = mem["peak_bytes"] - mem["argument_bytes"] - 2 * whole // 16
    assert 0 < fixed <= FIXED_COPIES * whole, fixed / whole


def test_peak_parts_sum_to_the_peak():
    """``dryrun_cell(..., layers=1, parts=True)`` on qwen2-7b train_4k: the
    bytes each part holds at the peak (the arguments under ``args``) add up
    to the peak, the most live while any part ran is the peak, and the
    parts name the port's functions."""
    from repro_torch.launch.dryrun import dryrun_cell
    rec = dryrun_cell("qwen2-7b", "train_4k", extrapolate=False, verbose=False, device="cpu",
                      layers=1, parts=True)
    assert rec["status"] == "ok" and rec["layers"] == 1, rec
    mem = rec["memory"]
    at_peak, reach = mem["parts"]["at_peak"], mem["parts"]["reach"]
    assert sum(at_peak.values()) == mem["peak_bytes"]
    assert at_peak["args"] == mem["argument_bytes"]
    assert max(reach.values()) == mem["peak_bytes"]
    assert all(k.startswith(("fwd ", "bwd ")) for k in reach), sorted(reach)[:5]
    assert any("models/layers.py::" in k for k in at_peak), sorted(at_peak)
