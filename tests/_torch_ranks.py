"""Rank functions of the port's multi-rank tests.

``repro_torch.launch.mesh.run_local`` spawns the ranks, and each rank
imports this module by name to find its function, so it imports nothing
of jax or of the JAX package (a rank starts in a few seconds).  Each
function builds its mesh over the world ``run_local`` set up, runs the
calls under test on this rank's share and returns what the tests compare,
with the kernel launches it made (``runtime/telemetry.py::count_launches``:
on the CPU, the plain versions' calls).
"""
import dataclasses

import torch
import torch.distributed as dist

from repro_torch.core import BandedCTSF, SolverOptions
from repro_torch.core.concurrent import concurrent_factorize, concurrent_logdet, concurrent_selinv
from repro_torch.core.distributed import assemble_factor, distributed_factorize, partition_banded
from repro_torch.launch.mesh import make_local_mesh, make_production_mesh
from repro_torch.runtime.telemetry import count_launches
from repro_torch.sharding.collectives import (all_gather, all_to_all, ordered_allreduce,
                                              quantized_allreduce, ring_allreduce, tree_allreduce)


def _errors(*calls):
    """The message of the exception each call raises (None if it does not)."""
    out = []
    for call in calls:
        try:
            call()
            out.append(None)
        except (ValueError, TypeError) as e:
            out.append(f"{type(e).__name__}: {e}")
    return out


def _on(m, device):
    return BandedCTSF(m.grid, *(x.to(device) for x in m.arrays()))


def collectives(data, qdata, device="cpu"):
    """The collectives on a ``(1, world)`` mesh's ``model`` group, this
    rank's row of ``data`` and ``qdata`` on ``device``; on a world of 4
    also the tree over each axis of a ``(2, 2)`` mesh."""
    rank, world = dist.get_rank(), dist.get_world_size()
    group = make_local_mesh(1, world).get_group("model")
    x = data[rank].to(device)
    out = {"ring": ring_allreduce(x, group),
           "quantized": quantized_allreduce(qdata[rank].to(device), group),
           "gather": all_gather(x[None], group),
           "gather_bool": all_gather((x > 0)[None], group),
           "ordered": ordered_allreduce(x, group),
           "to_all": all_to_all(torch.arange(2 * world, dtype=torch.float32).to(device)
                                + 100 * rank, group)}
    if world & (world - 1):
        out["tree_error"] = _errors(lambda: tree_allreduce(x, group))[0]
    else:
        out["launches"] = count_launches(tree_allreduce, x, group)
        out["tree"] = tree_allreduce(x, group)
    if world == 4:
        mesh = make_local_mesh(2, 2)
        for axis in ("data", "model"):
            out[f"tree_{axis}"] = tree_allreduce(x, mesh.get_group(axis))
    return out


def distributed(m, n_parts, mesh_shape, axis, device="cpu"):
    """``partition_banded(m, n_parts)`` on ``device`` factorized over
    ``axis`` of a mesh of ``mesh_shape`` and assembled on every rank; the
    refusals of a partition count the axis does not divide and of a mesh
    that is not a ``DeviceMesh``."""
    mesh = make_local_mesh(*mesh_shape)
    pm = partition_banded(_on(m, device), n_parts)
    got = {}
    launches = count_launches(lambda: got.update(f=distributed_factorize(pm, mesh, axis)))
    f = got["f"]
    full = assemble_factor(f, m.grid)
    size = dist.get_world_size(mesh.get_group(axis))
    odd = dataclasses.replace(pm, n_parts=size + 1) if size > 1 else None
    return {"Dr": f.Dr, "R": f.R, "C": f.C, "first": f.first, "launches": launches,
            "full": full.ctsf.arrays(),
            "errors": _errors(
                lambda: distributed_factorize(odd, mesh, axis) if odd else None,
                lambda: distributed_factorize(pm, "model", axis))}


def concurrent(batch, faulted, mesh_shape, policies, device="cpu"):
    """The sharded concurrent calls on the ``data`` axis of a mesh of
    ``mesh_shape``, on ``device``, once a policy of ``policies`` (None
    among them for none): ``concurrent_factorize``, ``concurrent_logdet``,
    ``concurrent_selinv`` of the sharded factor and of the whole batched
    one; then ``regularize=True`` on ``faulted`` and the refusals of a
    batch the axis does not divide and of a factor of another axis."""
    mesh = make_local_mesh(*mesh_shape)
    batch, faulted = _on(batch, device), _on(faulted, device)
    out = {"runs": []}
    for policy in policies:
        opts = SolverOptions(policy=policy)
        got = {}
        launches = count_launches(
            lambda: got.update(f=concurrent_factorize(batch, mesh=mesh, options=opts)))
        f = got["f"]
        whole = concurrent_factorize(batch, options=opts)
        out["runs"].append({
            "offset": f.offset, "factor": f.ctsf.arrays(), "status": f.status,
            "source_grid": f.source_grid, "logdet": concurrent_logdet(f), "launches": launches,
            "sigma": concurrent_selinv(f, mesh=mesh, options=opts).arrays(),
            "sigma_whole": concurrent_selinv(whole, mesh=mesh, options=opts).arrays()})
    ff = concurrent_factorize(faulted, mesh=mesh, options=SolverOptions(regularize=True))
    i = ff.info
    out["faulted"] = {"offset": ff.offset, "status": ff.status, "factor": ff.ctsf.arrays(),
                      "info": (i.status, i.attempts, i.tau, i.min_pivot, i.first_bad_tile)}
    three = BandedCTSF(batch.grid, *(x[:3] for x in batch.arrays()))
    out["errors"] = _errors(lambda: concurrent_factorize(three, mesh=mesh),
                            lambda: concurrent_selinv(f, mesh=mesh, axis="model"))
    return out


def meshes():
    """This rank's place on a ``(1, world)`` mesh, a CPU tensor of its own,
    and the refusals of meshes of another size than the world."""
    world = dist.get_world_size()
    mesh = make_local_mesh(1, world)
    return {"rank": dist.get_rank(), "model": dist.get_rank(mesh.get_group("model")),
            "tensor": torch.full((2,), float(dist.get_rank())),
            "errors": _errors(lambda: make_local_mesh(world, 2),
                              lambda: make_production_mesh())}


def fail_on(rank):
    """Rank ``rank`` raises; the others wait at a barrier it never reaches."""
    if dist.get_rank() == rank:
        raise RuntimeError(f"rank {rank} fails on purpose")
    dist.barrier()


def strand_peers():
    """Rank 0 waits at an all-reduce that no other rank joins."""
    if dist.get_rank() == 0:
        dist.all_reduce(torch.ones(1))


# ---------------------------------------------------------------------------
# the distributed-training path (optim/compress.py, runtime/dp_compressed.py,
# sharding/partition.py and pipeline.py, launch/train.py with rules,
# checkpoint/checkpointer.py's sharded save and elastic restore)
# ---------------------------------------------------------------------------

def compress(grads, ef, params0, batch, steps):
    """``ef_compress_allreduce`` of this rank's row of ``grads`` and ``ef``
    over the ``data`` axis of a ``(world, 1)`` mesh, then ``steps`` steps
    of ``make_compressed_dp_step`` on a least-squares loss from
    ``params0`` on the global ``batch``."""
    from repro_torch.optim.adamw import adamw_init
    from repro_torch.optim.compress import ef_compress_allreduce
    from repro_torch.runtime.dp_compressed import make_compressed_dp_step
    rank, world = dist.get_rank(), dist.get_world_size()
    mesh = make_local_mesh(world, 1)
    mean, new_ef = ef_compress_allreduce({k: v[rank] for k, v in grads.items()},
                                         {k: v[rank] for k, v in ef.items()},
                                         mesh.get_group("data"))

    def loss_fn(params, b):
        return torch.mean((b["x"] @ params["w"] - b["y"]) ** 2)

    params = {"w": params0.clone()}
    step, ef_init_fn = make_compressed_dp_step(loss_fn, mesh, axis="data", lr=0.05)
    state = (params, adamw_init(params), ef_init_fn(params))
    losses = []
    for _ in range(steps):
        state, m = step(state, batch)
        losses.append(m["loss"])
    return {"mean": mean, "ef": new_ef, "losses": torch.stack(losses), "w": state[0]["w"],
            "ef_dp": state[2]["w"]}


def _sharded_run(cfg, run, params, optimizer, mesh_shape):
    from repro_torch.launch.train import (TrainState, attach_precond, make_train_step,
                                          shard_train_step)
    from repro_torch.optim.adamw import adamw_init
    from repro_torch.optim.arrowhead import build_precond
    from repro_torch.sharding.partition import make_rules
    from repro_torch import pytree
    mesh = make_local_mesh(*mesh_shape)
    rules = make_rules(mesh, cfg, run)
    # a copy of the launcher's tensors (the spawned ranks share their
    # memory), since the step updates the state in place
    params = pytree.tree_map(torch.clone, params)
    state = TrainState(params, adamw_init(params), torch.zeros((), dtype=torch.int32))
    precond = None
    if optimizer == "arrowhead":
        precond = build_precond(params, r=run.precond_proj_dim, band=run.precond_band, seed=0)
        attach_precond(state, precond)
    step = make_train_step(cfg, run, rules, precond, total_steps=10)
    return mesh, rules, state, step, precond


def _flat(state):
    from repro_torch import pytree
    return dict(pytree.leaves_with_path(state))


def sharded_train(cfg, run, params, batches, optimizers, mesh_shape, ckpt_dir=None,
                  save_after=None):
    """For each optimizer: ``make_train_step(rules=)`` through
    ``shard_train_step`` on a mesh of ``mesh_shape`` from the full
    ``params`` over ``batches``; this rank's blocks of the state after
    every step (by path), the metrics, the blocks' placements; with
    ``ckpt_dir`` a sharded save after ``save_after`` steps (the first
    optimizer's run), in the writer thread while the steps go on, waited
    for at the end, and the same state saved synchronously into
    ``ckpt_dir + "_sync"`` by a checkpointer of its own."""
    from repro_torch import pytree
    from repro_torch.checkpoint.checkpointer import Checkpointer
    from repro_torch.launch.train import shard_train_step
    from repro_torch.sharding.partition import shard_tree
    out = {}
    ckpt = Checkpointer(ckpt_dir) if ckpt_dir is not None else None
    for i, opt in enumerate(optimizers):
        mesh, rules, state, step, _ = _sharded_run(cfg, run, params, opt, mesh_shape)
        fn, sh = shard_train_step(step, mesh, rules, state, batches[0])
        state = shard_tree(state, sh)
        states, metrics = [], []
        for s, b in enumerate(batches):
            if ckpt_dir is not None and i == 0 and s == save_after:
                ckpt.save(s, state, shardings=sh)
                Checkpointer(ckpt_dir + "_sync", async_save=False).save(s, state, shardings=sh)
            state, m = fn(state, b)
            states.append({k: v.clone() for k, v in _flat(state).items()})
            metrics.append({"loss": m["loss"], "grad_norm": m["grad_norm"]})
        out[opt] = {"states": states, "metrics": metrics, "placements": {
            p: tuple(str(x) for x in s.placements) for p, s in pytree.leaves_with_path(sh)}}
    if ckpt is not None:
        ckpt.wait()
    return out


def train_world(cfg, steps, ckpt_dir):
    """``launch/train.py::train`` of ``cfg`` (as it is) on this world
    (every rank on ``data``) on the CPU, checkpointing into ``ckpt_dir``:
    the losses and the checkpointed steps."""
    from repro_torch.checkpoint.checkpointer import Checkpointer
    from repro_torch.launch.train import train
    out = train(cfg, steps=steps, batch=4, seq=32, reduced=False, checkpoint_dir=ckpt_dir,
                device="cpu", log_every=0)
    return {"losses": torch.tensor(out["losses"], dtype=torch.float64),
            "steps": Checkpointer(ckpt_dir).all_steps()}


def elastic_restore(cfg, run, params, mesh_shape, ckpt_dir, batch):
    """The latest checkpoint in ``ckpt_dir`` restored onto this rank's
    blocks of a mesh of ``mesh_shape`` (``restore(shardings=)``, through
    ``TrainLoop(state_shardings=)``'s hard-failure path), the target
    placements, then one more step on ``batch``; and that step taken
    straight from the restored state on the same mesh (``straight``)."""
    from repro_torch import pytree
    from repro_torch.checkpoint.checkpointer import Checkpointer
    from repro_torch.launch.train import shard_train_step
    from repro_torch.runtime.fault_tolerance import FailureInjector, TrainLoop
    from repro_torch.sharding.partition import shard_tree
    mesh, rules, template, step, _ = _sharded_run(cfg, run, params, "adamw", mesh_shape)
    fn, sh = shard_train_step(step, mesh, rules, template, batch)
    ckpt = Checkpointer(ckpt_dir, async_save=False)
    restored = ckpt.restore(shard_tree(template, sh), shardings=sh)
    out = {"restored": {k: v.clone() for k, v in _flat(restored).items()},
           "step": int(restored.step),
           "placements": {p: tuple(str(x) for x in s.placements)
                          for p, s in pytree.leaves_with_path(sh)}}
    # a hard failure at the restored step: TrainLoop restores by the
    # shardings and takes the step again
    start = int(restored.step)
    loop = TrainLoop(step_fn=fn, batch_fn=lambda s: batch, checkpointer=ckpt,
                     checkpoint_every=100, max_step_retries=0, state_shardings=sh,
                     injector=FailureInjector({start: 1}), log_every=0,
                     log_fn=lambda msg: None)
    state = loop.run(shard_tree(template, sh), start, 1)
    out["after"] = {k: v.clone() for k, v in _flat(state).items()}
    out["loss"] = loop.history[0]["loss"]
    state, m = fn(ckpt.restore(shard_tree(template, sh), step=start, shardings=sh), batch)
    out["straight"] = {k: v.clone() for k, v in _flat(state).items()}
    out["straight_loss"] = m["loss"]
    return out


def pipeline(ws, x, n_stages, n_microbatches):
    """``pipeline_forward`` of a tanh stack over the ``model`` axis of a
    ``(1, world)`` mesh: the output, and this stage's gradient of
    ``(out ** 2).sum()`` with respect to its slice of the stacked
    weights."""
    from repro_torch.sharding.pipeline import pipeline_forward, split_stages
    mesh = make_local_mesh(1, dist.get_world_size())

    def stage_fn(wstack, h):
        for w in wstack:
            h = torch.tanh(h @ w)
        return h

    w = ws.clone().requires_grad_()
    out = pipeline_forward(stage_fn, split_stages(w, n_stages), x, mesh, axis="model",
                           n_microbatches=n_microbatches)
    (g,) = torch.autograd.grad((out ** 2).sum(), w)
    s = dist.get_rank(mesh.get_group("model"))
    per = ws.shape[0] // n_stages
    return {"out": out.detach(), "grad": g[s * per:(s + 1) * per], "stage": s,
            "grad_elsewhere": torch.cat([g[:s * per], g[(s + 1) * per:]]).abs().max()
            if n_stages > 1 else torch.zeros(())}


# ---------------------------------------------------------------------------
# the split step (sharding/split.py): one step of each case, the meter of
# what a rank holds, FLOPs a rank, reduce_scatter
# ---------------------------------------------------------------------------

def tp_case_config(arch, upd):
    """A case's config: ``arch`` reduced to 2 layers of width 64 and a
    vocabulary of 256, then ``upd``."""
    from repro_torch import configs
    from repro_torch.launch.train import reduce_config
    return dataclasses.replace(reduce_config(configs.get(arch), layers=2, d_model=64, vocab=256),
                               **upd)


def _one_step(cfg, run, params, batch, mesh_shape, mode=None):
    """One sharded step of ``cfg`` from ``params`` on a mesh of
    ``mesh_shape`` (under the context ``mode``, if given): this rank's state
    blocks by path, the metrics, the placements."""
    import contextlib
    from repro_torch import pytree
    from repro_torch.launch.train import (TrainState, make_train_step, shard_train_step)
    from repro_torch.optim.adamw import adamw_init
    from repro_torch.sharding.partition import make_rules, shard_tree
    mesh = make_local_mesh(*mesh_shape)
    rules = make_rules(mesh, cfg, run)
    params = pytree.tree_map(torch.clone, params)
    state = TrainState(params, adamw_init(params), torch.zeros((), dtype=torch.int32))
    fn, sh = shard_train_step(make_train_step(cfg, run, rules, total_steps=10), mesh, rules,
                              state, batch)
    state = shard_tree(state, sh)
    with mode if mode is not None else contextlib.nullcontext():
        state, m = fn(state, batch)
    return ({k: v.clone() for k, v in _flat(state).items()},
            {"loss": m["loss"], "grad_norm": m["grad_norm"]},
            {p: tuple(str(x) for x in s.placements) for p, s in pytree.leaves_with_path(sh)})


def _whole_step(cfg, run, params, batch, mode=None):
    """One step without rules on the whole batch (under the context
    ``mode``, if given): the state by path and the loss."""
    import contextlib
    from repro_torch import pytree
    from repro_torch.launch.train import TrainState, make_train_step
    from repro_torch.optim.adamw import adamw_init
    params = pytree.tree_map(torch.clone, params)
    state = TrainState(params, adamw_init(params), torch.zeros((), dtype=torch.int32))
    step = make_train_step(cfg, run, None, total_steps=10)
    with mode if mode is not None else contextlib.nullcontext():
        state, m = step(state, batch)
    return {k: v.clone() for k, v in _flat(state).items()}, m["loss"]


class _Shapes(torch.utils._python_dispatch.TorchDispatchMode):
    """The shapes of every tensor an operation allocates (views, which
    hold no storage of their own, are not counted), in order."""

    def __init__(self):
        super().__init__()
        self.shapes = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func.is_view:
            return out
        for t in torch.utils._pytree.tree_leaves(out):
            if isinstance(t, torch.Tensor):
                self.shapes.append(tuple(t.shape))
        return out


class _InMamba:
    """The shapes (:class:`_Shapes`) of every operation a Mamba2 layer's
    split forward runs (``models/mamba2.py::_mamba_split``, wrapped for the
    block; a remat's recompute included), in order."""

    def __init__(self):
        self.shapes = []

    def __enter__(self):
        from repro_torch.models import mamba2
        orig = self._orig = mamba2._mamba_split

        def inside(*args, **kwargs):
            mode = _Shapes()
            try:
                with mode:
                    return orig(*args, **kwargs)
            finally:
                self.shapes += mode.shapes
        mamba2._mamba_split = inside
        return self

    def __exit__(self, *exc):
        from repro_torch.models import mamba2
        mamba2._mamba_split = self._orig


def ssd_whole_sequence(cfg, batch, seq):
    """The shapes a Mamba2 layer of ``cfg`` makes over the whole sequence
    of ``seq`` positions for ``batch`` sequences (one chunk of the whole
    sequence): the stream, the projection, the conv's channels, x, dt, B
    and C, the gated norm's input, and the intra-chunk scores, decay and
    cumulative decay."""
    di, g, n, nh, pd = (cfg.d_inner, cfg.ssm_groups, cfg.ssm_state, cfg.ssm_heads,
                        cfg.ssm_head_dim)
    b, s = batch, seq
    return {(b, s, cfg.d_model), (b, s, 2 * di + 2 * g * n + nh), (b, s, di + 2 * g * n),
            (b, s, nh, pd), (b, s, nh), (b, s, g, n), (b, s, di),
            (b, 1, s, s, g), (b, 1, s, s, g, nh // g), (b, 1, s, g, nh // g)}


def tp_cases(cases, inits, batches, whole, meter, flops, rs_data, pieces=()):
    """On a world of 4: each of ``cases`` (name -> (arch, cfg update, mesh
    shape, run fields)) one sharded step from ``inits[name]`` on
    ``batches[name]``; for the names in ``whole`` also the step without
    rules; ``meter`` (a name) again under a dispatch mode recording every
    output's shape; ``flops`` (a name) its FLOPs and the whole step's; the
    names in ``pieces`` again with ``collectives.PIECE_BYTES`` at 64 (every
    piecewise gather, reduce-scatter, lookup and flash block one batch row
    a piece); ``reduce_scatter`` and ``ordered_allreduce`` of this rank's
    row of ``rs_data`` over the world along dimensions 0 and 1."""
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch.configs.base import RunConfig
    from repro_torch.sharding import collectives
    from repro_torch.sharding.collectives import reduce_scatter
    out = {}
    for name, (arch, upd, shape, rupd) in cases.items():
        cfg = tp_case_config(arch, upd)
        run = RunConfig(**dict(dict(compute_dtype="float32", remat="none", loss_chunk=16),
                               **rupd))
        layer = _InMamba()
        blocks, metrics, placements = _one_step(cfg, run, inits[name], batches[name], shape,
                                                layer)
        out[name] = {"blocks": blocks, "metrics": metrics, "placements": placements,
                     "layer_shapes": sorted(set(layer.shapes))}
        if name in whole:
            out[name]["whole"] = _whole_step(cfg, run, inits[name], batches[name])
        if name == meter:
            mode = _Shapes()
            _one_step(cfg, run, inits[name], batches[name], shape, mode)
            out[name]["shapes"] = sorted(set(mode.shapes))
        if name in pieces:
            keep, collectives.PIECE_BYTES = collectives.PIECE_BYTES, 64
            try:
                out[name]["pieces"] = _one_step(cfg, run, inits[name], batches[name], shape)[:2]
            finally:
                collectives.PIECE_BYTES = keep
        if name == flops:
            fc, fw = FlopCounterMode(display=False), FlopCounterMode(display=False)
            _one_step(cfg, run, inits[name], batches[name], shape, fc)
            _whole_step(cfg, run, inits[name], batches[name], fw)
            out[name]["flops"] = (fc.get_total_flops(), fw.get_total_flops())
    mesh = make_local_mesh(1, dist.get_world_size())
    group = mesh.get_group("model")
    x = rs_data[dist.get_rank()]
    out["rs"] = {d: (reduce_scatter(x, group, dim=d), ordered_allreduce(x, group)) for d in (0, 1)}
    # Rules.constrain: a whole (B, S, D) activation laid out as "act"
    from repro_torch.sharding.partition import make_rules
    rules = make_rules(mesh, tp_case_config("qwen2-7b", {}), RunConfig())
    out["constrain"] = {kind: rules.constrain(rs_data[:, :, :4].clone(), kind)
                        for kind in ("act", "qkv")}
    return out


# ---------------------------------------------------------------------------
# prefill and decode under the split (sharding/split.py): a prompt, the
# caches grown to the serving window, greedy decode steps
# ---------------------------------------------------------------------------

def split_serving(cases, inits, batches, window, steps):
    """On a world of 4: each of ``cases`` (name -> (arch, cfg update, mesh
    shape, run fields)) from ``inits[name]`` on ``batches[name]`` split by
    the rules: ``prefill(constrain=)`` on this rank's batch block, the
    caches grown to ``window`` (``launch/serve.py::grow_caches``) and bound,
    then ``steps`` greedy ``decode_step(constrain=)`` calls; the logits of
    every call, the greedy tokens, this rank's cache blocks by path, the
    placements, and the shapes of every tensor the prefill and the decode
    steps made (:class:`_Shapes`)."""
    from repro_torch import pytree
    from repro_torch.configs.base import RunConfig
    from repro_torch.launch.serve import grow_caches
    from repro_torch.models.registry import get_model
    from repro_torch.sharding.partition import make_rules, shard_tree
    out = {}
    for name, (arch, upd, shape, rupd) in cases.items():
        cfg = tp_case_config(arch, upd)
        run = RunConfig(**dict(dict(compute_dtype="float32", remat="none"), **rupd))
        api = get_model(cfg)
        mesh = make_local_mesh(*shape)
        rules = make_rules(mesh, cfg, run)
        params = inits[name]
        blocks = shard_tree(params, rules.param_shardings(params))
        split = rules.split().bind(blocks, rules.param_specs(params))
        batch = shard_tree(batches[name], rules.batch_specs(batches[name]))
        B, S = batches[name]["tokens"].shape
        meta = lambda n: api.init_cache(cfg, B, n, dtype=torch.float32, device="meta")
        src, dst = rules.cache_shardings(meta(S)), rules.cache_shardings(meta(window))
        pre, dec, layer = _Shapes(), _Shapes(), _InMamba()
        with torch.no_grad():
            with layer, pre:
                logits, caches = api.prefill(blocks, batch, cfg, run, constrain=split)
            caches = grow_caches(caches, window, src, dst)
            split.bind(caches, pytree.tree_map(lambda sh: sh.spec, dst))
            tok = torch.argmax(logits, -1)[:, None]
            got, toks = [logits], [tok]
            with dec:
                for i in range(steps):
                    logits, caches = api.decode_step(blocks, caches, tok, S + i, cfg, run,
                                                     constrain=split)
                    tok = torch.argmax(logits, -1)[:, None]
                    got.append(logits)
                    toks.append(tok)
        out[name] = {"logits": got, "tokens": torch.cat(toks, dim=1),
                     "caches": {p: x.clone() for p, x in pytree.leaves_with_path(caches)},
                     "placements": {p: tuple(str(x) for x in s.placements)
                                    for p, s in pytree.leaves_with_path(dst)},
                     "data_rank": dist.get_rank(mesh.get_group("data")),
                     "prefill_shapes": sorted(set(pre.shapes)),
                     "layer_shapes": sorted(set(layer.shapes)),
                     "decode_shapes": sorted(set(dec.shapes))}
    return out


# ---------------------------------------------------------------------------
# the SSD mixer on a sequence split over ``model`` (models/mamba2.py)
# ---------------------------------------------------------------------------

def _seq_split(cfg, shape, seq):
    """The split context of a ``shape`` mesh bound to a stream of ``seq``
    positions (the rules' default sequence sharding, ``ssm_head_shard``
    off)."""
    from repro_torch.configs.base import RunConfig
    from repro_torch.sharding.partition import make_rules
    c = make_rules(make_local_mesh(*shape), cfg, RunConfig(compute_dtype="float32")).split()
    return c.at(seq)


def _leaves(d):
    return {k: torch.from_numpy(v).requires_grad_() for k, v in d.items()}


def ssd_sequence(cfg, cases, inputs):
    """On a world of 4: each of ``cases`` (name -> (mesh shape, S, chunk))
    with ``inputs[name]`` (numpy arrays by name) on this rank's sequence
    block of a split over ``model``: the SSD core (``ssd_chunked`` with
    the split's carry) and the Mamba2 layer (``mamba_apply(constrain=)``,
    its whole parameters on every rank), each with the gradients of the
    sum of its outputs against the inputs' cotangents (the final state's
    term on the last ``model`` rank, the cache blocks' on every rank), and
    the shapes of every tensor the layer's forward and backward made."""
    from repro_torch.models.mamba2 import _SeqCarry, mamba_apply, ssd_chunked
    out = {}
    for name, (shape, seq, chunk) in cases.items():
        c = _seq_split(cfg, shape, seq)
        sl = seq // c.tp
        blk = lambda a: a.narrow(1, c.rank * sl, sl).contiguous()
        inp = inputs[name]
        a = _leaves({k: inp[k] for k in ("x", "dt", "a_log", "b", "c", "d")})
        xs = {k: blk(v) if v.ndim > 1 else v for k, v in a.items()}
        carry = _SeqCarry(c, True)
        y, _ = ssd_chunked(xs["x"], xs["dt"], xs["a_log"], xs["b"], xs["c"], xs["d"],
                           chunk=chunk, carry=carry)
        loss = (y * blk(torch.from_numpy(inp["cy"]))).sum()
        if c.rank == c.tp - 1:
            loss = loss + (carry.final * torch.from_numpy(inp["cs"])).sum()
        loss.backward()
        ssd = {"y": y.detach(), "final": carry.final.detach(),
               "grads": {k: blk(v.grad) if v.ndim > 1 else v.grad for k, v in a.items()}}
        params = {k: torch.from_numpy(v).requires_grad_() for k, v in inp.items()
                  if k.startswith("p/")}
        p = {k[2:]: v for k, v in params.items()}
        p["ln"] = {"scale": p.pop("ln")}
        h = blk(torch.from_numpy(inp["h"])).requires_grad_()
        rec = _Shapes()
        with rec:
            o, (state, tail) = mamba_apply(p, h, cfg, chunk=chunk, return_state=True,
                                           constrain=c)
            hb, cb = state.shape[2], tail.shape[2]
            loss = ((o * blk(torch.from_numpy(inp["co"]))).sum()
                    + (state * torch.from_numpy(inp["cs"]).narrow(2, c.rank * hb, hb)).sum()
                    + (tail * torch.from_numpy(inp["ct"]).narrow(2, c.rank * cb, cb)).sum())
            loss.backward()
        layer = {"out": o.detach(), "state": state.detach(), "tail": tail.detach(),
                 "grads": dict({k: v.grad for k, v in params.items()}, h=h.grad)}
        out[name] = {"rank": c.rank, "tp": c.tp, "ssd": ssd, "layer": layer,
                     "shapes": sorted(set(rec.shapes))}
    return out
