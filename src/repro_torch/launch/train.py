"""Training driver: the train step and the fault-tolerant loop.

Port of the JAX package's ``launch/train.py``.  ``python -m
repro_torch.launch.train --arch qwen2-7b --steps 100 [--device cpu]``
trains a (reduced or full) model on synthetic Markov data with AdamW or the
sTiles arrowhead-preconditioned optimizer, on the card unless asked for the
CPU, over the world this process belongs to, every rank on the mesh's
``data`` axis (a world of one when none is initialized:
``launch/mesh.py::local_world``).

The step runs eagerly: the loss and its gradient by autograd, the
gradient clipped, preconditioned (arrowhead) and applied by AdamW in
place.  The arrowhead factorization runs on refresh steps only (``step %
precond_every == 0``) and the previous factor is kept otherwise; the
reference computes it every step under ``jit`` and selects it with
``jnp.where``, which gives the same results with more launches.

With ``rules`` (``sharding/partition.py``) the step is sharded by
:func:`shard_train_step`'s state shardings and split by the rules' split
context (``sharding/split.py``), the reference's GSPMD step done by hand
(eager autograd and the hand-written kernels are outside any sharding
propagation):

* state: the parameters and AdamW's ``m``/``v`` are this rank's blocks by
  ``rules.param_shardings``; the step, the count and the arrowhead's
  statistics and factor are replicated;
* compute: the loss of this rank's block of the global batch by
  ``rules.batch_specs``, the model given the split context as
  ``constrain=``: each layer gathered over the data-parallel axes inside
  the layer loop and freed after it (under ``remat="full"`` gathered again
  in the backward), the attention, MLP, experts, embedding and loss split
  over ``model`` (TP, SP, EP; the SSD mixer whole, the one exception);
* gradients: a sharded leaf's gradient leaves its layer as this rank's
  block by the ordered reduce-scatter; a leaf replicated over a data-parallel axis is
  summed over it in group-rank order (``sharding/collectives.py::
  ordered_allreduce``, ``data`` then ``pod``; a leaf ``model`` replicates
  and a rank uses in part was summed over ``model`` inside the backward);
  all are divided by the data-parallel size, so replicated leaves are the
  same bits on every rank; the global norm is the ranks' partial sums
  added over the mesh (``optim/adamw.py::global_norm``); the arrowhead
  sketches from the blocks that own its coordinates and lifts into them;
* update: each rank applies AdamW to its own blocks.

Nothing of the state is written before the preconditioned gradient exists,
as without rules.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import tempfile
from typing import Any, Dict, Optional, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import configs, pytree
from repro_torch.checkpoint.checkpointer import Checkpointer
from repro_torch.configs.base import ModelConfig, RunConfig
from repro_torch.core.ctsf import resolve_device
from repro_torch.data.synthetic import MarkovStream
from repro_torch.models.registry import get_model
from repro_torch.optim.adamw import (AdamWState, adamw_init, adamw_update,
                                     clip_by_global_norm, cosine_lr)
from repro_torch.optim.arrowhead import ArrowheadPrecond, build_precond
from repro_torch.runtime.fault_tolerance import TrainLoop
from repro_torch.sharding.collectives import ordered_allreduce
from repro_torch.sharding.partition import (NamedSharding, Rules, make_rules, shard_tensor,
                                            shard_tree, spec_axes)
from .mesh import local_world, make_local_mesh

__all__ = ["TrainState", "make_train_step", "shard_train_step", "init_state",
           "reduce_config", "train", "main"]


@dataclasses.dataclass
class TrainState:
    """Fields in the reference's pytree order (so a checkpoint of either
    package names the same arrays): the parameters, AdamW's state, the step
    (a 0-d int32 tensor on the CPU) and the arrowhead's statistics and
    factor (None without it)."""
    params: Any
    opt: AdamWState
    step: torch.Tensor
    precond: Optional[Dict[str, torch.Tensor]] = None   # arrowhead stats
    factor: Optional[Dict[str, torch.Tensor]] = None    # arrowhead factor


def _params_device(params) -> torch.device:
    return pytree.leaves(params)[0].device


def attach_precond(state: TrainState, precond: ArrowheadPrecond) -> TrainState:
    """Zero arrowhead statistics on the parameters' device and their
    factor (A = damping·I)."""
    state.precond = precond.init_state(_params_device(state.params))
    state.factor = precond.factorize(state.precond)
    return state


def init_state(gen: torch.Generator, cfg: ModelConfig, run: RunConfig, max_seq: int = 0,
               precond: Optional[ArrowheadPrecond] = None) -> TrainState:
    """Random parameters from ``gen`` (on its device) and fresh optimizer
    state."""
    params = get_model(cfg).init(gen, cfg, max_seq)
    state = TrainState(params=params, opt=adamw_init(params),
                       step=torch.zeros((), dtype=torch.int32))
    return attach_precond(state, precond) if precond is not None else state


def _device_batch(batch: Dict[str, Any], device: torch.device) -> Dict[str, torch.Tensor]:
    return {k: torch.as_tensor(v).to(device) for k, v in batch.items()}


def make_train_step(cfg: ModelConfig, run: RunConfig, rules: Optional[Rules] = None,
                    precond: Optional[ArrowheadPrecond] = None,
                    total_steps: int = 10_000):
    """Returns ``train_step(state, batch, shardings=None) -> (state,
    metrics)``, which updates ``state`` in place (its parameters, optimizer
    moments and step; the arrowhead's statistics and factor are replaced).
    Nothing of ``state`` is written before the preconditioned gradient
    exists, so a step that raises before AdamW's update leaves ``state`` as
    it was and ``TrainLoop``'s retry repeats it exactly.  ``batch`` holds
    numpy arrays or tensors (moved to the parameters' device); metrics are
    ``loss`` and ``grad_norm`` (0-d tensors on the device) and ``lr``.

    With ``rules``, ``shardings`` is required (a ``TrainState`` of
    ``NamedSharding``, :func:`shard_train_step`'s), ``state`` holds this
    rank's blocks by it and ``batch`` is the global batch (see the module
    docstring); without, the state and the batch are whole and no
    collective runs."""
    api = get_model(cfg)
    split = rules.split() if rules is not None else None

    def value_and_grad(params, batch, specs):
        leaves = [p.detach().requires_grad_() for p in pytree.leaves(params)]
        tree = pytree.unflatten(params, leaves)
        kw = {} if split is None else {"constrain": split.bind(tree, specs)}
        loss = api.loss(tree, batch, cfg, run, **kw)
        return loss.detach(), torch.autograd.grad(loss, leaves)

    def loss_and_grads(params, batch, specs):
        if run.grad_accum > 1:
            # microbatched gradient accumulation: (B, ...) -> A slices of
            # B/A, one microbatch of activations alive at a time
            a = run.grad_accum
            gsum, lsum = None, torch.zeros((), dtype=torch.float32)
            for i in range(a):
                mb = {k: v.reshape((a, v.shape[0] // a) + tuple(v.shape[1:]))[i]
                      for k, v in batch.items()}
                l, g = value_and_grad(params, mb, specs)
                g = [x.to(torch.float32) for x in g]
                gsum = g if gsum is None else [x + y for x, y in zip(gsum, g)]
                lsum = lsum.to(l.device) + l
            return lsum / a, [x / a for x in gsum]
        loss, g = value_and_grad(params, batch, specs)
        return loss, list(g)

    def dp_sum(loss, grads, specs):
        """The loss and each leaf replicated over a data-parallel axis summed
        over it in rank order (one buffer an axis, innermost ``data``
        first), then everything divided by the data-parallel size."""
        for axis in reversed(rules.ax.dp):
            if rules.sizes[axis] == 1:
                continue
            which = [i for i, sp in enumerate(specs) if axis not in spec_axes(sp)]
            flat = torch.cat([loss.reshape(1).to(torch.float32)]
                             + [grads[i].reshape(-1).to(torch.float32) for i in which])
            flat = ordered_allreduce(flat, rules.mesh.get_group(axis))
            loss, off = flat[0], 1
            for i in which:
                n = grads[i].numel()
                grads[i] = flat[off:off + n].reshape(grads[i].shape).to(grads[i].dtype)
                off += n
        return loss / rules.dp_total, [g / rules.dp_total for g in grads]

    def train_step(state: TrainState, batch, shardings: Optional[TrainState] = None
                   ) -> Tuple[TrainState, Dict]:
        if (rules is None) != (shardings is None):
            raise ValueError("a step made with rules takes shard_train_step's shardings, "
                             "one made without takes none")
        param_sh = None if shardings is None else shardings.params
        specs = None if param_sh is None else pytree.tree_map(lambda sh: sh.spec, param_sh)
        batch = _device_batch(batch, _params_device(state.params))
        if rules is not None:
            batch = {k: shard_tensor(v, NamedSharding(rules.mesh, rules.batch_pspec(v)))
                     for k, v in batch.items()}
        loss, grads = loss_and_grads(state.params, batch, specs)
        if rules is not None and rules.dp_total > 1:
            loss, grads = dp_sum(loss, grads, pytree.leaves(specs))
        grads = pytree.unflatten(state.params, grads)
        grads, gnorm = clip_by_global_norm(grads, run.grad_clip, param_sh)

        step = int(state.step)
        stats = factor = None
        if precond is not None:
            stats = precond.update_stats(state.precond, grads, param_sh)
            factor = (precond.factorize(stats) if step % run.precond_every == 0
                      else state.factor)
            grads = precond.precondition(factor, grads, shardings=param_sh)
            state.precond, state.factor = stats, factor
        lr = cosine_lr(step, run.learning_rate,
                       warmup=max(2, total_steps // 10), total=total_steps)
        adamw_update(grads, state.opt, state.params, lr, weight_decay=run.weight_decay)
        state.step = torch.tensor(step + 1, dtype=torch.int32)
        return state, {"loss": loss, "grad_norm": gnorm, "lr": lr}

    return train_step


def shard_train_step(train_step, mesh, rules: Rules, state: TrainState,
                     batch_template) -> Tuple[Any, TrainState]:
    """The state's shardings (from ``state``'s full shapes) and the step
    bound to them: returns ``(fn, state_shardings)``, ``fn(state, batch)``
    taking the state as this rank's blocks, ``shard_tree(state,
    state_shardings)``, and the global batch, which the step cuts by
    ``rules.batch_specs`` as it comes.  ``batch_template`` is not read: it
    is there only to keep the reference's signature."""
    param_sh = rules.param_shardings(state.params)
    rep = rules.replicated()
    opt_sh = AdamWState(m=param_sh, v=param_sh, count=rep)
    pre_sh = None if state.precond is None else pytree.tree_map(lambda _: rep, state.precond)
    fac_sh = None if state.factor is None else pytree.tree_map(lambda _: rep, state.factor)
    state_sh = TrainState(param_sh, opt_sh, rep, pre_sh, fac_sh)

    def fn(state, batch):
        return train_step(state, batch, state_sh)

    return fn, state_sh


# ---------------------------------------------------------------------------
# CLI driver
# ---------------------------------------------------------------------------

def reduce_config(cfg: ModelConfig, layers: int = 4, d_model: int = 256,
                  vocab: int = 512) -> ModelConfig:
    """Scale an assigned architecture down to laptop size, preserving family
    structure (used by smoke tests and the quickstart examples)."""
    factor = max(1, cfg.d_model // d_model)
    upd = dict(
        n_layers=min(cfg.n_layers, layers), d_model=cfg.d_model // factor,
        d_ff=max(8, cfg.d_ff // factor), vocab=min(cfg.vocab, vocab),
        head_dim=max(8, cfg.hd // factor // 2 * 2),   # rope needs even dims
    )
    if cfg.family in ("ssm", "hybrid"):
        upd["ssm_head_dim"] = max(8, cfg.ssm_head_dim // factor)
        upd["ssm_state"] = min(cfg.ssm_state, 32)
    if cfg.family == "hybrid":
        upd["n_layers"] = cfg.shared_attn_every * max(
            1, min(cfg.n_layers, layers) // cfg.shared_attn_every)
    if cfg.family == "moe":
        upd["n_experts"] = min(cfg.n_experts, 8)
        upd["top_k"] = min(cfg.top_k, 2)
        upd["expert_pad_to"] = 0
    if cfg.family == "encdec":
        upd["encoder_layers"] = min(cfg.encoder_layers, layers)
        upd["encoder_seq"] = min(cfg.encoder_seq, 64)
    if cfg.family == "vlm":
        upd["n_image_tokens"] = min(cfg.n_image_tokens, 8)
    return dataclasses.replace(cfg, **upd)


def default_checkpoint_dir(name: str = "repro_torch_ckpt") -> str:
    return os.path.join(tempfile.gettempdir(), name)


def train(arch: Union[str, ModelConfig], steps: int = 50, batch: int = 8, seq: int = 128,
          optimizer: str = "adamw", reduced: bool = True,
          checkpoint_dir: Optional[str] = None, seed: int = 0,
          log_every: int = 10, injector=None, device=None) -> Dict[str, Any]:
    """Train ``arch`` (an id of ``configs.ARCH_IDS`` or a ``ModelConfig``)
    on synthetic Markov data under ``TrainLoop``."""
    cfg = configs.get(arch) if isinstance(arch, str) else arch
    if reduced:
        cfg = reduce_config(cfg)
    run = RunConfig(optimizer=optimizer, remat="none", loss_chunk=128,
                    checkpoint_every=max(10, steps // 4))
    dev = resolve_device(device)
    state = init_state(torch.Generator(device=dev).manual_seed(seed), cfg, run, max_seq=seq)
    precond = None
    if optimizer == "arrowhead":
        precond = build_precond(state.params, r=run.precond_proj_dim,
                                band=run.precond_band, seed=seed)
        attach_precond(state, precond)
    ckpt = Checkpointer(checkpoint_dir or default_checkpoint_dir(), keep=2)
    stream = MarkovStream(cfg.vocab, seed=seed)

    def batch_fn(step):
        return stream.batch(step, batch, seq, _extras(cfg, batch))

    with local_world():
        # every rank of the world on data (the reference's one device is
        # the world of one)
        mesh = make_local_mesh(data=dist.get_world_size())
        rules = make_rules(mesh, cfg, run)
        step_fn = make_train_step(cfg, run, rules, precond, total_steps=steps)
        sharded_step, state_sh = shard_train_step(step_fn, mesh, rules, state, batch_fn(0))
        loop = TrainLoop(step_fn=sharded_step, batch_fn=batch_fn, checkpointer=ckpt,
                         checkpoint_every=run.checkpoint_every, state_shardings=state_sh,
                         injector=injector, log_every=log_every)
        final = loop.run(shard_tree(state, state_sh), 0, steps)
    losses = [float(m["loss"]) for m in loop.history]
    return {"state": final, "losses": losses, "loop": loop, "precond": precond,
            "entropy_floor": stream.entropy_floor, "cfg": cfg, "run": run}


def _extras(cfg, batch):
    extras = {}
    if cfg.family == "vlm":
        extras["image_embeds"] = np.zeros(
            (batch, cfg.n_image_tokens, cfg.d_model), np.float32)
    if cfg.family == "encdec":
        extras["frame_embeds"] = np.random.default_rng(0).standard_normal(
            (batch, cfg.encoder_seq, cfg.d_model)).astype(np.float32)
    return extras


def main(argv=None):
    p = argparse.ArgumentParser(description="Train a model of the repo's configs on "
                                            "synthetic Markov data.")
    p.add_argument("--arch", default="qwen2-7b", choices=configs.ARCH_IDS)
    p.add_argument("--steps", type=int, default=50)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--seq", type=int, default=128)
    p.add_argument("--optimizer", default="adamw",
                   choices=["adamw", "arrowhead"])
    p.add_argument("--full", action="store_true",
                   help="use the full (not reduced) architecture config")
    p.add_argument("--checkpoint-dir", default=None,
                   help="default: repro_torch_ckpt in the temporary directory")
    p.add_argument("--device", default=None, help="torch device (default: cuda:0)")
    args = p.parse_args(argv)
    out = train(args.arch, steps=args.steps, batch=args.batch, seq=args.seq,
                optimizer=args.optimizer, reduced=not args.full,
                checkpoint_dir=args.checkpoint_dir, device=args.device)
    print(f"first loss {out['losses'][0]:.4f} -> last {out['losses'][-1]:.4f} "
          f"(markov entropy floor {out['entropy_floor']:.4f})")
    return out


if __name__ == "__main__":
    main()
