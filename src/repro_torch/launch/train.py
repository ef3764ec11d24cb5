"""Training driver: the train step and the fault-tolerant loop.

Port of the JAX package's ``launch/train.py`` on one device, no sharding
(``rules=None``; ``shard_train_step`` and ``make_rules`` wait for
``sharding/partition.py``).  ``python -m repro_torch.launch.train --arch
qwen2-7b --steps 100 [--device cpu]`` trains a (reduced or full) model on
synthetic Markov data with AdamW or the sTiles arrowhead-preconditioned
optimizer, on the card unless asked for the CPU.

The step runs eagerly: the loss and its gradient by autograd, the
gradient clipped, preconditioned (arrowhead) and applied by AdamW in
place.  The arrowhead factorization runs on refresh steps only (``step %
precond_every == 0``) and the previous factor is kept otherwise; the
reference computes it every step under ``jit`` and selects it with
``jnp.where``, which gives the same results with more launches.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import tempfile
from typing import Any, Dict, Optional, Tuple, Union

import numpy as np
import torch

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

__all__ = ["TrainState", "make_train_step", "init_state", "reduce_config", "train", "main"]


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


def make_train_step(cfg: ModelConfig, run: RunConfig, rules=None,
                    precond: Optional[ArrowheadPrecond] = None,
                    total_steps: int = 10_000):
    """Returns ``train_step(state, batch) -> (state, metrics)``, which
    updates ``state`` in place (its parameters, optimizer moments and step;
    the arrowhead's statistics and factor are replaced).  Nothing of
    ``state`` is written before the preconditioned gradient exists, so a
    step that raises before AdamW's update leaves ``state`` as it was and
    ``TrainLoop``'s retry repeats it exactly.  ``batch`` holds numpy arrays
    or tensors (moved to the parameters' device); metrics are ``loss`` and
    ``grad_norm`` (0-d tensors on the device) and ``lr``."""
    if rules is not None:
        raise NotImplementedError("sharded training needs sharding/partition.py, which is "
                                  "not ported yet")
    api = get_model(cfg)

    def value_and_grad(params, batch):
        leaves = [p.detach().requires_grad_() for p in pytree.leaves(params)]
        loss = api.loss(pytree.unflatten(params, leaves), batch, cfg, run)
        return loss.detach(), torch.autograd.grad(loss, leaves)

    def train_step(state: TrainState, batch) -> Tuple[TrainState, Dict]:
        batch = _device_batch(batch, _params_device(state.params))
        if run.grad_accum > 1:
            # microbatched gradient accumulation: (B, ...) -> A slices of
            # B/A, one microbatch of activations alive at a time
            a = run.grad_accum
            gsum, lsum = None, torch.zeros((), dtype=torch.float32)
            for i in range(a):
                mb = {k: v.reshape((a, v.shape[0] // a) + tuple(v.shape[1:]))[i]
                      for k, v in batch.items()}
                l, g = value_and_grad(state.params, mb)
                g = [x.to(torch.float32) for x in g]
                gsum = g if gsum is None else [x + y for x, y in zip(gsum, g)]
                lsum = lsum.to(l.device) + l
            grads = pytree.unflatten(state.params, [x / a for x in gsum])
            loss = lsum / a
        else:
            loss, g = value_and_grad(state.params, batch)
            grads = pytree.unflatten(state.params, list(g))
        grads, gnorm = clip_by_global_norm(grads, run.grad_clip)

        step = int(state.step)
        if precond is not None:
            stats = precond.update_stats(state.precond, grads)
            factor = (precond.factorize(stats) if step % run.precond_every == 0
                      else state.factor)
            grads = precond.precondition(factor, grads)
            state.precond, state.factor = stats, factor

        lr = cosine_lr(step, run.learning_rate,
                       warmup=max(2, total_steps // 10), total=total_steps)
        adamw_update(grads, state.opt, state.params, lr, weight_decay=run.weight_decay)
        state.step = torch.tensor(step + 1, dtype=torch.int32)
        return state, {"loss": loss, "grad_norm": gnorm, "lr": lr}

    return train_step


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
    step_fn = make_train_step(cfg, run, None, precond, total_steps=steps)

    ckpt = Checkpointer(checkpoint_dir or default_checkpoint_dir(), keep=2)
    stream = MarkovStream(cfg.vocab, seed=seed)

    def batch_fn(step):
        return stream.batch(step, batch, seq, _extras(cfg, batch))

    loop = TrainLoop(step_fn=step_fn, batch_fn=batch_fn, checkpointer=ckpt,
                     checkpoint_every=run.checkpoint_every,
                     injector=injector, log_every=log_every)
    final = loop.run(state, 0, steps)
    losses = [float(m["loss"]) for m in loop.history]
    return {"state": final, "losses": losses, "loop": loop, "precond": precond,
            "entropy_floor": stream.entropy_floor, "cfg": cfg, "run": run}


def _extras(cfg, batch):
    extras = {}
    if cfg.family == "vlm":
        extras["image_embeds"] = np.zeros(
            (batch, cfg.n_image_tokens, cfg.d_model), np.float32)
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
