"""AdamW with global-norm clipping and cosine schedule, over the port's
parameter dicts.

Port of the JAX package's ``optim/adamw.py``: an fp32 first and second
moment for each parameter, the update applied in place under
``torch.no_grad()``.  The step count and the scalar schedule stay on the
host (float32 arithmetic, as the reference's), so a step reads nothing
back from the card.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from repro_torch import pytree

__all__ = ["AdamWState", "adamw_init", "adamw_update", "cosine_lr",
           "global_norm", "clip_by_global_norm"]

_F32 = np.float32


@dataclasses.dataclass
class AdamWState:
    """Fields in the reference's pytree order: ``m``, ``v`` (trees of
    float32 tensors like the parameters) and ``count``, a 0-d int32 tensor
    on the CPU."""
    m: Any
    v: Any
    count: torch.Tensor


def adamw_init(params) -> AdamWState:
    zeros = pytree.tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32), params)
    return AdamWState(m=zeros, v=pytree.tree_map(torch.clone, zeros),
                      count=torch.zeros((), dtype=torch.int32))


def global_norm(tree) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(x.to(torch.float32)))
                          for x in pytree.leaves(tree)))


def clip_by_global_norm(tree, max_norm: float):
    n = global_norm(tree)
    scale = torch.clamp(max_norm / torch.clamp_min(n, 1e-9), max=1.0)
    return pytree.tree_map(lambda x: x * scale, tree), n


def cosine_lr(step, base_lr: float, warmup: int = 100, total: int = 10_000,
              min_frac: float = 0.1) -> float:
    """Linear warmup, then cosine decay to ``min_frac`` of ``base_lr``; a
    float computed in float32 on the host."""
    step = _F32(int(step))
    warm = base_lr * step / max(warmup, 1)
    progress = np.clip((step - warmup) / max(total - warmup, 1), _F32(0.0), _F32(1.0))
    cos = base_lr * (min_frac + (1 - min_frac) * 0.5 * (1 + np.cos(_F32(np.pi) * progress)))
    return float(warm if step < warmup else cos)


def adamw_update(grads, state: AdamWState, params, lr, *, b1=0.9, b2=0.95,
                 eps=1e-8, weight_decay=0.01):
    """One AdamW step, in place: ``params``, ``state.m``, ``state.v`` and
    ``state.count`` are updated and returned as ``(params, state)``."""
    count = int(state.count) + 1
    t = _F32(count)
    bc1 = float(_F32(1.0) - _F32(b1) ** t)
    bc2 = float(_F32(1.0) - _F32(b2) ** t)
    with torch.no_grad():
        for g, m, v, p in zip(pytree.leaves(grads), pytree.leaves(state.m),
                              pytree.leaves(state.v), pytree.leaves(params)):
            g = g.to(torch.float32)
            m.copy_(b1 * m + (1 - b1) * g)
            v.copy_(b2 * v + (1 - b2) * g * g)
            step_dir = (m / bc1) / (torch.sqrt(v / bc2) + eps)
            pf = p.to(torch.float32)
            p.copy_((pf - lr * (step_dir + weight_decay * pf)).to(p.dtype))
    state.count = torch.tensor(count, dtype=torch.int32)
    return params, state
