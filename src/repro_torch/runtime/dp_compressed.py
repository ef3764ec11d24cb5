"""Explicit data-parallel trainer with int8 error-feedback gradient
compression on one mesh axis.

Port of the JAX package's ``runtime/dp_compressed.py``.  The reference's
step is a ``shard_map`` over the axis; here each rank of the axis's
process group (``mesh.get_group(axis)``) runs the step on its slice of the
global batch: parameters replicated, the batch's leading axis cut in
group-rank order (what ``P(axis)`` gives), the loss averaged over the group
(the reference's ``pmean``), the gradients reduced by
``optim/compress.py::ef_compress_allreduce`` (int8 on the wire + error
feedback), clipped and applied by AdamW.  The int32 sum of the codes is
exact, so every rank ends the step with the same bits.
"""
from __future__ import annotations

from typing import Callable

import torch
import torch.distributed as dist

from repro_torch import pytree
from repro_torch.optim.adamw import adamw_update, clip_by_global_norm
from repro_torch.optim.compress import ef_compress_allreduce, ef_init
from repro_torch.sharding.collectives import ordered_allreduce

__all__ = ["make_compressed_dp_step"]


def make_compressed_dp_step(loss_fn: Callable, mesh, axis: str = "data",
                            lr: float = 1e-3, weight_decay: float = 0.0,
                            grad_clip: float = 1.0, bits: int = 8):
    """loss_fn(params, batch) -> scalar.  Returns (step_fn, ef_init_fn).

    step_fn((params, opt_state, ef_state), batch) -> (state', metrics):
    ``batch`` is the global batch (numpy arrays or tensors), cut along its
    leading axis over ``axis``; ``params`` and ``opt_state`` are updated in
    place (``optim/adamw.py``), ``ef_state`` replaced."""
    group = mesh.get_group(axis)

    def local_batch(batch, device):
        n, r = dist.get_world_size(group), dist.get_rank(group)

        def cut(x):
            x = torch.as_tensor(x)
            b = x.shape[0] // n
            return x[r * b:(r + 1) * b].to(device)
        return pytree.tree_map(cut, batch)

    def step(state, batch):
        params, opt, ef = state
        leaves = [p.detach().requires_grad_() for p in pytree.leaves(params)]
        local = local_batch(batch, leaves[0].device)
        loss = loss_fn(pytree.unflatten(params, leaves), local)
        grads = pytree.unflatten(params, list(torch.autograd.grad(loss, leaves)))
        loss = ordered_allreduce(loss.detach(), group) / dist.get_world_size(group)
        grads, ef = ef_compress_allreduce(grads, ef, group, bits=bits)
        grads, gnorm = clip_by_global_norm(grads, grad_clip)
        adamw_update(grads, opt, params, lr, weight_decay=weight_decay)
        return (params, opt, ef), {"loss": loss, "grad_norm": gnorm}

    return step, ef_init
