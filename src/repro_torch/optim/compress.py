"""Error-feedback int8 gradient compression for the cross-pod (DCN) axis.

At multi-pod scale the `pod` all-reduce crosses the slow fabric; int8
quantization cuts wire bytes 4× vs f32.  Error feedback (Seide et al. /
EF-SGD) keeps the compression unbiased over time: the residual of each
quantization is added back into the next step's gradient, so the training
trajectory converges to the uncompressed one.

Port of the JAX package's ``optim/compress.py`` over a process group
(``mesh.get_group(axis)``, the counterpart of an axis name inside
``shard_map``); the all-reduce is ``sharding/collectives.py::
quantized_allreduce``.  The arithmetic is the reference's as it stands:
the residual ``x − q·scale`` is taken at this rank's own scale
(``max|x|``), while the wire carries codes at the group's MAX scale.
"""
from __future__ import annotations

from typing import Any, Tuple

import torch
import torch.distributed as dist

from repro_torch import pytree
from repro_torch.sharding.collectives import quantized_allreduce

__all__ = ["ef_init", "ef_compress_allreduce"]


def ef_init(params) -> Any:
    return pytree.tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                                 device=p.device), params)


def ef_compress_allreduce(grads, ef_state, group, bits: int = 8) -> Tuple[Any, Any]:
    """Quantize (grad + residual), all-reduce the codes over ``group``,
    return (mean_grads, new_residuals), each shaped like ``grads``."""
    n = dist.get_world_size(group)

    def one(g, e):
        x = g.to(torch.float32) + e
        qmax = float(2 ** (bits - 1) - 1)
        scale = x.abs().max() / qmax + 1e-30
        q = torch.clamp(torch.round(x / scale), -qmax, qmax)
        new_e = x - q * scale                 # local quantization residual
        total = quantized_allreduce(x, group, bits=bits) / n
        return total.to(g.dtype), new_e

    outs = [one(g, e) for g, e in zip(pytree.leaves(grads), pytree.leaves(ef_state))]
    return (pytree.unflatten(grads, [o[0] for o in outs]),
            pytree.unflatten(grads, [o[1] for o in outs]))
