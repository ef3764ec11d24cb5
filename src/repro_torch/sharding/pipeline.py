"""GPipe-style pipeline parallelism over a mesh axis.

The model is split into S equal stages whose params are stacked on a leading
stage dim.  A microbatched forward sweeps the classic GPipe wavefront: at
tick t, stage s processes microbatch (t - s); hidden states hop
stage->stage by point-to-point send/recv.  The whole schedule is
differentiable: each hop is an ``autograd.Function`` whose backward sends
the gradient the other way, so ``backward()`` runs the reverse wavefront.

Bubble fraction = (S-1)/(M+S-1), the standard GPipe trade; pick M >= 4·S.

Port of the JAX package's ``sharding/pipeline.py`` (``shard_map`` +
``ppermute`` + ``psum``) over the process group of the mesh axis: each rank
is the stage of its group rank and runs every tick as the reference's scan
does (an inactive tick's output masked to zeros, so every rank's graph
holds every hop and the ranks' backward hops pair up in tick order).  The
last stage's outputs are replicated to every stage, as the reference's
``psum`` does; their backward hands each rank's own cotangent to the last
stage, so the loss on top must be computed alike on every rank (replicated),
as in the reference.  ``remat`` is ``torch.utils.checkpoint`` of the stage.
"""
from __future__ import annotations

from typing import Any, Callable

import torch
import torch.distributed as dist

from repro_torch import pytree
from repro_torch.sharding.collectives import ordered_allreduce, sendrecv

__all__ = ["pipeline_forward", "split_stages"]


def split_stages(stacked_layer_params: Any, n_stages: int) -> Any:
    """(L, ...) stacked layer params -> (S, L/S, ...) stage-stacked."""
    def r(x):
        L = x.shape[0]
        if L % n_stages != 0:
            raise ValueError(f"{L} layers not divisible by {n_stages} stages")
        return x.reshape((n_stages, L // n_stages) + tuple(x.shape[1:]))
    return pytree.tree_map(r, stacked_layer_params)


class _Hop(torch.autograd.Function):
    """Stage s sends its output to s + 1 and receives s - 1's (a ring: what
    stage 0 receives is never read); the gradient goes the other way."""

    @staticmethod
    def forward(ctx, x, group, s, S):
        ctx.args = (group, s, S)
        return sendrecv(x, (s + 1) % S, (s - 1) % S, group)

    @staticmethod
    def backward(ctx, g):
        group, s, S = ctx.args
        return sendrecv(g.contiguous(), (s - 1) % S, (s + 1) % S, group), None, None, None


class _FromLast(torch.autograd.Function):
    """The last stage's outputs on every stage (the others hold zeros: a
    sum over the group); backward: each rank's cotangent, taken as the
    replicated output's, goes to the last stage."""

    @staticmethod
    def forward(ctx, outs, group, last):
        ctx.last = last
        return ordered_allreduce(outs, group)

    @staticmethod
    def backward(ctx, g):
        return (g if ctx.last else torch.zeros_like(g)), None, None


def pipeline_forward(stage_fn: Callable, stage_params: Any, x: torch.Tensor,
                     mesh, axis: str = "model",
                     n_microbatches: int = 8, remat: bool = True) -> torch.Tensor:
    """Run ``y = stages(x)`` through the pipeline.

    stage_fn(stage_params_slice, h) -> h', applied by each stage to the
    hidden state (of one shape throughout); ``stage_params`` are
    stage-stacked ``(S, L/S, ...)`` (:func:`split_stages`), whole on every
    rank, each rank reading its stage's slice; x: (B, ...) with
    B % n_microbatches == 0, the same on every rank.  Returns the output on
    every rank of the axis."""
    S = mesh.size(mesh.mesh_dim_names.index(axis))
    M = n_microbatches
    B = x.shape[0]
    if B % M != 0:
        raise ValueError(f"batch {B} % microbatches {M} != 0")
    mb = B // M
    xs = x.reshape((M, mb) + tuple(x.shape[1:]))
    group = mesh.get_group(axis)
    s = dist.get_rank(group)
    params = pytree.tree_map(lambda p: p[s], stage_params)

    def body(p, h):
        if remat:
            return torch.utils.checkpoint.checkpoint(stage_fn, p, h, use_reentrant=False)
        return stage_fn(p, h)

    first = torch.tensor(s == 0, device=x.device)
    last = torch.tensor(s == S - 1, device=x.device)
    buf = torch.zeros_like(xs[0])
    outs = []
    for t in range(M + S - 1):
        active = torch.tensor(0 <= t - s < M, device=x.device)
        inp = torch.where(first, xs[min(t, M - 1)], buf)
        out = torch.where(active, body(params, inp), torch.zeros_like(inp))
        if t >= S - 1:
            # the last stage finishes microbatch t - (S - 1)
            outs.append(torch.where(last, out, torch.zeros_like(out)))
        if t < M + S - 2:
            buf = _Hop.apply(out, group, s, S)
    return _FromLast.apply(torch.stack(outs), group, s == S - 1).reshape(
        (B,) + tuple(x.shape[1:]))
