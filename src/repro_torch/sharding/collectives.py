"""Collectives over one mesh dimension, mirroring the paper's reduction
patterns across devices.

``tree_allreduce`` is the cross-device form of the paper's GEADD binary
tree (Alg. 3 / Fig. 7): a recursive-doubling butterfly, log2(n) rounds,
each an exchange with the partner ``rank ^ stride`` combined by
``kernels.ops.geadd`` (on the card the GEADD kernel, its operands from two
devices).  ``ring_allreduce`` is the sequential accumulation baseline of
paper Table I, n - 1 ring steps.  ``quantized_allreduce`` sends int8 (one
all-reduce MAX for the scale, one all-reduce SUM of int32), the
bandwidth-bound path of a slow axis.  ``all_gather`` concatenates each
rank's leading-axis slice in rank order: what a sharded batch's small
per-element outputs (status words, ``FactorInfo``, log-determinants) and a
distributed factor's partitions are gathered by; with ``dim=`` it
concatenates along another axis (a sharded parameter gathered to full,
``sharding/partition.py``).  ``ordered_allreduce`` sums every rank's
tensor in group-rank order, so every rank ends with the same bits (a
data-parallel gradient's mean, ``launch/train.py``): an ``all_to_all`` of
chunks, each summed by one rank, then an ``all_gather`` of the sums.

Every function takes the ``ProcessGroup`` of a mesh dimension
(``mesh.get_group(axis)``, ``launch/mesh.py``), the counterpart of an axis
name inside ``shard_map``.  The transport follows the group's backend
(``torch.distributed.get_backend(group)``): on ``nccl`` a CUDA tensor goes
device to device; on ``gloo`` a CUDA tensor is staged through pinned host
memory, explicitly, and a CPU tensor goes as it is.  Nothing is chosen by
catching an error, and nothing falls back from one backend to the other:
a CPU tensor on an NCCL group raises.  A group of the ``fake`` backend (the
dry run's world, ``launch/mesh.py::fake_world``) has its own transport: each
call appends ``{"op", "dtype", "shape", "group"}`` (the result's shape, the
group's size) to :data:`fake_records` and returns zeros of the result's
shape, moving no data; a real group never reaches it.  The butterfly's adds commute, so
every rank ends with the same bits.  On the card ``ops.geadd`` is the
GEADD kernel, which takes ``(..., t, t)`` tiles (the corner's Schur
partials are such); on the CPU its plain version takes any shape.

Port of the JAX package's ``sharding/collectives.py``.
"""
from __future__ import annotations

import math
from typing import List

import torch
import torch.distributed as dist

from repro_torch.kernels import ops

__all__ = ["tree_allreduce", "ring_allreduce", "quantized_allreduce", "all_gather",
           "all_to_all", "ordered_allreduce", "sendrecv", "fake_records"]

# what the fake transport was asked to move, in call order (the dry run's
# collective bytes, launch/dryrun.py)
fake_records: List[dict] = []


def _fake(group) -> bool:
    """Whether ``group`` is of the ``fake`` backend, whose transport only
    records."""
    return dist.get_backend(group) == "fake"


def _record(op: str, x: torch.Tensor, shape, group) -> torch.Tensor:
    """The fake transport: record the call and return zeros of the
    result's ``shape``."""
    fake_records.append({"op": op, "dtype": str(x.dtype).replace("torch.", ""),
                         "shape": tuple(int(d) for d in shape),
                         "group": dist.get_world_size(group)})
    return x.new_zeros(tuple(shape))


def _staged(x: torch.Tensor, group) -> bool:
    """Whether ``x`` crosses ``group`` through host memory: a CUDA tensor
    on a gloo group.  A CPU tensor on an NCCL group is refused, and so is
    any other backend (the fake one is taken before this)."""
    backend = dist.get_backend(group)
    if backend == "nccl":
        if not x.is_cuda:
            raise ValueError("an NCCL group exchanges CUDA tensors; got one on "
                             f"{x.device}")
        return False
    if backend == "gloo":
        return x.is_cuda
    raise ValueError(f"no transport for backend {backend!r} (want 'nccl' or 'gloo')")


def _host(x: torch.Tensor) -> torch.Tensor:
    """A pinned host copy of a CUDA tensor (the copy waits for it)."""
    h = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
    h.copy_(x)
    return h


def sendrecv(x: torch.Tensor, send_to: int, recv_from: int, group) -> torch.Tensor:
    """Send ``x`` to group rank ``send_to`` and return what group rank
    ``recv_from`` sends (a tensor of ``x``'s shape), in one batched
    point-to-point exchange."""
    if _fake(group):
        return _record("collective-permute", x, x.shape, group)
    staged = _staged(x, group)
    wire = _host(x) if staged else x.contiguous()
    got = torch.empty_like(wire)
    ops_ = [dist.P2POp(dist.isend, wire, dist.get_global_rank(group, send_to), group),
            dist.P2POp(dist.irecv, got, dist.get_global_rank(group, recv_from), group)]
    for req in dist.batch_isend_irecv(ops_):
        req.wait()
    return got.to(x.device) if staged else got


def _all_reduce(x: torch.Tensor, op, group) -> torch.Tensor:
    if _fake(group):
        return _record("all-reduce", x, x.shape, group)
    staged = _staged(x, group)
    wire = _host(x) if staged else x.clone()
    dist.all_reduce(wire, op=op, group=group)
    return wire.to(x.device) if staged else wire


def tree_allreduce(x: torch.Tensor, group) -> torch.Tensor:
    """Butterfly (recursive-doubling) all-reduce over ``group``: log2(n)
    rounds of pairwise exchange with the partner ``rank ^ stride``, each
    combined by ``ops.geadd`` — the GEADD tree of Alg. 3 where each
    GEADD's operands sit on different devices.  The group's size must be a
    power of two (all production meshes here are); every rank returns the
    same bits."""
    n = dist.get_world_size(group)
    if n & (n - 1):
        raise ValueError(f"tree_allreduce needs power-of-two axis, got {n}")
    me = dist.get_rank(group)
    for r in range(int(math.log2(n))):
        partner = me ^ (1 << r)
        x = ops.geadd(x, sendrecv(x, partner, partner, group))
    return x


def ring_allreduce(x: torch.Tensor, group) -> torch.Tensor:
    """Naive ring all-reduce (n - 1 rounds, each a step around the ring
    and one ``ops.geadd``): the *sequential accumulation* baseline of
    paper Table I, for the tree-against-sequential comparison.  Ranks add
    in different orders, so their bits may differ."""
    n = dist.get_world_size(group)
    me = dist.get_rank(group)
    acc, buf = x, x
    for _ in range(n - 1):
        buf = sendrecv(buf, (me + 1) % n, (me - 1) % n, group)
        acc = ops.geadd(acc, buf)
    return acc


def quantized_allreduce(x: torch.Tensor, group, bits: int = 8) -> torch.Tensor:
    """All-reduce with per-tensor integer quantization on the wire: one
    all-reduce MAX of ``max|x|`` for the shared scale, then an all-reduce
    SUM of the ``bits``-bit codes as int32 (exact for a group of up to
    2**23 ranks).  The dequantized sum is exact up to quantization noise;
    callers keep an error-feedback residual."""
    qmax = float(2 ** (bits - 1) - 1)
    amax = _all_reduce(x.abs().max().reshape(1), dist.ReduceOp.MAX, group)[0]
    scale = amax / qmax + 1e-30
    q = torch.clamp(torch.round(x / scale), -qmax, qmax).to(torch.int8)
    total = _all_reduce(q.to(torch.int32), dist.ReduceOp.SUM, group)
    return total.to(x.dtype) * scale


def all_gather(x: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """Every rank's ``x`` concatenated along ``dim`` (the leading axis by
    default) in group-rank order (each rank's ``x`` of one shape); a bool
    tensor travels as uint8."""
    n = dist.get_world_size(group)
    if n == 1:
        return x
    if _fake(group):
        shape = list(x.shape)
        shape[dim] *= n
        return _record("all-gather", x, shape, group)
    staged = _staged(x, group)
    wire = x.to(torch.uint8) if x.dtype == torch.bool else x
    wire = _host(wire) if staged else wire.contiguous()
    parts: List[torch.Tensor] = [torch.empty_like(wire) for _ in range(n)]
    dist.all_gather(parts, wire, group=group)
    out = torch.cat(parts, dim=dim)
    if staged:
        out = out.to(x.device)
    return out.to(torch.bool) if x.dtype == torch.bool else out


def all_to_all(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` cut into n equal leading-axis blocks, block i sent to group
    rank i; returns the n blocks received, concatenated in group-rank
    order (a tensor of ``x``'s shape)."""
    if _fake(group):
        return _record("all-to-all", x, x.shape, group)
    staged = _staged(x, group)
    wire = _host(x) if staged else x.contiguous()
    got = torch.empty_like(wire)
    dist.all_to_all_single(got, wire, group=group)
    return got.to(x.device) if staged else got


def ordered_allreduce(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of every rank's ``x`` over ``group``, every element added
    in group-rank order, so every rank holds the same bits whatever the
    backend's reduction order.  A reduce-scatter done by hand: ``x``,
    flattened and padded to n equal chunks, goes through
    :func:`all_to_all`, each rank sums the n copies of its chunk in rank
    order, and :func:`all_gather` returns the summed chunks to every rank.
    Each rank sends and receives about two copies of ``x`` and holds about
    two more while it runs, whatever the group's size."""
    n = dist.get_world_size(group)
    if n == 1:
        return x
    flat = x.reshape(-1)
    c = -(-flat.numel() // n)
    if c * n != flat.numel():
        flat = torch.cat([flat, flat.new_zeros(c * n - flat.numel())])
    rows = all_to_all(flat, group).reshape(n, c)
    mine = rows[0]
    for i in range(1, n):
        mine = mine + rows[i]
    del rows
    return all_gather(mine, group)[:x.numel()].reshape(x.shape)
