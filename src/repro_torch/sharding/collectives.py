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
``reduce_scatter`` is its first half: every rank keeps its own block of
the rank-order sum along a dimension, the same bits as ``ordered_allreduce``'s
slice, whatever the group's size.

The split train step (``sharding/split.py``) differentiates through these,
as ``torch.autograd.Function`` pairs whose backward is the forward's
transpose: :func:`all_gather_rs` (all-gather, its gradient reduce-scattered),
:func:`reduce_scatter_ag` (the reverse), :func:`all_reduce_id` (an ordered
all-reduce, the gradient passed through), :func:`identity_ar` (the
reverse: a tensor used in part on every rank, its gradient summed),
:func:`shift` (rank r takes rank r − k's tensor, the gradient sent back:
a sequence block's halo from the blocks before it), and for work every
rank repeats on the same data, :func:`split_ag` (this rank's block, the
gradient all-gathered) and :func:`all_gather_split` (an all-gather, the
gradient cut back to this rank's block).  Every sum among them adds in
group-rank order.  A reduce-scatter along a later dimension than the first
goes in pieces of batch rows of at most :data:`PIECE_BYTES`
(:func:`row_pieces`), so a rank holds one piece's copies beside its
input, not two more copies of the whole; :func:`gather_columns` enters a
sequence block into column-parallel projections without keeping the
gathered sequence; :func:`all_gather_chunks` hands a gathered sequence
out a chunk at a time and sums each chunk's gradient straight into the
blocks that hold it (:func:`reduce_to_blocks`).

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
           "all_to_all", "ordered_allreduce", "reduce_scatter", "all_reduce_max", "sendrecv",
           "PIECE_BYTES", "row_pieces", "reduce_to_blocks", "all_gather_rs", "gather_columns",
           "all_gather_chunks", "reduce_scatter_ag", "all_reduce_id", "identity_ar", "shift",
           "split_ag", "all_gather_split", "fake_records"]

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


def all_to_all(x: torch.Tensor, group, send=None, recv=None) -> torch.Tensor:
    """``x`` cut into n equal leading-axis blocks, block i sent to group
    rank i; returns the n blocks received, concatenated in group-rank
    order (a tensor of ``x``'s shape).  With ``send`` and ``recv`` (n row
    counts each) the blocks are uneven: ``send[i]`` leading rows of ``x``
    go to rank i, in order, and ``recv[i]`` rows come from rank i."""
    rows = x.shape[0] if recv is None else sum(recv)
    shape = (rows,) + tuple(x.shape[1:])
    if _fake(group):
        return _record("all-to-all", x, shape, group)
    staged = _staged(x, group)
    wire = _host(x) if staged else x.contiguous()
    got = torch.empty(shape, dtype=wire.dtype, device=wire.device,
                      pin_memory=staged)
    dist.all_to_all_single(got, wire, output_split_sizes=recv, input_split_sizes=send,
                           group=group)
    return got.to(x.device) if staged else got


def _rank_order_sum(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` (n equal chunks along its flat order) through :func:`all_to_all`,
    and the n received copies of this rank's chunk summed in group-rank
    order: this rank's chunk of the sum, flat."""
    n = dist.get_world_size(group)
    rows = all_to_all(x.reshape(-1), group).reshape(n, -1)
    mine = rows[0]
    for i in range(1, n):
        mine = mine + rows[i]
    return mine


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
    mine = _rank_order_sum(flat, group)
    return all_gather(mine, group)[:x.numel()].reshape(x.shape)


# the most bytes of one piece of batch rows in which the split makes or
# moves a large tensor (``row_pieces``)
PIECE_BYTES = 1 << 28


def row_pieces(rows: int, row_bytes: int):
    """Ranges ``(r0, r1)`` of ``rows`` batch rows of ``row_bytes`` each, at
    most :data:`PIECE_BYTES` a range (at least one row): the pieces in
    which a reduce-scatter along a later dimension, a gathered sequence's
    projections, the vocabulary-parallel lookup and the flash blocks go,
    every row's arithmetic that of the whole batch's."""
    per = max(1, PIECE_BYTES // max(1, row_bytes))
    return [(r, min(r + per, rows)) for r in range(0, rows, per)]


def reduce_scatter(x: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """This rank's block along ``dim`` of the sum of every rank's ``x``
    over ``group`` (``x.shape[dim]`` a multiple of the group's size):
    :func:`ordered_allreduce`'s first half, the n blocks through
    :func:`all_to_all` and added in group-rank order, so a rank holds the
    same bits as the all-reduce's slice.  Each rank sends and receives one
    copy of ``x``; along a later dimension than the first it goes in
    pieces of batch rows (:func:`row_pieces`: each piece's send copy, its
    all-to-all and its block of the sum, then the blocks laid out as the
    whole's), every element the same rank-order sum whatever the pieces."""
    n = dist.get_world_size(group)
    if n == 1:
        return x
    if x.shape[dim] % n:
        raise ValueError(f"reduce_scatter: dimension {dim} of {tuple(x.shape)} does not "
                         f"divide into {n} blocks")
    rows = x.shape[0]
    pieces = (row_pieces(rows, x[0].numel() * x.element_size()) if dim and rows > 1
              else [(0, rows)])
    out = None
    for r0, r1 in pieces:
        front = (x if len(pieces) == 1 else x[r0:r1]).movedim(dim, 0)
        shape = (front.shape[0] // n,) + tuple(front.shape[1:])
        got = _rank_order_sum(front.contiguous(), group).reshape(shape)
        if len(pieces) == 1:
            return got.movedim(0, dim)
        if out is None:     # the pieces' layout: x's dimension 0 second
            out = got.new_empty((shape[0], rows) + shape[2:])
        out[:, r0:r1] = got
    return out.movedim(0, dim)


def reduce_to_blocks(x: torch.Tensor, group, start: int, block: int) -> torch.Tensor:
    """The sum of every rank's ``x`` ``(B, c, ...)`` over ``group``, each
    element added in group-rank order (:func:`reduce_scatter`'s bits), of
    the positions ``[start, start + c)`` of a sequence whose consecutive
    blocks of ``block`` positions the group's ranks hold in rank order:
    this rank's positions of it, sequence-major ``(k, B, ...)`` (``k``
    possibly 0).  One all-to-all of uneven blocks, each rank's rows to the
    rank that holds them, in pieces of batch rows (:func:`row_pieces`)."""
    n, me = dist.get_world_size(group), dist.get_rank(group)
    c = x.shape[1]
    held = [max(0, min(start + c, (j + 1) * block) - max(start, j * block)) for j in range(n)]
    rest = tuple(x.shape[2:])
    out = x.new_empty((held[me], x.shape[0]) + rest)
    row = n * max(held) * math.prod(rest) * x.element_size()
    for r0, r1 in row_pieces(x.shape[0], row):
        front = x[r0:r1].transpose(0, 1).contiguous()
        got = all_to_all(front, group, send=held, recv=[held[me]] * n)
        rows = got.reshape((n, held[me], r1 - r0) + rest)
        mine = rows[0]
        for i in range(1, n):
            mine = mine + rows[i]
        out[:, r0:r1] = mine
    return out


def all_reduce_max(x: torch.Tensor, group) -> torch.Tensor:
    """The elementwise maximum of every rank's ``x`` (exact in any order)."""
    if dist.get_world_size(group) == 1:
        return x
    return _all_reduce(x, dist.ReduceOp.MAX, group)


# ---------------------------------------------------------------------------
# autograd pairs of the split step: each backward is its forward's transpose
# ---------------------------------------------------------------------------

def _block_of(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """This rank's block of ``x`` along ``dim`` (a contiguous copy)."""
    n = dist.get_world_size(group)
    if x.shape[dim] % n:
        raise ValueError(f"dimension {dim} of {tuple(x.shape)} does not divide into {n} "
                         f"blocks")
    b = x.shape[dim] // n
    return x.narrow(dim, dist.get_rank(group) * b, b).contiguous()


class _AllGatherRS(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return all_gather(x, group, dim=dim)

    @staticmethod
    def backward(ctx, g):
        return reduce_scatter(g, ctx.group, dim=ctx.dim), None, None


class _GatherColumns(torch.autograd.Function):
    """``x`` entered whole over ``group`` (all-gathered along ``dim``, or
    ``x`` itself where ``dim`` is None) and multiplied by each of ``ws``:
    Megatron's sequence-parallel entry into column-parallel projections.
    The gathered ``x`` is not kept for the backward (and is made a piece
    of batch rows at a time where the whole would pass
    :data:`PIECE_BYTES`).  The backward sums each projection's input
    gradient over ``group`` on its own (:func:`reduce_scatter`, or
    :func:`ordered_allreduce`) and adds the sums the last projection's
    first, as the reference's partitioned step sums each projection's
    partial, then gathers ``x`` again for the weights' gradients; every
    product is the one autograd takes through ``torch.matmul``."""

    @staticmethod
    def forward(ctx, x, group, dim, *ws):
        ctx.group, ctx.dim = group, dim
        ctx.save_for_backward(x, *ws)
        if dim is None:
            return tuple(torch.matmul(x, w) for w in ws)
        n = dist.get_world_size(group)
        pieces = row_pieces(x.shape[0], x[0].numel() * n * x.element_size())
        if len(pieces) == 1:
            full = all_gather(x, group, dim=dim)
            return tuple(torch.matmul(full, w) for w in ws)
        shape = list(x.shape)
        shape[dim] *= n
        outs = tuple(x.new_empty(shape[:-1] + [w.shape[1]]) for w in ws)
        for r0, r1 in pieces:
            full = all_gather(x[r0:r1], group, dim=dim)
            for o, w in zip(outs, ws):
                o[r0:r1] = torch.matmul(full, w)
        return outs

    @staticmethod
    def backward(ctx, *gs):
        x, *ws = ctx.saved_tensors
        group, dim = ctx.group, ctx.dim
        shape = list(x.shape)
        if dim is not None:
            shape[dim] *= dist.get_world_size(group)
        gs = [g if g is not None else x.new_zeros(shape[:-1] + [w.shape[1]])
              for g, w in zip(gs, ws)]
        dx = None
        for g, w in zip(reversed(gs), reversed(ws)):
            part = g.reshape(-1, g.shape[-1]).mm(w.t()).reshape(g.shape[:-1] + (w.shape[0],))
            part = (ordered_allreduce(part, group) if dim is None
                    else reduce_scatter(part, group, dim=dim))
            dx = part if dx is None else dx + part
        # gathered again only now, not beside the input gradients' sums
        full = x if dim is None else all_gather(x, group, dim=dim)
        f2 = full.reshape(-1, full.shape[-1])
        dws = [f2.t().mm(g.reshape(-1, g.shape[-1])) for g in gs]
        return (dx, None, None, *dws)


class _GatheredChunk(torch.autograd.Function):
    """A chunk of a sequence all-gathered once over ``group`` (``chunk``,
    positions ``[start, start + len)`` of the gather, made without
    autograd), handed to its consumer as it is.  Its gradient is summed
    straight into the ranks whose blocks hold its positions
    (:func:`reduce_to_blocks`) and written into ``acc``, the gradient of
    the block ``x`` that the chunks share; the chunk whose gradient
    completes it returns it (the others return none), so the block's
    gradient is never added to."""

    @staticmethod
    def forward(ctx, x, chunk, group, start, acc):
        ctx.group, ctx.start, ctx.acc, ctx.x_shape = group, start, acc, x.shape
        ctx.chunk_shape = chunk.shape
        return chunk.view_as(chunk)

    @staticmethod
    def backward(ctx, g):
        acc, (B, sb) = ctx.acc, ctx.x_shape[:2]
        if g is None:
            g = torch.zeros(ctx.chunk_shape, dtype=acc["dtype"], device=acc["device"])
        if acc.get("buf") is None:      # sequence-major, the reduce-scatter's layout
            acc["buf"] = g.new_empty((sb, B) + tuple(g.shape[2:]))
        part = reduce_to_blocks(g, ctx.group, ctx.start, sb)
        lo = max(ctx.start - dist.get_rank(ctx.group) * sb, 0)
        acc["buf"][lo:lo + part.shape[0]] = part
        acc["left"] -= 1
        if acc["left"]:
            return None, None, None, None, None
        return acc.pop("buf").transpose(0, 1), None, None, None, None


class _ReduceScatterAG(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return reduce_scatter(x, group, dim=dim)

    @staticmethod
    def backward(ctx, g):
        return all_gather(g.contiguous(), ctx.group, dim=ctx.dim), None, None


class _AllReduceId(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return ordered_allreduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _IdentityAR(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ordered_allreduce(g.contiguous(), ctx.group), None


def _shifted(x: torch.Tensor, group, k: int) -> torch.Tensor:
    """Every rank's ``x`` sent ``k`` ranks up the group (down for a
    negative ``k``) around the ring: rank r returns rank r − k's, or zeros
    where r − k is not a rank of the group."""
    n, r = dist.get_world_size(group), dist.get_rank(group)
    got = sendrecv(x.contiguous(), (r + k) % n, (r - k) % n, group)
    return got if 0 <= r - k < n else torch.zeros_like(got)


class _Shift(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, k):
        ctx.group, ctx.k = group, k
        return _shifted(x, group, k)

    @staticmethod
    def backward(ctx, g):
        return _shifted(g, ctx.group, -ctx.k), None, None


class _SplitAG(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return _block_of(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return all_gather(g.contiguous(), ctx.group, dim=ctx.dim), None, None


class _AllGatherSplit(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return all_gather(x, group, dim=dim)

    @staticmethod
    def backward(ctx, g):
        return _block_of(g, ctx.group, ctx.dim), None, None


def _one(group) -> bool:
    return group is None or dist.get_world_size(group) == 1


def all_gather_rs(x: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """All-gather along ``dim``; the gradient is reduce-scattered
    (:func:`reduce_scatter`): each rank's use of the whole is a part of
    the work, so the parts' gradients are summed.  A sharded weight
    gathered for a layer, or a sequence gathered for a tensor-parallel
    block."""
    return x if _one(group) else _AllGatherRS.apply(x, group, dim)


def gather_columns(x: torch.Tensor, group, dim, ws):
    """``x @ w`` for each of ``ws`` (column blocks) with ``x`` entered whole
    over ``group``: all-gathered along ``dim``, or ``x`` itself where
    ``dim`` is None, the gradient then summed (:class:`_GatherColumns`:
    the gathered ``x`` not kept; each projection's input gradient summed
    over the group on its own, the sums added the last projection's
    first)."""
    if _one(group):
        return tuple(torch.matmul(x, w) for w in ws)
    return _GatherColumns.apply(x, group, dim, *ws)


def all_gather_chunks(x: torch.Tensor, group, size: int):
    """``x`` ``(B, S_b, ...)``, this rank's block of a sequence, all-gathered
    along the sequence once (the blocks in rank order) and handed out as
    consecutive chunks of ``size`` positions (``size`` dividing the whole),
    an iterator that makes each chunk's autograd node when it is taken,
    for work that walks the sequence a chunk at a time (the loss).  Each
    chunk's gradient is summed into the blocks that hold its positions as
    soon as it exists (:class:`_GatheredChunk`), so neither the chunks'
    gradients nor their whole is ever held together; the block's gradient
    is every element's rank-order sum, as :func:`all_gather_rs`'s."""
    if _one(group):
        return iter(x.split(size, dim=1))
    full = all_gather(x.detach(), group, dim=1)
    n = full.shape[1] // size
    acc = {"left": n, "dtype": x.dtype, "device": x.device}
    # made one at a time as the caller walks them, so each chunk's
    # gradient is reduced as soon as its consumer's backward made it
    return (_GatheredChunk.apply(x, full[:, i * size:(i + 1) * size], group, i * size, acc)
            for i in range(n))


def reduce_scatter_ag(x: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """:func:`reduce_scatter` along ``dim``; the gradient is all-gathered.
    A tensor-parallel block's partial output returned to the
    sequence-sharded stream."""
    return x if _one(group) else _ReduceScatterAG.apply(x, group, dim)


def all_reduce_id(x: torch.Tensor, group) -> torch.Tensor:
    """:func:`ordered_allreduce`; the gradient passes through unchanged
    (each rank's term of the sum gets the sum's gradient)."""
    return x if _one(group) else _AllReduceId.apply(x, group)


def identity_ar(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` unchanged; the gradient is :func:`ordered_allreduce`'d.  A
    tensor every rank holds whole and uses in part (a replicated weight
    on a sequence block, a head block of a bias), so every rank ends with
    its whole gradient, the same bits."""
    return x if _one(group) else _IdentityAR.apply(x, group)


def shift(x: torch.Tensor, group, k: int = 1) -> torch.Tensor:
    """Rank r's result is rank r − k's ``x`` (every rank's of one shape),
    zeros on the first ``k`` ranks; the gradient goes back the ``k`` ranks
    (the last ``k`` ranks' is dropped).  One point-to-point exchange around
    the group's ring each way; ``k`` is at least 1."""
    return torch.zeros_like(x) if _one(group) else _Shift.apply(x, group, k)


def split_ag(x: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """This rank's block of ``x`` along ``dim``; the gradient is
    all-gathered.  Work every rank repeats on the same whole tensor,
    handed on as blocks."""
    return x if _one(group) else _SplitAG.apply(x, group, dim)


def all_gather_split(x: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """All-gather along ``dim``; the gradient is cut back to this rank's
    block, for work every rank then repeats on the same whole tensor (its
    gradient the same on every rank)."""
    return x if _one(group) else _AllGatherSplit.apply(x, group, dim)
