"""The split context: what a rank computes of a sharded train step, a
prefill or a decode step.

``Rules`` (``sharding/partition.py``) says where each leaf of the state
lives; this module says how a step computes on those blocks, the
reference's GSPMD split done by hand.  A :class:`Split` is what the port's
models take as ``constrain=`` at the reference's call sites: called as
``constrain(x, kind)`` it lays a tensor every ``model`` rank holds whole
out as ``Rules.act_pspec(kind)``'s block (the reference's
``with_sharding_constraint``), and its methods are the collectives a split
layer runs, each an autograd pair of ``sharding/collectives.py`` whose sums
add in group-rank order.

* FSDP: a layer's leaves arrive as this rank's blocks and are gathered
  over the data-parallel axes their specs name (:meth:`gather`), one layer
  at a time inside the layer loop (``models/layers.py::scan_or_unroll``);
  the gradient leaves as a block through the ordered reduce-scatter.
* Megatron TP and SP over ``model``: with ``run.activation_sharding``
  ``"sequence"`` or ``"sequence_all"`` the residual stream lives as this
  rank's sequence block; a tensor-parallel block :meth:`enter`\\ s by an
  all-gather of the sequence and :meth:`leave`\\ s by a reduce-scatter.
  With ``"replicated"`` (or a sequence ``model`` does not divide) the
  stream is whole on every rank, and the pair is the identity and an
  all-reduce.  Column-parallel projections enter through
  :meth:`enter_columns`, which keeps no gathered stream for the backward.
  The stream's ends are Megatron's too: the vocabulary-parallel lookup is
  reduce-scattered straight into this rank's block
  (``models/layers.py::embed_lookup``), and the loss gathers the stream
  once and returns each chunk's gradient to the blocks as soon as it
  exists (:meth:`enter_chunks`).  Column blocks (``wq``, ``wk``, ``wv``,
  ``wi``, ``wg``) and row blocks (``wo``) are the rules' ``model`` blocks
  (:meth:`block`).
* A leaf the rules replicate over ``model`` and a rank uses in part (a
  norm's scale on a sequence block, a bias's head block, the router) goes
  through :meth:`rep` / :meth:`tp_rep`, whose gradient is summed over
  ``model``; work every rank repeats on the same data (a layer on a
  stream whole on every rank, the loss where ``model`` does not divide the
  vocabulary) goes through :meth:`redundant` and :meth:`whole_redundant`,
  whose gradients are cut back to blocks.
* A recurrence along a sequence-sharded stream (the SSD mixer and its
  causal conv) runs on this rank's block: :meth:`halo` brings the
  positions before the block from the ranks that hold them, and
  :meth:`stacked` hands every rank each rank's carry (a block's state) to
  fold in rank order.

* Serving: a prefill is the train forward's split on the prompt, its
  last position made whole by :meth:`last`.  A decode step's stream is one
  token, whole on every ``model`` rank (``at(1)``: ``enter`` the identity,
  ``leave`` an ordered all-reduce), against caches held as the rules'
  blocks (``Rules.cache_pspec``), registered with their specs like the
  parameters: :meth:`on_model` says whether a cache's dimension is cut
  over ``model`` and :meth:`cache_offset` gives this rank's first position
  of a sequence-sharded cache (rank ``pos // len`` holds position
  ``pos``; a length ``model`` does not divide stays whole); the flash
  decoding's statistics combine by :meth:`model_max` and ordered sums, and
  activations cut over ``model`` come back whole by :meth:`model_gather`.

``Split(rules)`` holds the groups; :meth:`bind` registers a step's
parameter blocks (and a decode step's cache blocks) with their specs, and
:meth:`at` binds the context to a residual stream of a given sequence
length, which fixes whether that stream is sequence-sharded.
"""
from __future__ import annotations

import copy
from typing import Optional, Tuple

import torch
import torch.distributed as dist
from torch.utils.weak import WeakIdKeyDictionary

from repro_torch import pytree
from repro_torch.sharding.collectives import (all_gather, all_gather_chunks, all_gather_rs,
                                              all_gather_split, gather_columns, all_reduce_id, all_reduce_max,
                                              identity_ar, reduce_scatter_ag, shift, split_ag)

__all__ = ["Split"]


def _axes(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


class Split:
    """The split context of a step over ``rules``' mesh (see the module
    docstring).  ``tp`` is the ``model`` axis's size, ``rank`` this rank's
    place on it; ``sp`` whether the bound stream is sequence-sharded
    (:meth:`at`), ``seq`` its whole length (None until bound); ``remat``
    the rules' ``run.remat``, which the norms also follow
    (``models/layers.py::norm_apply``)."""

    def __init__(self, rules):
        self.rules = rules
        self.cfg = rules.cfg
        self.mesh = rules.mesh
        self.tp = rules.tp_size
        self.dp_axes = tuple(rules.ax.dp)
        self.model = rules.mesh.get_group(rules.ax.tp) if self.tp > 1 else None
        self.rank = dist.get_rank(self.model) if self.model is not None else 0
        self.seq: Optional[int] = None
        self.sp = False
        self.remat = rules.run.remat
        self._specs = WeakIdKeyDictionary()

    # ---- binding -------------------------------------------------------------

    def bind(self, params, specs) -> "Split":
        """Register ``params``' leaves (this rank's blocks) with their
        ``PartitionSpec``s (a tree of ``params``' structure); returns
        self."""
        for x, s in zip(pytree.leaves(params), pytree.leaves(specs)):
            self._specs[x] = s
        return self

    def at(self, seq: int) -> "Split":
        """This context bound to a residual stream of ``seq`` positions:
        sequence-sharded when the rules say so and ``model`` divides it."""
        out = copy.copy(self)
        out.seq = int(seq)
        out.sp = bool(self.rules.seq_sharded and self.tp > 1 and seq % self.tp == 0)
        return out

    def slices(self, stacked) -> list:
        """The stacked leaves of ``stacked`` taken apart on their leading
        axis, one ``unbind`` a leaf: a list of per-layer trees whose leaves
        carry their spec less its first entry."""
        leaves = pytree.leaves(stacked)
        parts = [x.unbind(0) for x in leaves]
        out = []
        for i in range(leaves[0].shape[0]):
            row = [p[i] for p in parts]
            for x, s in zip(leaves, row):
                spec = self._specs.get(x)
                if spec is not None:
                    self._specs[s] = type(spec)(*tuple(spec)[1:])
            out.append(pytree.unflatten(stacked, row))
        return out

    # ---- FSDP -----------------------------------------------------------------

    def gather(self, tree):
        """``tree``'s leaves gathered over the data-parallel axes their
        specs put them on (the last axis of an entry first, so
        ``("pod", "data")`` comes back pod-major); the gradient leaves as
        this rank's block by the ordered reduce-scatter.  A leaf without a
        registered spec is taken as it is."""
        def one(x):
            spec = self._specs.get(x)
            if spec is None:
                return x
            for d, entry in enumerate(spec):
                for a in reversed(_axes(entry)):
                    if a in self.dp_axes:
                        x = all_gather_rs(x, self.mesh.get_group(a), dim=d)
            return x
        return pytree.tree_map(one, tree)

    # ---- the stream's layout ----------------------------------------------------

    def __call__(self, x: torch.Tensor, kind: str) -> torch.Tensor:
        """``x`` laid out as ``rules.act_pspec(kind)`` over ``model``: a
        tensor whole on every rank along the dimension the spec puts on
        ``model`` is cut to this rank's block (the gradient all-gathered);
        one already cut (the extent of a bound stream's block) is returned
        as it is.  Kinds without a ``model`` dimension, or one ``model``
        does not divide, return ``x``."""
        spec = self.rules.act_pspec(kind, x.ndim)
        if spec is None or self.tp == 1:
            return x
        dims = [d for d, e in enumerate(spec) if self.rules.ax.tp in _axes(e)]
        if not dims or x.shape[dims[0]] % self.tp:
            return x
        d = dims[0]
        if kind == "act" and self.seq is not None:
            if not self.sp:
                return x
            if x.shape[d] == self.seq // self.tp:
                return x
            if x.shape[d] != self.seq:
                raise ValueError(f"constrain(act): a stream of {self.seq} positions, got a "
                                 f"tensor of {x.shape[d]}")
        return split_ag(x, self.model, dim=d)

    def enter(self, x: torch.Tensor):
        """The stream into a tensor-parallel block, whole on every rank:
        the sequence all-gathered (SP), else ``x`` itself; the gradient,
        each rank's part, summed (reduce-scattered, or all-reduced)."""
        if self.sp:
            return all_gather_rs(x, self.model, dim=1)
        return identity_ar(x, self.model)

    def enter_columns(self, x: torch.Tensor, ws):
        """``x @ w`` for each of ``ws`` (this rank's column blocks, in the
        stream's dtype) with the stream entered as :meth:`enter` enters it,
        Megatron's sequence-parallel entry: the gathered stream is not kept
        for the backward, which gathers it again for the weights'
        gradients, and each projection's input gradient is summed over
        ``model`` on its own before the projections' are added (the
        reference's order of the sums; ``collectives.gather_columns``)."""
        return gather_columns(x, self.model, 1 if self.sp else None, ws)

    def enter_chunks(self, x: torch.Tensor, size: int):
        """The stream whole on every rank as consecutive chunks of ``size``
        positions (an iterator), for work that walks it a chunk at a time
        (the loss):
        under SP one all-gather of the sequence in the stream's dtype,
        each chunk's gradient summed straight into the blocks that hold
        its positions (``collectives.all_gather_chunks``); else
        :meth:`enter`'s stream, sliced."""
        if self.sp:
            return all_gather_chunks(x, self.model, size)
        x = self.enter(x)
        return iter([x[:, i * size:(i + 1) * size] for i in range(x.shape[1] // size)])

    def leave(self, y: torch.Tensor) -> torch.Tensor:
        """A tensor-parallel block's partial output (each rank's term of
        the sum) back into the stream: reduce-scattered along the sequence
        (SP), else all-reduced; in rank order."""
        if self.sp:
            return reduce_scatter_ag(y, self.model, dim=1)
        return all_reduce_id(y, self.model)

    def redundant(self, x: torch.Tensor) -> torch.Tensor:
        """The stream whole on every rank for work every rank repeats (the
        loss where ``model`` does not divide the vocabulary): the sequence
        all-gathered, the gradient cut back; a stream that is whole
        already is returned as it is."""
        if self.sp:
            return all_gather_split(x, self.model, dim=1)
        return x

    def halo(self, x: torch.Tensor, rows: int) -> torch.Tensor:
        """The ``rows`` positions before this rank's block of the
        sequence-sharded ``x`` ``(B, S / tp, ...)``: the blocks of the
        ranks before it, one :func:`shift` a block the halo reaches back
        (each rank's last ``min(rows, S / tp)`` positions), zeros before
        the sequence's start; the gradient goes back to the ranks the
        positions came from."""
        sl = x.shape[1]
        take = min(rows, sl)
        hops = min(-(-rows // sl), self.tp - 1)
        tail = x[:, sl - take:]
        got = torch.cat([shift(tail, self.model, k) for k in range(hops, 0, -1)], dim=1)
        got = got[:, max(got.shape[1] - rows, 0):]
        if got.shape[1] < rows:
            pad = got.new_zeros((got.shape[0], rows - got.shape[1]) + tuple(got.shape[2:]))
            got = torch.cat([pad, got], dim=1)
        return got

    def stacked(self, x: torch.Tensor) -> torch.Tensor:
        """Every ``model`` rank's ``x`` stacked along a new leading axis in
        rank order; the gradient of each rank's slice summed over ``model``
        in rank order (reduce-scattered) back to that rank."""
        return all_gather_rs(x.unsqueeze(0).contiguous(), self.model, dim=0)

    def q_offset(self, local: int) -> int:
        """The first position of this rank's block of a sequence of which
        it holds ``local`` positions."""
        return self.rank * local if self.tp > 1 else 0

    def last(self, h: torch.Tensor) -> torch.Tensor:
        """The stream's last position ``(B, 1, D)``, whole on every rank:
        under SP the last rank's, all-gathered (one position a rank)."""
        if not self.sp:
            return h[:, -1:]
        return all_gather(h[:, -1:].contiguous(), self.model, dim=1)[:, -1:]

    # ---- decode caches ----------------------------------------------------------

    def on_model(self, x: torch.Tensor, dim: int) -> bool:
        """Whether the registered leaf ``x`` (a cache block, or one
        layer's slice of it, :meth:`slices`) is cut over ``model`` along
        ``dim``."""
        spec = self._specs.get(x)
        return (self.tp > 1 and spec is not None and dim < len(spec)
                and self.rules.ax.tp in _axes(spec[dim]))

    def cache_offset(self, cache: torch.Tensor, dim: int = 1) -> Optional[int]:
        """This rank's first position of the sequence-sharded cache block
        ``cache`` (the sequence along ``dim``; the rank ``pos // len``
        holds position ``pos``), or None where the rules keep the cache
        whole over ``model`` (a length ``model`` does not divide)."""
        if self.tp > 1 and cache not in self._specs:
            raise ValueError("a decode step under a split takes its caches as blocks "
                             "registered with their specs (Split.bind)")
        if not self.on_model(cache, dim):
            return None
        return self.rank * cache.shape[dim]

    def model_gather(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """Every ``model`` rank's ``x`` concatenated along ``dim`` in rank
        order (an activation's blocks made whole; no gradient pair)."""
        return x if self.tp == 1 else all_gather(x.contiguous(), self.model, dim=dim)

    def model_sum(self, x: torch.Tensor) -> torch.Tensor:
        """The sum of every ``model`` rank's ``x`` in rank order, which
        every rank then uses whole on its own part of the work: the
        gradient, every rank's use, is summed too."""
        return all_reduce_id(identity_ar(x, self.model), self.model)

    def model_max(self, x: torch.Tensor) -> torch.Tensor:
        """The elementwise maximum of every ``model`` rank's ``x``."""
        return x if self.tp == 1 else all_reduce_max(x, self.model)

    # ---- leaves ---------------------------------------------------------------

    def rep(self, p: torch.Tensor) -> torch.Tensor:
        """A leaf replicated over ``model`` applied to the stream: on a
        sequence block each rank's gradient is a part, summed over
        ``model``; on a whole stream every rank's is the whole."""
        return identity_ar(p, self.model) if self.sp else p

    def tp_rep(self, p: torch.Tensor) -> torch.Tensor:
        """A leaf replicated over ``model`` used inside a tensor-parallel
        block: its gradient summed over ``model``."""
        return identity_ar(p, self.model)

    def is_cut(self, w: torch.Tensor, dim: int, full: int) -> bool:
        """Whether ``w`` holds this rank's ``model`` block of ``full``
        along ``dim`` (the rules cut a dimension ``model`` divides)."""
        return self.tp > 1 and w.shape[dim] * self.tp == full and w.shape[dim] != full

    def block(self, w: torch.Tensor, dim: int, full: int) -> torch.Tensor:
        """This rank's ``model`` block of a weight along ``dim`` (``full``
        its whole extent) for a tensor-parallel block: the rules' block
        itself, or cut from a replicated leaf (its gradient summed)."""
        if self.tp == 1 or self.is_cut(w, dim, full):
            return w
        if full % self.tp:
            raise ValueError(f"a dimension of {full} does not split over model of {self.tp}")
        b = full // self.tp
        return self.tp_rep(w).narrow(dim, self.rank * b, b)

    def whole(self, w: torch.Tensor, dim: int, full: int) -> torch.Tensor:
        """A weight whole along ``dim`` for work each rank does on its own
        part of the data (a sequence block): its ``model`` blocks
        all-gathered, or the replicated leaf; the gradient summed."""
        if self.is_cut(w, dim, full):
            return all_gather_rs(w, self.model, dim=dim)
        return self.tp_rep(w)

    def whole_redundant(self, w: torch.Tensor, dim: int, full: int) -> torch.Tensor:
        """A weight whole along ``dim`` for work every rank repeats: its
        ``model`` blocks all-gathered, the gradient cut back to the block."""
        if self.is_cut(w, dim, full):
            return all_gather_split(w, self.model, dim=dim)
        return w

    def vocab_block(self, w: torch.Tensor, dim: int) -> Optional[Tuple[int, int]]:
        """``(first row, rows)`` of this rank's vocabulary block of the
        embedding or unembedding ``w`` (vocabulary along ``dim``), or None
        when the rules leave the vocabulary whole."""
        full = self.cfg.vocab_padded
        if not self.is_cut(w, dim, full):
            return None
        n = w.shape[dim]
        return self.rank * n, n

