"""Parallelism rules: DP / FSDP / TP / EP / SP partition specs.

Mesh axes (``launch/mesh.py``): single-pod ``(data, model)``, multi-pod
``(pod, data, model)``.  Policy, as the reference's:

* batch            -> (pod, data)                      [DP]
* weights          -> input dim on `data` (FSDP/ZeRO-3), output/TP dim on
                      `model` (Megatron column/row)    [FSDP × TP]
* MoE experts      -> expert dim on `model` when divisible (EP), else
                      per-expert d_ff on `model`       [EP]
* activations      -> sequence dim on `model` when run.activation_sharding
                      == "sequence" (Megatron-SP)      [SP]
* decode KV caches -> batch on (pod, data) when divisible, else sequence on
                      `model` (flash-decoding style)

Param specs are derived from leaf *names* (path patterns) + dimensionality,
so every architecture family shares one rule set.

Port of the JAX package's ``sharding/partition.py`` over a
:class:`torch.distributed.device_mesh.DeviceMesh`.  A spec is
:class:`PartitionSpec`, the port's stand-in for JAX's: per tensor dimension
a mesh axis name, a tuple of names, or None (a one-name tuple is the name,
an empty one None, as JAX normalizes them).  A sharding is
:class:`NamedSharding`, a spec bound to a mesh, whose ``placements`` are
``torch.distributed.tensor``'s ``Shard``/``Replicate`` per mesh dimension;
a tensor dimension on ``("pod", "data")`` is ``Shard(d)`` on both, pod-major
as in JAX.  :func:`shard_tensor` cuts this rank's block of a full tensor,
:func:`gather_tensor` puts the blocks back together over the mesh's groups
(``sharding/collectives.py::all_gather``), and ``shard_tree`` /
``gather_tree`` do so leaf by leaf.

The rules partition the *state*: what a rank stores.  What a rank computes
on it is ``sharding/split.py``'s :class:`~repro_torch.sharding.split.Split`,
built from the rules (:meth:`Rules.split`): each layer gathered over the
data-parallel axes inside the layer loop, Megatron TP and SP over
``model``, experts over ``model`` where ``Rules.ep`` holds (else each
expert's d_ff).  The port's models take it as ``constrain=`` at the
reference's call sites, and :meth:`Rules.constrain` lays an activation out
by :meth:`Rules.act_pspec` through it (``launch/train.py``).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional, Tuple

import torch

from repro_torch import pytree
from repro_torch.configs.base import ModelConfig, RunConfig, ShapeConfig
from repro_torch.sharding.collectives import all_gather
from repro_torch.sharding.split import Split

__all__ = ["PartitionSpec", "P", "NamedSharding", "MeshAxes", "Rules", "make_rules",
           "shard_shape", "shard_tensor", "gather_tensor", "shard_tree", "gather_tree",
           "sharded_bytes", "spec_axes", "is_owner", "full_shape", "block_index"]


def _canon(entry):
    if isinstance(entry, (tuple, list)):
        entry = tuple(entry)
        if not entry:
            return None
        return entry[0] if len(entry) == 1 else entry
    return entry


class PartitionSpec:
    """Per tensor dimension: a mesh axis name, a tuple of names, or None.
    Not a tuple, so a tree of specs keeps them as leaves
    (:mod:`repro_torch.pytree`); iterating gives the entries."""
    __slots__ = ("_entries",)

    def __init__(self, *entries):
        self._entries = tuple(_canon(e) for e in entries)

    def __iter__(self):
        return iter(self._entries)

    def __len__(self):
        return len(self._entries)

    def __getitem__(self, i):
        return self._entries[i]

    def __eq__(self, other):
        if isinstance(other, PartitionSpec):
            return self._entries == other._entries
        return NotImplemented

    def __repr__(self):
        return f"PartitionSpec{self._entries!r}"


P = PartitionSpec


def _axes(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


class NamedSharding:
    """A spec bound to a mesh: ``(mesh, placements)`` with ``spec``."""
    __slots__ = ("mesh", "spec")

    def __init__(self, mesh, spec: PartitionSpec):
        self.mesh = mesh
        self.spec = spec

    @property
    def placements(self):
        """``Shard(d)`` on each mesh dimension that splits tensor dimension
        ``d``, ``Replicate()`` on the others."""
        from torch.distributed.tensor import Replicate, Shard
        out = []
        for name in self.mesh.mesh_dim_names:
            dims = [d for d, e in enumerate(self.spec) if name in _axes(e)]
            out.append(Shard(dims[0]) if dims else Replicate())
        return tuple(out)

    def __repr__(self):
        return f"NamedSharding({tuple(self.mesh.mesh.shape)}, {self.spec!r})"


def _sizes(mesh) -> dict:
    return dict(zip(mesh.mesh_dim_names, (int(s) for s in mesh.mesh.shape)))


@dataclasses.dataclass(frozen=True)
class MeshAxes:
    dp: Tuple[str, ...]        # ("pod", "data") or ("data",)
    fsdp: str = "data"
    tp: str = "model"

    @classmethod
    def from_mesh(cls, mesh) -> "MeshAxes":
        names = mesh.mesh_dim_names
        dp = tuple(n for n in names if n in ("pod", "data"))
        return cls(dp=dp)


# --- param-name pattern -> (base_ndim, base spec) ---------------------------

def _param_base_spec(path: str, ndim: int, ax: MeshAxes, cfg: ModelConfig):
    tp, fsdp = ax.tp, ax.fsdp
    name = path.split("/")[-1]
    under_moe = "/moe/" in path or path.endswith("/moe")
    if under_moe and name in ("wi", "wg", "wo"):
        # experts (E, d_in, d_out): EP when the expert count divides the tp
        # axis, else TP inside each expert (resolved by Rules._resolve)
        if name == "wo":
            return 3, (("E",), (None,), (fsdp,))
        return 3, (("E",), (fsdp,), ("F",))
    if name in ("embed",):
        return 2, ((tp,), (fsdp,))
    if name in ("unembed",):
        return 2, ((fsdp,), (tp,))
    if name in ("wq", "wk", "wv", "wi", "wg", "w_in"):
        return 2, ((fsdp,), (tp,))
    if name in ("wo", "w_out", "proj_out"):
        return 2, ((tp,), (fsdp,))
    if name in ("router",):
        return 2, ((fsdp,), (None,))
    if name in ("enc_pos", "dec_pos"):
        return 2, ((None,), (fsdp,))
    if name in ("conv",):
        return 2, ((None,), (tp,))
    return 1, ((None,),)


class Rules:
    """Bound to a mesh: produces specs and shardings."""

    def __init__(self, mesh, cfg: ModelConfig, run: RunConfig,
                 shape: Optional[ShapeConfig] = None):
        self.mesh = mesh
        self.cfg = cfg
        self.run = run
        self.shape = shape
        self.ax = MeshAxes.from_mesh(mesh)
        self.sizes = _sizes(mesh)
        self.dp_total = 1
        for a in self.ax.dp:
            self.dp_total *= self.sizes[a]
        self.tp_size = self.sizes[self.ax.tp]
        self.ep = (cfg.n_experts > 0
                   and cfg.n_experts_padded % self.tp_size == 0)
        self.seq_sharded = run.activation_sharding in ("sequence",
                                                       "sequence_all")
        self._split: Optional[Split] = None

    # ---- parameters --------------------------------------------------------

    def _resolve(self, entry):
        """Map symbolic axis tags to mesh axes for this config/mesh."""
        out = []
        for dims in entry:
            d = dims[0]
            if d == "E":
                out.append(self.ax.tp if self.ep else None)
            elif d == "F":
                out.append(None if self.ep else self.ax.tp)
            else:
                out.append(d)
        return out

    def param_pspec(self, path: str, leaf) -> PartitionSpec:
        base_ndim, entry = _param_base_spec(path, leaf.ndim, self.ax, self.cfg)
        base = self._resolve(entry)
        extra = leaf.ndim - base_ndim
        if extra < 0:   # e.g. unstacked scalar params
            return P()
        spec = [None] * extra + base
        # drop sharding on axes that don't divide
        for i, s in enumerate(spec):
            if s is None:
                continue
            if leaf.shape[i] % self.sizes[s]:
                spec[i] = None
        return P(*spec)

    def param_specs(self, params) -> Any:
        return pytree.unflatten(params, [self.param_pspec(p, leaf)
                                         for p, leaf in pytree.leaves_with_path(params)])

    def param_shardings(self, params) -> Any:
        return pytree.tree_map(lambda s: NamedSharding(self.mesh, s),
                               self.param_specs(params))

    # ---- activations -------------------------------------------------------

    def split(self) -> Split:
        """The split context over this mesh (``sharding/split.py``), made
        once, when first asked for (it needs the mesh's groups)."""
        if self._split is None:
            self._split = Split(self)
        return self._split

    def constrain(self, x, kind: str):
        """``x``, whole on every ``model`` rank, laid out as
        :meth:`act_pspec` says over ``model``: cut to this rank's block,
        its gradient all-gathered (:meth:`Split.__call__
        <repro_torch.sharding.split.Split.__call__>`)."""
        return self.split()(x, kind)

    def act_pspec(self, kind: str, ndim: int) -> Optional[PartitionSpec]:
        dp = self.ax.dp
        tp = self.ax.tp
        sp = tp if self.seq_sharded else None
        if kind == "act" and ndim == 3:          # (B, S, D)
            return P(dp, sp, None)
        if kind == "ff" and ndim == 3:           # (B, S, F)
            return P(dp, None, tp)
        if kind == "experts" and ndim == 4:      # (B, E, C, D)
            return P(dp, tp if self.ep else None, None, None)
        if kind == "experts_ff" and ndim == 4:   # (B, E, C, F)
            return P(dp, tp, None, None) if self.ep else P(dp, None, None, tp)
        if kind == "ssm_x" and ndim == 4:        # (B, S, H, P)
            if self.run.ssm_head_shard:
                return P(dp, None, tp, None)     # head-parallel SSD
            return P(dp, sp, None, None)
        return None

    # ---- run inputs --------------------------------------------------------

    def batch_pspec(self, leaf) -> PartitionSpec:
        if leaf.ndim >= 1 and leaf.shape[0] % self.dp_total == 0 \
                and leaf.shape[0] >= self.dp_total:
            return P(self.ax.dp, *(None,) * (leaf.ndim - 1))
        return P(*(None,) * leaf.ndim)

    def batch_specs(self, batch) -> Any:
        return pytree.tree_map(lambda leaf: NamedSharding(self.mesh, self.batch_pspec(leaf)),
                               batch)

    def cache_pspec(self, path: str, leaf) -> PartitionSpec:
        """KV / SSM cache sharding for decode: batch over DP when it divides,
        *and* sequence (KV caches) / heads (SSM state) over the model axis —
        flash-decoding style, which sidesteps GQA head divisibility."""
        dp, tp = self.ax.dp, self.ax.tp
        name = path.split("/")[-1]
        if leaf.ndim >= 2:
            batch = leaf.shape[1]   # (L, B, ...)
            bspec = dp if (batch % self.dp_total == 0) else None
            if name in ("k", "v", "xk", "xv") and leaf.ndim == 5 \
                    and leaf.shape[2] % self.tp_size == 0:
                # (L, B, T, KV, hd): sequence-shard the cache
                return P(None, bspec, tp, None, None)
            if name == "state" and leaf.ndim == 6 \
                    and leaf.shape[3] % self.tp_size == 0:
                # (L, B, G, HG, P, N): shard SSD heads
                return P(None, bspec, None, tp, None, None)
            if name == "conv" and leaf.ndim == 4 \
                    and leaf.shape[3] % self.tp_size == 0:
                return P(None, bspec, None, tp)
            return P(None, bspec, *(None,) * (leaf.ndim - 2))
        return P(*(None,) * leaf.ndim)

    def cache_shardings(self, caches) -> Any:
        return pytree.unflatten(caches, [NamedSharding(self.mesh, self.cache_pspec(p, leaf))
                                         for p, leaf in pytree.leaves_with_path(caches)])

    def replicated(self) -> NamedSharding:
        return NamedSharding(self.mesh, P())


def make_rules(mesh, cfg: ModelConfig, run: RunConfig,
               shape: Optional[ShapeConfig] = None) -> Rules:
    return Rules(mesh, cfg, run, shape)


# ---------------------------------------------------------------------------
# placing and gathering by a sharding
# ---------------------------------------------------------------------------

def block_index(sharding: NamedSharding, ndim: int):
    """Per tensor dimension ``(blocks, index)``: how many blocks the mesh
    cuts it into and which of them this rank holds (mixed radix over the
    entry's axes, the first most significant: pod-major)."""
    sizes = _sizes(sharding.mesh)
    coord = dict(zip(sharding.mesh.mesh_dim_names, sharding.mesh.get_coordinate()))
    out = []
    for d in range(ndim):
        entry = sharding.spec[d] if d < len(sharding.spec) else None
        n, i = 1, 0
        for a in _axes(entry):
            n, i = n * sizes[a], i * sizes[a] + coord[a]
        out.append((n, i))
    return out


def spec_axes(spec: PartitionSpec) -> Tuple[str, ...]:
    """Every mesh axis a spec names, in order."""
    return tuple(a for e in spec for a in _axes(e))


def is_owner(sharding: NamedSharding) -> bool:
    """Whether this rank is the one that counts its block of a leaf once
    over the mesh: its coordinate is 0 on every axis the spec replicates
    the leaf over (a sum over the mesh of the owners' parts counts each
    element once)."""
    used = spec_axes(sharding.spec)
    coord = dict(zip(sharding.mesh.mesh_dim_names, sharding.mesh.get_coordinate()))
    return all(coord[a] == 0 for a in sharding.mesh.mesh_dim_names if a not in used)


def full_shape(block_shape, sharding: NamedSharding) -> Tuple[int, ...]:
    """The whole tensor's shape of which a rank's block has ``block_shape``."""
    return tuple(b * n for b, (n, _) in zip(block_shape, block_index(sharding, len(block_shape))))


def shard_shape(shape, sharding: NamedSharding) -> Tuple[int, ...]:
    """The shape of one rank's block of a tensor of ``shape``."""
    out = []
    for s, (n, _) in zip(shape, block_index(sharding, len(shape))):
        if s % n:
            raise ValueError(f"dimension of {s} does not divide into {n} blocks "
                             f"({sharding!r})")
        out.append(s // n)
    return tuple(out)


def shard_tensor(x: torch.Tensor, sharding: NamedSharding) -> torch.Tensor:
    """This rank's block of the full tensor ``x``, a contiguous copy (a
    replicated ``x`` is returned as it is)."""
    blocks = block_index(sharding, x.ndim)
    if all(n == 1 for n, _ in blocks):
        return x
    size = shard_shape(x.shape, sharding)
    out = x
    for d, (n, i) in enumerate(blocks):
        if n > 1:
            out = out.narrow(d, i * size[d], size[d])
    return out.contiguous()


def gather_tensor(x: torch.Tensor, sharding: NamedSharding) -> torch.Tensor:
    """The full tensor of which ``x`` is this rank's block: gathered over
    each axis that splits a dimension, the last axis of an entry first, so
    that ``("pod", "data")`` comes back pod-major."""
    for d in range(x.ndim):
        entry = sharding.spec[d] if d < len(sharding.spec) else None
        for a in reversed(_axes(entry)):
            x = all_gather(x, sharding.mesh.get_group(a), dim=d)
    return x


def shard_tree(tree, shardings):
    """:func:`shard_tensor` leaf by leaf; ``shardings`` has ``tree``'s
    structure (None leaves are kept), or is None: ``tree`` whole, as it
    is."""
    if shardings is None:
        return tree
    return pytree.tree_map(shard_tensor, tree, shardings)


def gather_tree(tree, shardings):
    """:func:`gather_tensor` leaf by leaf; ``shardings`` None returns
    ``tree`` as it is."""
    if shardings is None:
        return tree
    return pytree.tree_map(gather_tensor, tree, shardings)


def sharded_bytes(tree, shardings) -> int:
    """The bytes one rank stores of ``tree`` (full tensors, or anything
    with ``shape`` and ``dtype``) under ``shardings``."""
    total = 0
    for leaf, sh in zip(pytree.leaves(tree), pytree.leaves(shardings)):
        total += math.prod(shard_shape(tuple(leaf.shape), sh)) * leaf.dtype.itemsize
    return total
