"""Distributed single-matrix factorization — the paper's future work, built.

Paper App. A: "the current approach could be extended to allow a single
Cholesky factorization to be distributed and computed across multiple
nodes using nested dissection ordering".  The adaptive-ND ordering
(§III-A) makes the diagonal partitions independent given the
separator/arrow block, so:

  1. each rank of the chosen mesh axis factorizes its partitions' band +
     arrow rows, all of them in one batched launch of the band-Cholesky
     sweep (``kernels.ops.band_cholesky_sweep``, a partition a batch
     element);
  2. each rank sums its partial corner Schur complement
     Σ_{n∈partitions} R_n R_nᵀ (the sweep's chunked leaves, summed over
     partitions and chunks);
  3. the partials are combined across the axis with the **GEADD binary
     tree** (``sharding/collectives.py::tree_allreduce``, Alg. 3 across
     devices), so every rank holds the same bits;
  4. the (small) corner is factorized redundantly on every rank —
     replicated compute beats a broadcast for a few tiles.

Correctness requires true partition independence (no band coupling across
partition boundaries) — guaranteed by adaptive-ND ordering, and natively by
the paper's block-diagonal cases (Table II ids 1, 4, 7, 10, 13, 16);
:func:`partition_banded` validates this on the host before the split.
Block independence also makes every partition's panels and arrow rows the
same bits as the fused sweep's over the whole matrix: the skipped products
are exact zeros.

Every rank is passed the whole :class:`PartitionedCTSF`, as the
reference's caller passes one global array; :func:`distributed_factorize`
returns the rank's partitions (``first`` is the index of the first), and
:func:`assemble_factor` gathers every rank's partitions onto every rank.

Port of the JAX package's ``core/distributed.py``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch
import torch.distributed as dist

from repro_torch.kernels import ops
from repro_torch.kernels.ring import band_col_to_row, band_row_to_col
from repro_torch.sharding.collectives import all_gather, tree_allreduce
from .cholesky import CholeskyFactor, _corner_dense_cholesky
from .ctsf import BandedCTSF
from .options import SolverOptions
from .structure import ArrowheadStructure, TileGrid

__all__ = ["partition_banded", "distributed_factorize", "assemble_factor", "PartitionedCTSF",
           "mesh_axis"]


@dataclasses.dataclass
class PartitionedCTSF:
    """A BandedCTSF split into p independent diagonal partitions.

    ``Dr (parts, ndt_p, bt+1, t, t)``, ``R (parts, ndt_p, nat, t, t)``,
    ``C (nat, nat, t, t)``; ``grid`` is one partition's grid (``ndt_p``
    diagonal tiles).  ``parts`` is ``n_parts`` for the whole matrix; a
    rank's factor from :func:`distributed_factorize` holds its own
    partitions, ``first`` onward, and the ``mesh`` and ``axis`` they were
    spread over."""
    grid: TileGrid
    n_parts: int
    Dr: torch.Tensor
    R: torch.Tensor
    C: torch.Tensor
    first: int = 0
    mesh: Optional[Any] = None
    axis: Optional[str] = None


def mesh_axis(mesh, axis: str):
    """``(group, index, size)`` of mesh dimension ``axis``: its process
    group, this rank's place along it and its length.  ``mesh`` must be a
    :class:`torch.distributed.device_mesh.DeviceMesh` (``TypeError``
    otherwise)."""
    from torch.distributed.device_mesh import DeviceMesh
    if not isinstance(mesh, DeviceMesh):
        raise TypeError(f"mesh must be a torch.distributed.device_mesh.DeviceMesh "
                        f"(launch/mesh.py::make_local_mesh), got {type(mesh).__name__}")
    group = mesh.get_group(axis)
    return group, dist.get_rank(group), dist.get_world_size(group)


def partition_banded(m: BandedCTSF, n_parts: int, atol: float = 0.0) -> PartitionedCTSF:
    """Split a block-independent BandedCTSF into ``n_parts`` partitions.

    Validates on host that no band tile couples two partitions (the
    adaptive-ND invariant); raises if the split would be incorrect.
    """
    g = m.grid
    ndt, bt = g.n_diag_tiles, g.band_tiles
    if ndt % n_parts:
        raise ValueError(f"n_diag_tiles={ndt} not divisible by {n_parts}")
    per = ndt // n_parts
    Dr = m.Dr.detach().cpu()
    for p in range(1, n_parts):
        start = p * per
        # rows [start, start+bt) may reach columns < start via d > row-start
        for r in range(start, min(start + bt, ndt)):
            for d in range(r - start + 1, bt + 1):
                if float(Dr[r, d].abs().max()) > atol:
                    raise ValueError(
                        f"band tile ({r},{r - d}) crosses partition boundary "
                        f"{start}; reorder with adaptive ND first")
    sub_struct = ArrowheadStructure(
        n=per * g.t + g.structure.arrow, bandwidth=g.structure.bandwidth,
        arrow=g.structure.arrow)
    sub_grid = TileGrid(sub_struct, g.t)
    return PartitionedCTSF(
        sub_grid, n_parts,
        m.Dr.reshape((n_parts, per) + tuple(m.Dr.shape[1:])),
        m.R.reshape((n_parts, per) + tuple(m.R.shape[1:])),
        m.C)


def distributed_factorize(pm: PartitionedCTSF, mesh, axis: str = "model", *,
                          tree_chunks: int = 8,
                          options: Optional[SolverOptions] = None) -> PartitionedCTSF:
    """Factorize one matrix across the ranks of ``mesh``'s ``axis`` (see
    the module note): this rank's ``n_parts / size`` partitions in one
    batched sweep launch, its Schur partial summed over partitions and
    chunks, the GEADD tree across the axis (``log2 size`` geadd launches
    a rank), the corner redundantly (``nat`` potrf and ``nat`` trsm).
    Returns this rank's partitions of the factor (``first`` the index of
    the first) with the replicated corner.  ``options.impl`` chooses the
    backend; no other option applies to this route, and one set raises."""
    opts = options if options is not None else SolverOptions()
    if (opts.policy is not None or opts.regularize not in (None, False)
            or opts.sweep != "auto" or opts.partition_plan is not None or opts.method):
        raise ValueError("distributed_factorize takes options.impl only (no policy, "
                         "regularize, sweep, partition_plan or method)")
    group, me, size = mesh_axis(mesh, axis)
    if pm.n_parts % size:
        raise ValueError(f"n_parts={pm.n_parts} not divisible by mesh axis "
                         f"{axis}={size}")
    per = pm.n_parts // size
    lo = me * per
    grid = pm.grid
    nchunks = max(1, min(tree_chunks or 1, grid.n_diag_tiles or 1))
    # the rank's partitions, a batch element each: the sweep emits its own
    # corner-Schur chunks, so no re-contraction of the arrow rows here
    panels, r_l, sch, _status = ops.band_cholesky_sweep(
        band_row_to_col(pm.Dr[lo:lo + per]), pm.R[lo:lo + per].contiguous(),
        nchunks=nchunks, impl=opts.impl)
    dr_l = band_col_to_row(panels)
    if grid.n_arrow_tiles:
        partial = sch.sum(dim=(0, 1))                  # parts x chunks
        schur = tree_allreduce(partial, group)         # the GEADD tree
        c_l = _corner_dense_cholesky(pm.C - schur, opts.impl)
    else:
        c_l = pm.C
    return PartitionedCTSF(grid, pm.n_parts, dr_l, r_l, c_l, first=lo, mesh=mesh, axis=axis)


def assemble_factor(pm: PartitionedCTSF, full_grid: TileGrid) -> CholeskyFactor:
    """Reassemble a partitioned factor into one BandedCTSF on every rank:
    a rank's share from :func:`distributed_factorize` gathers every rank's
    partitions along its mesh axis first (a collective: every rank of the
    axis calls it); a whole factor is reshaped as it is."""
    dr, r = pm.Dr, pm.R
    if dr.shape[0] != pm.n_parts:
        group, _, _ = mesh_axis(pm.mesh, pm.axis)
        dr, r = all_gather(dr, group), all_gather(r, group)
    p, per = dr.shape[0], dr.shape[1]
    return CholeskyFactor(BandedCTSF(full_grid, dr.reshape((p * per,) + tuple(dr.shape[2:])),
                                     r.reshape((p * per,) + tuple(r.shape[2:])), pm.C))
