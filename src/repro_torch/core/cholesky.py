"""Sparse tile Cholesky factorization (the paper's Algorithms 1-3).

Two backends:

* :func:`factorize_tasklist` — the paper's own algorithm: the static task
  list of symbolic factorization (Algorithm 1's left-looking order) over
  the general CTSF (:class:`~repro_torch.core.ctsf.TileMatrix`), one tile
  kernel launch per POTRF / SYRK / TRSM / GEMM task, touching only nonzero
  and fill tiles.  With ``tree_reduction=True`` each long accumulation
  chain is summed by Algorithm 3 (chunked partials and the GEADD tree).
* :func:`factorize_window` — the regular banded-arrowhead layout
  (:class:`~repro_torch.core.ctsf.BandedCTSF`) in two phases: the band +
  arrow rows in one sweep, which also returns the corner-Schur complement
  as partial sums (the leaves of the Alg. 3 tree), then the dense corner,
  ``C - sum(leaves)``, column by column with the ``potrf`` and ``trsm``
  tile kernels.  On the card the sweep is one CUDA kernel launch: the
  fused sweep walks every band column in one block; with a partition plan
  of more than one partition, the partitioned sweep walks each independent
  partition in a block of its own, and its leaves (one a partition) are
  combined by the GEADD tree.  The plain version is a column loop.

Port of the JAX package's ``core/cholesky.py`` (``factorize_tasklist``,
``_factorize_window_impl`` with the fused, ring and partitioned sweeps,
``_corner_dense_cholesky`` and ``CholeskyFactor``).  Batched factorization,
the legacy ``"window"`` sweep, the bucketing policy and regularization come
with later slices.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import torch

from repro_torch.kernels import ops
from repro_torch.kernels.ring import band_col_to_row, band_row_to_col
from .ctsf import BandedCTSF, TileMatrix
from .options import SolverOptions
from .robustness import fold_corner_status
from .structure import TileGrid
from .symbolic import Task, TaskType
from .tree_reduction import chunked_tree_sum, should_use_tree, tree_combine

__all__ = ["CholeskyFactor", "factorize_window", "factorize_tasklist"]


# ---------------------------------------------------------------------------
# Task-list backend (the paper's algorithm)
# ---------------------------------------------------------------------------

def _group_tasks_by_column(tasks: List[Task]) -> Dict[int, dict]:
    """Regroup Alg. 1's flat task list into per-column phases:
    ``{k: {"syrk": [n, ...], "panel": {m: {"gemm": [n, ...], "trsm": bool}}}}``."""
    cols: Dict[int, dict] = {}
    for t in tasks:
        c = cols.setdefault(t.k, {"syrk": [], "panel": {}})
        if t.type == TaskType.SYRK:
            c["syrk"].append(t.n)
        elif t.type == TaskType.GEMM:
            c["panel"].setdefault(t.m, {"gemm": [], "trsm": False})
            c["panel"][t.m]["gemm"].append(t.n)
        elif t.type == TaskType.TRSM:
            c["panel"].setdefault(t.m, {"gemm": [], "trsm": False})
            c["panel"][t.m]["trsm"] = True
    return cols


def _chain(pairs, workers: int, device):
    """One accumulation chain of ``(a_slot, b_slot)`` products: the slot
    pairs themselves, to be applied one task at a time, or, where Alg. 3's
    tree applies, the slots as index tensors on ``device`` for one gather."""
    if not should_use_tree(len(pairs), workers):
        return ("tasks", pairs)
    a, b = zip(*pairs)
    return ("tree", torch.tensor(a, device=device), torch.tensor(b, device=device))


def _schedule(tm: TileMatrix, workers: int):
    """The task list in execution order, per column ``k``: ``(kk, syrk chain,
    [(mk, gemm chain, trsm), ...])`` in slots; built once per matrix,
    device and worker count, so a factorization makes no host-to-device
    copy (and can be captured in a CUDA graph)."""
    key = (str(tm.device), workers)
    if key not in tm.schedules:
        slot, cols = tm.slot, _group_tasks_by_column(tm.symbolic.tasks)
        steps = []
        for k in sorted(cols):
            col = cols[k]
            syrk = _chain([(slot[(k, n)],) * 2 for n in col["syrk"]], workers, tm.device)
            panel = [(slot[(m, k)],
                      _chain([(slot[(m, n)], slot[(k, n)]) for n in col["panel"][m]["gemm"]],
                             workers, tm.device),
                      col["panel"][m]["trsm"])
                     for m in sorted(col["panel"])]
            steps.append((slot[(k, k)], syrk, panel))
        tm.schedules[key] = steps
    return tm.schedules[key]


def _tree_update(tiles: torch.Tensor, dst: int, chain, workers: int, impl) -> None:
    """``tiles[dst] -= sum_q A_q B_q^T`` by Algorithm 3: the products in one
    batched product (full float32, no TF32, as the reference's HIGHEST
    precision einsum), the chunk partials summed, the GEADD tree on top."""
    _, a, b = chain
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        terms = torch.einsum("nab,ncb->nac", tiles[a], tiles[b])
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    tiles[dst] -= chunked_tree_sum(terms, workers, impl=impl)


def factorize_tasklist(tm: TileMatrix, tree_reduction: bool = False, tree_workers: int = 8,
                       options: Optional[SolverOptions] = None) -> torch.Tensor:
    """Run Algorithm 1 over the general CTSF: returns the factor's tile
    buffer, ``(n_alloc, t, t)`` with ``tm``'s slot map (``tm.tiles`` is left
    as it is).

    Per column k in order: the SYRK chain into the diagonal tile, its
    ``potrf``, then per row m below it (sorted) the GEMM chain into tile
    (m, k) and its ``trsm``.  Every task is one kernel launch on the card,
    writing into the tile's slot of the buffer (``out=``; a task's output
    tile is never one of its inputs).  With ``tree_reduction`` a chain of at
    least ``2 * tree_workers`` products is one batched product instead,
    summed by Algorithm 3 (``tree_workers`` chunk partials and
    ``ceil(log2 tree_workers)`` ``geadd`` launches).  ``options.impl``
    chooses the backend as everywhere else."""
    impl = (options or SolverOptions()).impl
    workers = tree_workers if tree_reduction else 0
    tiles = tm.tiles.clone()
    for kk, syrk, panel in _schedule(tm, workers):
        if syrk[0] == "tree":
            _tree_update(tiles, kk, syrk, workers, impl)
        else:
            for s, _ in syrk[1]:
                ops.syrk(tiles[kk], tiles[s], impl=impl, out=tiles[kk])
        ops.potrf(tiles[kk], impl=impl, out=tiles[kk])
        for mk, gemm, trsm in panel:
            if gemm[0] == "tree":
                _tree_update(tiles, mk, gemm, workers, impl)
            else:
                for sa, sb in gemm[1]:
                    ops.gemm(tiles[mk], tiles[sa], tiles[sb], impl=impl, out=tiles[mk])
            if trsm:
                ops.trsm(tiles[kk], tiles[mk], impl=impl, out=tiles[mk])
    return tiles


# ---------------------------------------------------------------------------
# Window backend
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class CholeskyFactor:
    """Factor L in the banded-arrowhead CTSF layout.

    ``status`` is the (3,) float32 breakdown word ``[min_pivot, nonfinite,
    first_bad]`` over band and corner, on the factor's device:
    ``first_bad`` is the first band column whose tile broke down (``ndt``
    for the corner) and -1 when the factorization is clean.  A breakdown
    is reported here, not raised: the factor then holds NaN from that
    column on, as the reference's does.
    """

    ctsf: BandedCTSF
    status: Optional[torch.Tensor] = None

    @classmethod
    def from_arrays(cls, grid, Dr, R, C, device=None) -> "CholeskyFactor":
        """Carry a factor over from the JAX package: its ``Dr``, ``R`` and
        ``C`` as numpy arrays and its grid, as
        :meth:`BandedCTSF.from_arrays` takes them; no status word."""
        return cls(BandedCTSF.from_arrays(grid, Dr, R, C, device=device))

    def logdet(self) -> torch.Tensor:
        """log det A = 2 * sum log diag(L); padded diagonal entries are 1."""
        g = self.ctsf.grid
        db = torch.diagonal(self.ctsf.Dr[..., 0, :, :], dim1=-2, dim2=-1)
        total = torch.log(torch.abs(db)).sum(dim=(-2, -1))
        nat = g.n_arrow_tiles
        if nat > 0:
            ar = torch.arange(nat, device=self.ctsf.C.device)
            dc = torch.diagonal(self.ctsf.C[..., ar, ar, :, :], dim1=-2, dim2=-1)
            total = total + torch.log(torch.abs(dc)).sum(dim=(-2, -1))
        return 2.0 * total


def _corner_dense_cholesky(c: torch.Tensor, impl: Optional[str]) -> torch.Tensor:
    """Blocked left-looking dense Cholesky of the (nat, nat, t, t) corner:
    per column one SYRK/GEMM contraction over the finalized columns, one
    ``potrf`` of the diagonal tile and one batched ``trsm`` of the column
    (all ``nat`` rows, as the reference does: nat launches of each)."""
    nat = c.shape[0]
    c = c.clone()
    for k in range(nat):
        rk = c[k, :k]                                   # L[k, :k]
        syrk_acc = torch.einsum("jab,jcb->ac", rk, rk)
        lkk = ops.potrf(c[k, k] - syrk_acc, impl=impl)
        col_k = c[:, k]
        gemm_acc = torch.einsum("mjab,jcb->mac", c[:, :k], rk)
        panel = ops.trsm(lkk, (col_k - gemm_acc).contiguous(), impl=impl)
        c[k + 1:, k] = panel[k + 1:]
        c[k, k] = lkk
    return c


def _factorize_window_impl(Dr, R, C, grid: TileGrid, impl: Optional[str],
                           tree_chunks: int, plan=None):
    """Window factorization: the band sweep, then the dense corner.

    With ``plan`` (a :class:`~repro_torch.core.ordering.PartitionPlan`) of
    more than one partition, the sweep runs over its independent
    partitions in one launch and their Schur leaves are combined by the
    GEADD tree before the corner.  Otherwise it is the fused kernel on the
    CUDA backend (``impl``, or the device when it is None) and the ring
    column loop on the plain one, so a trivial plan gives the plan-less
    factor bit for bit.

    Returns ``(Dr_L, R_L, C_L, status)``, ``status`` the (3,) float32 word
    ``[min_pivot, nonfinite, first_bad]`` over band and corner (a corner
    breakdown reports ``first_bad = ndt``)."""
    nat = grid.n_arrow_tiles
    if plan is not None and plan.n_tiles != grid.n_diag_tiles:
        raise ValueError(
            f"partition plan covers {plan.n_tiles} diagonal tiles but the grid has "
            f"{grid.n_diag_tiles}; rebuild the plan for this grid")
    if plan is not None and plan.n_partitions > 1:
        panels, R_out, schur, status = ops.band_cholesky_partitioned_sweep(
            band_row_to_col(Dr), R, plan.boundaries, impl=impl)
        # one Schur leaf per partition: the Alg. 3 binary tree combines them
        # before the shared corner
        combine = lambda leaves: tree_combine(leaves, impl=impl)
    else:
        nchunks = max(1, min(tree_chunks or 1, grid.n_diag_tiles or 1))
        panels, R_out, schur, status = ops.band_cholesky_sweep(
            band_row_to_col(Dr), R, nchunks=nchunks, impl=impl)
        # the chunks are the tree-reduction leaves; summing them is the
        # root combine of the paper's Alg. 3 chain
        combine = lambda leaves: leaves.sum(dim=0)
    Dr_out = band_col_to_row(panels)
    C_out = _corner_dense_cholesky(C - combine(schur), impl) if nat else C
    return Dr_out, R_out, C_out, fold_corner_status(
        status, C_out, grid.n_diag_tiles, nat)


def factorize_window(m: BandedCTSF, tree_chunks: int = 8,
                     options: Optional[SolverOptions] = None) -> CholeskyFactor:
    """Banded-arrowhead factorization on the device of ``m``.

    On the card the whole band + arrow block factorizes in one CUDA kernel
    launch and the corner with ``nat`` ``potrf`` and ``nat`` ``trsm``
    launches.  ``options`` (:class:`~repro_torch.core.options.SolverOptions`)
    can force the plain versions (``impl="ref"``) and pass a partition plan
    (``partition_plan``): with more than one partition the sweep is the
    partitioned kernel, one block a partition, and the corner adds
    ``ceil(log2 P)`` ``geadd`` launches.  A
    breakdown does not raise: the factor's ``status`` word reports it."""
    opts = options if options is not None else SolverOptions()
    Dr, R, C, status = _factorize_window_impl(
        m.Dr, m.R, m.C, m.grid, opts.impl, tree_chunks, opts.partition_plan)
    return CholeskyFactor(BandedCTSF(m.grid, Dr, R, C), status)
