"""Banded-arrowhead tile Cholesky factorization (the window backend).

:func:`factorize_window` factorizes a :class:`~repro_torch.core.ctsf.
BandedCTSF` in two phases:

* the band + arrow rows in one sweep (``kernels.ops.band_cholesky_sweep``):
  on the card a single CUDA kernel launch walks every band column; the
  plain version is a column loop.  The sweep also returns the
  corner-Schur complement as per-chunk partial sums, the leaves of the
  paper's Alg. 3 tree;
* the dense corner, ``C - sum(schur)``, column by column with the
  ``potrf`` and ``trsm`` tile kernels.

Port of the JAX package's ``core/cholesky.py`` (``_factorize_window_impl``
with the fused and ring modes, ``_corner_dense_cholesky`` and
``CholeskyFactor``).  Batched factorization, the task-list backend, the
bucketing policy, regularization and the partitioned sweep come with later
slices.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.kernels import ops
from repro_torch.kernels.ring import band_col_to_row, band_row_to_col
from .ctsf import BandedCTSF
from .options import SolverOptions
from .robustness import fold_corner_status
from .structure import TileGrid

__all__ = ["CholeskyFactor", "factorize_window"]


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
                           tree_chunks: int):
    """Window factorization: the one-launch sweep on the CUDA backend, the
    column loop on the plain one.  Returns ``(Dr_L, R_L, C_L, status)``,
    ``status`` the (3,) float32 word ``[min_pivot, nonfinite, first_bad]``
    over band and corner (a corner breakdown reports ``first_bad = ndt``)."""
    nat = grid.n_arrow_tiles
    nchunks = max(1, min(tree_chunks or 1, grid.n_diag_tiles or 1))
    panels, R_out, schur, status = ops.band_cholesky_sweep(
        band_row_to_col(Dr), R, nchunks=nchunks, impl=impl)
    Dr_out = band_col_to_row(panels)
    if nat:
        # the chunks are the tree-reduction leaves; summing them is the
        # root combine of the paper's Alg. 3 chain
        C_out = _corner_dense_cholesky(C - schur.sum(dim=0), impl)
    else:
        C_out = C
    return Dr_out, R_out, C_out, fold_corner_status(
        status, C_out, grid.n_diag_tiles, nat)


def factorize_window(m: BandedCTSF, tree_chunks: int = 8,
                     options: Optional[SolverOptions] = None) -> CholeskyFactor:
    """Banded-arrowhead factorization on the device of ``m``.

    On the card the whole band + arrow block factorizes in one CUDA kernel
    launch and the corner with ``nat`` ``potrf`` and ``nat`` ``trsm``
    launches; ``options`` (:class:`~repro_torch.core.options.SolverOptions`)
    can force the plain versions (``impl="ref"``).  A breakdown does not
    raise: the factor's ``status`` word reports it."""
    opts = options if options is not None else SolverOptions()
    Dr, R, C, status = _factorize_window_impl(
        m.Dr, m.R, m.C, m.grid, opts.impl, tree_chunks)
    return CholeskyFactor(BandedCTSF(m.grid, Dr, R, C), status)
