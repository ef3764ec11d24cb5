"""Plain PyTorch versions of the tile kernels.

They define what the CUDA kernels must compute, function for function with
the JAX package's ``kernels/ref.py``.  The CPU tests hold them to that
package, and ``chip_smoke.py`` holds each CUDA kernel to them on the card.
On a CUDA tensor nothing reaches them unless ``impl="ref"`` is passed
explicitly.  All work on float32 (t, t) tiles in the lower-triangular
Cholesky convention.
"""
from __future__ import annotations

import torch

from .ring import chunk_layout, identity_prefix_panel

__all__ = ["potrf_ref", "trsm_ref", "band_cholesky_sweep_ref",
           "sweep_status", "empty_sweep_status"]


def empty_sweep_status(device=None) -> torch.Tensor:
    """The healthy/empty status word: ``[+inf, 0, -1]``."""
    return torch.tensor([float("inf"), 0.0, -1.0], dtype=torch.float32,
                        device=device)


def sweep_status(panels: torch.Tensor, R_out: torch.Tensor) -> torch.Tensor:
    """Per-sweep breakdown status word ``[min_pivot, nonfinite, first_bad]``
    derived from the emitted factor (``panels (ndt, b1, t, t)``,
    ``R_out (ndt, nat, t, t)``):

    * ``min_pivot`` — min over columns of ``min(diag(L_kk)^2)``, over
      columns whose diagonal is finite (+inf if none are);
    * ``nonfinite`` — 1.0 iff any emitted panel/arrow entry is NaN/inf;
    * ``first_bad`` — first column whose output is non-finite or whose
      pivot is <= 0 (-1.0 when the sweep is clean).
    """
    ndt = panels.shape[0]
    if ndt == 0:
        return empty_sweep_status(panels.device)
    diag = torch.diagonal(panels[:, 0], dim1=-2, dim2=-1)          # (ndt, t)
    fin_diag = torch.isfinite(diag).all(dim=-1)
    inf = torch.tensor(float("inf"), dtype=torch.float32, device=diag.device)
    piv = torch.where(fin_diag, (diag * diag).amin(dim=-1), inf)
    fin = (torch.isfinite(panels).reshape(ndt, -1).all(dim=1)
           & torch.isfinite(R_out).reshape(ndt, -1).all(dim=1))
    bad = ~fin | (piv <= 0.0)
    idx = torch.arange(ndt, device=panels.device)
    first = torch.where(bad, idx, torch.full_like(idx, ndt)).amin()
    first = torch.where(first == ndt, torch.full_like(first, -1), first)
    return torch.stack([piv.amin(), (~fin).to(torch.float32).amax(),
                        first.to(torch.float32)])


def potrf_ref(a: torch.Tensor) -> torch.Tensor:
    """Cholesky of a (..., t, t) batch of tiles, L lower with A = L L^T.

    ``torch.linalg.cholesky`` raises on a non-PD tile where the JAX
    reference returns NaN in its lower triangle, so a failed tile is filled
    so here, which keeps the status word's semantics."""
    lo, info = torch.linalg.cholesky_ex(a)
    lower = torch.ones(a.shape[-2:], dtype=torch.bool, device=a.device).tril()
    bad = (info != 0).reshape(info.shape + (1, 1)) & lower
    return torch.where(bad, torch.full_like(lo, float("nan")), lo).contiguous()


def trsm_ref(l_kk: torch.Tensor, a_mk: torch.Tensor) -> torch.Tensor:
    """Off-diagonal panel solve ``X = A L^{-T}`` (``X L^T = A``), with L
    (t, t) broadcast over a (..., t, t) batch of A or batched alike."""
    xt = torch.linalg.solve_triangular(l_kk, a_mk.mT, upper=False)
    return xt.mT.contiguous()


def band_cholesky_sweep_ref(Ac: torch.Tensor, R: torch.Tensor,
                            nchunks: int = 1, start_tile: int = 0):
    """Whole band+arrow Cholesky sweep, column by column.

    Input:  Ac (ndt, bt+1, t, t) column-band tiles, Ac[k, e] = A[k+e, k]
            R  (ndt, nat, t, t)  arrow rows, R[k, i] = A[ndt+i, k]
    Output: panels (ndt, bt+1, t, t)      column panels of L
            R_out  (ndt, nat, t, t)       factored arrow rows
            schur  (nch, nat, nat, t, t)  per-chunk sums of R_out·R_outᵀ
                   (``nch = chunk_layout(ndt, nchunks)[1]``)
            status (3,) float32           breakdown word (:func:`sweep_status`)

    Column k reads only the last bt columns' outputs:

        U[e] = sum_{j=1..bt-e} L[k+e, k-j] L[k, k-j]^T
        V[i] = sum_{j=1..bt}   L[ndt+i, k-j] L[k, k-j]^T

    Columns ``k < start_tile`` are an identity-embedding prefix: their
    input is replaced by the identity column, whose factor is an identity
    panel with a zero arrow row.
    """
    ndt, b1, t, _ = Ac.shape
    bt = b1 - 1
    nat = R.shape[1]
    panels = torch.zeros_like(Ac)
    R_out = torch.zeros_like(R)
    id_col = identity_prefix_panel(bt, t, Ac.dtype, Ac.device)
    for k in range(ndt):
        a_col, r_col = (id_col, torch.zeros_like(R[k])) if k < start_tile \
            else (Ac[k], R[k])
        u = torch.zeros_like(a_col)
        v = torch.zeros_like(r_col)
        for j in range(1, min(bt, k) + 1):
            rhs = panels[k - j, j]                        # L[k, k-j]
            u[:b1 - j] += panels[k - j, j:] @ rhs.mT      # e = 0..bt-j
            if nat:
                v += R_out[k - j] @ rhs.mT
        lkk = potrf_ref(a_col[0] - u[0])
        panels[k, 0] = lkk
        if bt:
            panels[k, 1:] = trsm_ref(lkk, a_col[1:] - u[1:])
        if nat:
            R_out[k] = trsm_ref(lkk, r_col - v)
    csz, nch = chunk_layout(ndt, nchunks)
    rpad = torch.zeros((nch * csz,) + tuple(R_out.shape[1:]),
                       dtype=R_out.dtype, device=R_out.device)
    rpad[:ndt] = R_out
    rchunk = rpad.reshape((nch, csz) + tuple(R_out.shape[1:]))
    schur = torch.einsum("nkiab,nkjcb->nijac", rchunk, rchunk)
    return panels, R_out, schur, sweep_status(panels, R_out)
