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

__all__ = ["potrf_ref", "trsm_ref", "syrk_ref", "gemm_ref", "geadd_ref",
           "solve_panel_ref", "selinv_step_ref", "band_update_ref",
           "band_update_unrolled_ref", "band_forward_sweep_ref",
           "band_backward_sweep_ref", "band_cholesky_sweep_ref",
           "band_cholesky_partitioned_sweep_ref", "selinv_sweep_ref", "selinv_prepass_ref",
           "sweep_status", "combine_sweep_status", "empty_sweep_status",
           "check_boundaries"]


def empty_sweep_status(device=None) -> torch.Tensor:
    """The healthy/empty status word: ``[+inf, 0, -1]``."""
    return torch.tensor([float("inf"), 0.0, -1.0], dtype=torch.float32,
                        device=device)


def sweep_status(panels: torch.Tensor, R_out: torch.Tensor) -> torch.Tensor:
    """Per-sweep breakdown status word ``[min_pivot, nonfinite, first_bad]``
    derived from the emitted factor (``panels (..., ndt, b1, t, t)``,
    ``R_out (..., ndt, nat, t, t)``; one word per leading index):

    * ``min_pivot`` — min over columns of ``min(diag(L_kk)^2)``, over
      columns whose diagonal is finite (+inf if none are);
    * ``nonfinite`` — 1.0 iff any emitted panel/arrow entry is NaN/inf;
    * ``first_bad`` — first column whose output is non-finite or whose
      pivot is <= 0 (-1.0 when the sweep is clean).
    """
    ndt = panels.shape[-4]
    if ndt == 0:
        return empty_sweep_status(panels.device).expand(panels.shape[:-4] + (3,)).clone()
    diag = torch.diagonal(panels[..., 0, :, :], dim1=-2, dim2=-1)  # (..., ndt, t)
    fin_diag = torch.isfinite(diag).all(dim=-1)
    piv = (diag * diag).amin(dim=-1)
    piv = torch.where(fin_diag, piv, torch.full_like(piv, float("inf")))
    fin = (torch.isfinite(panels).flatten(-3).all(dim=-1)
           & torch.isfinite(R_out).flatten(-3).all(dim=-1))
    bad = ~fin | (piv <= 0.0)
    idx = torch.arange(ndt, device=panels.device)
    first = torch.where(bad, idx, torch.full_like(idx, ndt)).amin(dim=-1)
    first = torch.where(first == ndt, torch.full_like(first, -1), first)
    return torch.stack([piv.amin(dim=-1), (~fin).to(torch.float32).amax(dim=-1),
                        first.to(torch.float32)], dim=-1)


def _over_batch(fn, *arrays, **kwargs):
    """``fn`` on each element of the arrays' leading batch axis, its
    outputs stacked: a batched sweep's plain version, element for element
    the unbatched one."""
    outs = [fn(*(x[i] for x in arrays), **kwargs) for i in range(arrays[0].shape[0])]
    return tuple(torch.stack(parts) for parts in zip(*outs))


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


def syrk_ref(c_kk: torch.Tensor, a_kn: torch.Tensor) -> torch.Tensor:
    """Symmetric rank-t update of a diagonal tile, the full tile:
    ``C - A A^T``."""
    return c_kk - a_kn @ a_kn.mT


def gemm_ref(c_mk: torch.Tensor, a_mn: torch.Tensor, b_kn: torch.Tensor) -> torch.Tensor:
    """Off-diagonal accumulation ``C - A B^T``, batched over leading dims
    with A and B broadcast against C."""
    return c_mk - a_mn @ b_kn.mT


def geadd_ref(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Generalized addition (the tree-reduction combine step, paper
    Fig. 6): ``A + B``."""
    return a + b


def solve_panel_ref(l_kk: torch.Tensor, b_panel: torch.Tensor,
                    trans: bool = False) -> torch.Tensor:
    """Multi-RHS triangular panel solve: ``L X = B`` (or ``L^T X = B``) for
    a (..., t, k) panel of k right-hand sides, one L (t, t) for the
    panels' whole batch, or one L for each panel, ``l_kk (..., t, t)``
    (each panel then solved alone, so the batch is a loop of unbatched
    calls bit for bit)."""
    if l_kk.dim() > 2:
        t, k = b_panel.shape[-2:]
        outs = [solve_panel_ref(l, b, trans) for l, b in
                zip(l_kk.reshape(-1, t, t), b_panel.reshape(-1, t, k))]
        return torch.stack(outs).reshape(b_panel.shape) if outs else torch.empty_like(b_panel)
    if trans:
        return torch.linalg.solve_triangular(l_kk.mT, b_panel, upper=True)
    return torch.linalg.solve_triangular(l_kk, b_panel, upper=False)


def selinv_step_ref(s_row: torch.Tensor, g_col: torch.Tensor) -> torch.Tensor:
    """One Takahashi tile step: ``u[e] = sum_j s_row[e, j] @ g_col[j]`` for
    ``s_row (e_n, j_n, t, t)`` already-computed Σ tiles and ``g_col (j_n,
    t, t)`` the normalized factor column ``G[k_j] = L[k_j, j] L[j, j]^{-1}``."""
    return torch.einsum("ejab,jbc->eac", s_row, g_col)


def band_update_unrolled_ref(w: torch.Tensor) -> torch.Tensor:
    """The band update of :func:`band_update_ref` over the structurally
    nonzero pairs only, ``b (b+1) / 2`` tile products summed one after
    another, ``j = 1..b-e`` in order; what ``ops.band_update`` runs on the
    plain backend for ``b + 1 <= 6``, as the reference's dispatch does."""
    b1 = w.shape[-4]
    outs = []
    for e in range(b1):
        acc = torch.zeros_like(w[..., 0, 0, :, :])
        for j in range(1, b1 - e):
            acc = acc + w[..., e, e + j, :, :] @ w[..., 0, j, :, :].mT
        outs.append(acc)
    return torch.stack(outs, dim=-3)


def band_update_ref(w: torch.Tensor) -> torch.Tensor:
    """Fused left-looking band-panel update (the ``window`` sweep's hot spot).

    Input:  w (..., b+1, b+1, t, t) — band-window rows k..k+b of the
            row-band storage: w[e, d] = L_tile[k+e, k+e-d] (zero where out
            of band).
    Output: u (..., b+1, t, t) with

        u[e] = sum_{j=1..b-e}  w[e, e+j] @ w[0, j]^T

    every SYRK (e = 0) and GEMM (e > 0) accumulation feeding panel k, as
    one masked contraction over the shifted gather ``w[e, e+j]``."""
    b1 = w.shape[-4]
    idx = torch.arange(b1, device=w.device)
    e_idx, j_idx = idx[:, None], idx[None, :]
    mask = ((e_idx + j_idx) < b1) & (j_idx >= 1)
    wsh = w[..., e_idx, (e_idx + j_idx).clamp(max=b1 - 1), :, :]
    wsh = torch.where(mask[:, :, None, None], wsh, torch.zeros_like(wsh))
    rhs = w[..., 0, :, :, :]
    rhs = torch.where((idx >= 1)[:, None, None], rhs, torch.zeros_like(rhs))
    return torch.einsum("...ejab,...jcb->...eac", wsh, rhs)


def band_forward_sweep_ref(Dr: torch.Tensor, R: torch.Tensor, bd: torch.Tensor,
                           start_tile: int = 0):
    """Multi-RHS forward band sweep: ``L Y = B`` over the band rows, one
    ``solve_panel`` per tile row.

    Input:  Dr (ndt, bt+1, t, t) row-band factor tiles, Dr[m, j] = L[m, m-j]
            R  (ndt, nat, t, t)  arrow rows, R[m, i] = L[ndt+i, m]
            bd (ndt, t, k)       RHS tile panel
    Output: yd (ndt, t, k)       with L Y = B on the band
            acc_a (nat, t, k)    = sum_m R[m, i] @ Y_m  (arrow-RHS correction)

    Rows ``m < start_tile`` are never visited and stay zero (the caller
    guarantees the RHS is zero there).  A leading batch axis on every input
    gives the outputs one too, each element the unbatched sweep's.
    """
    if Dr.dim() == 5:
        return _over_batch(band_forward_sweep_ref, Dr, R, bd, start_tile=start_tile)
    ndt, b1 = Dr.shape[:2]
    bt = b1 - 1
    yd = torch.zeros_like(bd)
    for m in range(start_tile, ndt):
        # Y_m = Lmm^{-1} (B_m - sum_{j=1..bt} L[m, m-j] Y_{m-j}); Dr[m, j] is
        # structurally zero for j > m and rows above start_tile are zero
        jmax = min(bt, m)
        acc = torch.einsum("jab,jbk->ak", Dr[m, 1:jmax + 1],
                           yd[m - jmax:m].flip(0)) if jmax else 0.0
        yd[m] = solve_panel_ref(Dr[m, 0], bd[m] - acc)
    acc_a = torch.einsum("niab,nbk->iak", R, yd)
    return yd, acc_a


def band_backward_sweep_ref(Dr: torch.Tensor, R: torch.Tensor, yd: torch.Tensor,
                            xa: torch.Tensor, start_tile: int = 0) -> torch.Tensor:
    """Multi-RHS backward band sweep: ``L^T X = Y - R^T Xa`` over the band
    rows in reverse, one ``solve_panel(trans=True)`` per tile row.

    Input:  Dr (ndt, bt+1, t, t), R (ndt, nat, t, t) as in the forward sweep
            yd (ndt, t, k)  forward-solved band panel
            xa (nat, t, k)  already-solved arrow panel
    Output: xd (ndt, t, k) with
            X_m = Lmm^{-T}(Y_m - sum_j L[m+j,m]^T X_{m+j} - sum_i R[m,i]^T Xa_i)

    The walk stops before ``start_tile``: rows ``m < start_tile`` (an
    identity-diagonal prefix with zero RHS) are left zero.  A leading batch
    axis is taken as :func:`band_forward_sweep_ref` takes it.
    """
    if Dr.dim() == 5:
        return _over_batch(lambda *a, **kw: (band_backward_sweep_ref(*a, **kw),),
                           Dr, R, yd, xa, start_tile=start_tile)[0]
    ndt, b1 = Dr.shape[:2]
    bt = b1 - 1
    nat = R.shape[1]
    xd = torch.zeros_like(yd)
    for m in range(ndt - 1, start_tile - 1, -1):
        jmax = min(bt, ndt - 1 - m)
        # L[m+j, m] = Dr[m+j, j]
        sub = torch.stack([Dr[m + j, j] for j in range(1, jmax + 1)]) if jmax else None
        acc = torch.einsum("jab,jak->bk", sub, xd[m + 1:m + 1 + jmax]) if jmax else 0.0
        if nat:
            acc = acc + torch.einsum("iab,iak->bk", R[m], xa)
        xd[m] = solve_panel_ref(Dr[m, 0], yd[m] - acc, trans=True)
    return xd


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

    A leading batch axis on ``Ac`` and ``R`` (``(B, ndt, ...)``) gives every
    output one too, each element the unbatched sweep's of its inputs.
    """
    if Ac.dim() == 5:
        return _over_batch(band_cholesky_sweep_ref, Ac, R, nchunks=nchunks,
                           start_tile=start_tile)
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


def combine_sweep_status(words: torch.Tensor) -> torch.Tensor:
    """Fold per-partition status words ``(..., P, 3)``, ``first_bad``
    already in global column indices, into one word each: the least pivot,
    the largest nonfinite flag and the smallest non-negative ``first_bad``
    (-1 when every partition is clean).  An empty stack folds to
    :func:`empty_sweep_status`."""
    if words.shape[-2] == 0:
        return empty_sweep_status(words.device).expand(words.shape[:-2] + (3,)).clone()
    first = words[..., 2]
    best = torch.where(first >= 0, first, torch.full_like(first, float("inf"))).amin(dim=-1)
    return torch.stack([words[..., 0].amin(dim=-1), words[..., 1].amax(dim=-1),
                        torch.where(torch.isfinite(best), best, torch.full_like(best, -1.0))],
                       dim=-1)


def check_boundaries(boundaries, ndt: int) -> tuple:
    """``boundaries`` as a tuple of ints, or ValueError unless it rises
    strictly from 0 to ``ndt``."""
    bounds = tuple(int(b) for b in boundaries)
    if len(bounds) < 2 or bounds[0] != 0 or bounds[-1] != ndt or \
            any(b1 <= b0 for b0, b1 in zip(bounds, bounds[1:])):
        raise ValueError(f"boundaries {bounds!r} must be strictly increasing from 0 "
                         f"to ndt={ndt}")
    return bounds


def band_cholesky_partitioned_sweep_ref(Ac: torch.Tensor, R: torch.Tensor, boundaries,
                                        start_tile: int = 0):
    """Partition-parallel band+arrow Cholesky sweep.

    ``boundaries`` ``(0, c_1, ..., ndt)`` cut the band into partitions,
    partition ``p`` owning columns ``[boundaries[p], boundaries[p+1])``;
    the input must be block-separable across the cuts (no band tile
    crosses one, what ``core.ordering.detect_partition_plan`` certifies).
    Each partition then factorizes on its own: :func:`band_cholesky_sweep_ref`
    on its slice with one Schur chunk.

    Output: panels (ndt, bt+1, t, t), R_out (ndt, nat, t, t) as the fused
            sweep's;
            schur (P, nat, nat, t, t) one corner-Schur partial sum per
            partition (the tree-reduction leaves);
            status (3,) the partitions' words folded by
            :func:`combine_sweep_status`, ``first_bad`` global.

    Columns ``k < start_tile`` (global) are the identity prefix, so
    partition ``p`` skips its first ``max(0, start_tile - boundaries[p])``.
    A leading batch axis is taken as :func:`band_cholesky_sweep_ref` takes it.
    """
    if Ac.dim() == 5:
        return _over_batch(band_cholesky_partitioned_sweep_ref, Ac, R,
                           boundaries=boundaries, start_tile=start_tile)
    bounds = check_boundaries(boundaries, Ac.shape[0])
    panels, r_out, schurs, words = [], [], [], []
    for s0, s1 in zip(bounds, bounds[1:]):
        p, r, sch, w = band_cholesky_sweep_ref(Ac[s0:s1], R[s0:s1], nchunks=1,
                                               start_tile=max(0, start_tile - s0))
        panels.append(p)
        r_out.append(r)
        schurs.append(sch[0])
        words.append(torch.cat([w[:2], torch.where(w[2:] >= 0, w[2:] + s0, w[2:])]))
    return (torch.cat(panels), torch.cat(r_out), torch.stack(schurs),
            combine_sweep_status(torch.stack(words)))


def selinv_sweep_ref(lcol: torch.Tensor, R: torch.Tensor, sc_full: torch.Tensor,
                     start_tile: int = 0):
    """Whole backward Takahashi recurrence, column by column.

    Input:  lcol (ndt, bt+1, t, t) column view of the factor,
            lcol[j, d] = L[j+d, j] (zero past ndt)
            R (ndt, nat, t, t) arrow rows, R[j, i] = L[ndt+i, j]
            sc_full (nat, nat, t, t) full (symmetric) corner Σ seed
    Output: panels (ndt, bt+1, t, t)  Σ columns: panels[j, e] = Σ[j+e, j]
            acols  (ndt, nat, t, t)   arrow entries: acols[j, i] = Σ[ndt+i, j]

    Each step contracts the Σ block row visible from column j (band window
    + arrow rows + corner) against the normalized factor column
    ``G_kj = L_kj L_jj^{-1}`` (one :func:`selinv_step_ref`), walking
    columns j = ndt-1..0 and reading the last bt computed Σ columns (zero
    past ndt).  Columns ``j < start_tile`` are an identity-embedding
    prefix: the identity column is fed through the step, which emits an
    identity Σ panel and a zero arrow row.  A leading batch axis on every
    input (``sc_full`` too) is taken as :func:`band_forward_sweep_ref`
    takes it.
    """
    if lcol.dim() == 5:
        return _over_batch(selinv_sweep_ref, lcol, R, sc_full, start_tile=start_tile)
    ndt, b1, t, _ = lcol.shape
    bt = b1 - 1
    nat = R.shape[1]
    eye = torch.eye(t, dtype=lcol.dtype, device=lcol.device)
    # Σ columns with bt zero columns past the end, the ring's zero init
    panels = torch.zeros((ndt + bt, b1, t, t), dtype=lcol.dtype, device=lcol.device)
    acols = torch.zeros((ndt + bt, nat, t, t), dtype=lcol.dtype, device=lcol.device)
    id_col = identity_prefix_panel(bt, t, lcol.dtype, lcol.device)
    for j in range(ndt - 1, -1, -1):
        lc, rc = (id_col, torch.zeros_like(R[j])) if j < start_tile else (lcol[j], R[j])
        winv = solve_panel_ref(lc[0], eye)                 # L_jj^{-1}
        s0 = winv.mT @ winv                                # (L_jj L_jj^T)^{-1}
        g = lc[1:] @ winv                                  # G_d = L_{j+d,j} L_jj^{-1}
        ga = rc @ winv                                     # Ga_i = R[j,i] L_jj^{-1}
        gcat = torch.cat([g, ga])                          # (bt+nat, t, t)
        # Σ block row visible from column j, rows (j+1..j+bt, arrow):
        #   band e, band d:  e>=d -> Σ col j+d at e-d; e<d -> (Σ col j+e at d-e)^T
        #   band e, arrow i: (arrow Σ of col j+e)[i]^T
        #   arrow i, band d: (arrow Σ of col j+d)[i];  arrow i, arrow i': Σ_cc[i, i']
        srow = torch.zeros((bt + nat, bt + nat, t, t), dtype=lcol.dtype,
                           device=lcol.device)
        for e in range(1, bt + 1):
            for d in range(1, bt + 1):
                srow[e - 1, d - 1] = (panels[j + d, e - d] if e >= d
                                      else panels[j + e, d - e].mT)
            srow[e - 1, bt:] = acols[j + e].mT
        for d in range(1, bt + 1):
            srow[bt:, d - 1] = acols[j + d]
        srow[bt:, bt:] = sc_full
        off = -selinv_step_ref(srow, gcat)                 # (bt+nat, t, t)
        # diagonal: Σ_jj = s0 - Σ_{k>j} Σ_kj^T G_kj  (off = the fresh Σ_kj)
        sjj = s0 - torch.einsum("kba,kbc->ac", off, gcat)
        panels[j, 0] = 0.5 * (sjj + sjj.mT)
        panels[j, 1:] = off[:bt]
        acols[j] = off[bt:]
    return panels[:ndt], acols[:ndt]


def selinv_prepass_ref(lcol: torch.Tensor, R: torch.Tensor, sc_full: torch.Tensor,
                       start_tile: int = 0) -> torch.Tensor:
    """What each column of :func:`selinv_sweep_ref` needs of the factor and
    the corner seed alone, not of Σ: ``work (ndt, bt + 2 nat + 2, t, t)``,
    per column j the tiles

    * ``[0, bt)``: ``G_d = L[j+d, j] W``, d = 1..bt (zero past ndt),
    * ``[bt, bt+nat)``: ``Ga_i = R[j, i] W``,
    * ``[bt+nat, bt+2 nat)``: the corner part of the arrow targets,
      ``sum_i' sc[i, i'] Ga_i'``,
    * ``bt+2 nat``: ``s0 = W^T W``, and ``bt+2 nat+1``: ``W = L_jj^{-1}``;

    an identity-prefix column (``j < start_tile``) has ``W = s0 = I`` and
    zeros elsewhere.  The CUDA sweep computes these for all columns at once
    before its recurrence.  A leading batch axis as in
    :func:`selinv_sweep_ref`."""
    if lcol.dim() == 5:
        return _over_batch(lambda *a, **kw: (selinv_prepass_ref(*a, **kw),),
                           lcol, R, sc_full, start_tile=start_tile)[0]
    ndt, b1, t, _ = lcol.shape
    bt, nat = b1 - 1, R.shape[1]
    eye = torch.eye(t, dtype=lcol.dtype, device=lcol.device)
    work = lcol.new_zeros((ndt, bt + 2 * nat + 2, t, t))
    for j in range(ndt):
        if j < start_tile:
            work[j, -2:] = eye
            continue
        winv = solve_panel_ref(lcol[j, 0], eye)
        work[j, :bt] = lcol[j, 1:] @ winv
        work[j, bt:bt + nat] = R[j] @ winv
        work[j, bt + nat:bt + 2 * nat] = torch.einsum("iqab,qbc->iac", sc_full,
                                                      work[j, bt:bt + nat])
        work[j, -2] = winv.mT @ winv
        work[j, -1] = winv
    return work
