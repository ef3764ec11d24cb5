"""Selected inversion of banded-arrowhead factors: the blocked Takahashi
recurrence.

With ``A = L L^T``, ``Σ = A^{-1}`` and the normalized factor column
``G_kj = L_kj L_jj^{-1}``:

    i > j:   Σ_ij = - Σ_{k>j} Σ_ik G_kj
    i = j:   Σ_jj = (L_jj L_jj^T)^{-1} - Σ_{k>j} Σ_kj^T G_kj

so column j of Σ needs only trailing columns, and for the banded-arrowhead
pattern the sums stay on the factor's own pattern: one backward sweep over
the band columns (``kernels.ops.selinv_sweep``, a pre-pass and a
recurrence launch on the card) computes every Σ entry of the band and the arrow exactly, seeded by
the corner ``Σ_cc = L_c^{-T} L_c^{-1}`` (one small dense triangular solve).

Port of the JAX package's ``core/selinv.py`` (``SelectedInverse``,
``_selinv_impl``, ``selected_inverse``, ``selinv_batched``).
:func:`selinv_batched` takes the θ-batch of ``factorize_window_batched``
in the same two launches as one factor: the pre-pass a block for each
column of each element, the recurrence a cluster an element.  An
embedded factor (``factor.source_grid``, or ``SolverOptions(policy=)``)
runs the recurrence on its canonical grid with the identity prefix
skipped through ``start_tile`` and is restricted back to the source grid
(``gridpolicy.restrict_selinv``); ``selinv_batched`` keeps what it builds
a key in the LRU cache ``batched_selinv``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple, Union

import numpy as np
import torch

from repro_torch.kernels import ops
from repro_torch.kernels.ring import band_col_to_row, band_row_to_col
from repro_torch.kernels.selinv import selinv_plan
from repro_torch.runtime import telemetry
from .batching import LRUCache, cut_batch, pad_batch
from .cholesky import BATCHED_CACHE, BatchedEntry, CholeskyFactor, _plannable
from .ctsf import BandedCTSF
from .options import SolverOptions
from .structure import TileGrid

__all__ = ["SelectedInverse", "selected_inverse", "selinv_batched"]


@dataclasses.dataclass
class SelectedInverse:
    """Band + arrow block of Σ = A^{-1} in banded-arrowhead tile layout.

    Dr: (ndt, bt+1, t, t)  band rows   — Dr[m, d] = Σ_tile[m, m-d]
    R:  (ndt, nat, t, t)   arrow rows  — R[k, i]  = Σ_tile[ndt+i, k]
    C:  (nat, nat, t, t)   corner      — C[i, j]  = Σ_tile[ndt+i, ndt+j] (lower)

    Leading batch axes (from :func:`selinv_batched`) are carried by
    :meth:`diagonal` and :meth:`covariance`, which index from the right.
    """

    grid: TileGrid
    Dr: torch.Tensor
    R: torch.Tensor
    C: torch.Tensor

    @classmethod
    def from_arrays(cls, grid: Union[TileGrid, Tuple[int, int, int, int]],
                    Dr, R, C, device=None) -> "SelectedInverse":
        """Carry a selected inverse over from the JAX package: numpy arrays
        and a grid, as :meth:`BandedCTSF.from_arrays` takes them."""
        m = BandedCTSF.from_arrays(grid, Dr, R, C, device=device)
        return cls(m.grid, m.Dr, m.R, m.C)

    def diagonal(self, padded: bool = False) -> torch.Tensor:
        """diag(Σ), INLA's posterior marginal variances of every latent at
        once: the unpadded (..., n) diagonal unless ``padded``, one row a
        batch element.  Host span ``selinv.diagonal``."""
        with telemetry.span("selinv.diagonal"):
            g = self.grid
            db = torch.diagonal(self.Dr[..., 0, :, :], dim1=-2, dim2=-1)   # (..., ndt, t)
            full = db.reshape(db.shape[:-2] + (-1,))
            if g.n_arrow_tiles:
                ar = torch.arange(g.n_arrow_tiles, device=self.C.device)
                dc = torch.diagonal(self.C[..., ar, ar, :, :], dim1=-2, dim2=-1)
                full = torch.cat([full, dc.reshape(dc.shape[:-2] + (-1,))], dim=-1)
            if padded:
                return full
            idx = g.padded_indices(np.arange(g.structure.n))
            return full[..., torch.as_tensor(idx, device=full.device)]

    def covariance(self, i: int, j: int) -> torch.Tensor:
        """Σ_ij for element indices of the original matrix, wherever the
        entry lies on the stored pattern: |i-j| within the tile band, or
        at least one index in the arrow block; ``(...)``, one value a batch
        element."""
        g = self.grid
        s = g.structure
        for v in (i, j):
            if not 0 <= int(v) < s.n:
                raise ValueError(f"index {v} out of range [0, {s.n})")
        pi, pj = g.padded_index(int(i)), g.padded_index(int(j))
        if pi < pj:
            pi, pj = pj, pi                              # Σ is symmetric
        bi, ri = divmod(pi, g.t)
        bj, rj = divmod(pj, g.t)
        ndt = g.n_diag_tiles
        if bi < ndt:                                     # band x band
            d = bi - bj
            if d > g.band_tiles:
                raise ValueError(f"covariance({i}, {j}) lies outside the stored band "
                                 f"(tile offset {d} > {g.band_tiles})")
            return self.Dr[..., bi, d, ri, rj]
        if bj < ndt:                                     # arrow row x band col
            return self.R[..., bj, bi - ndt, ri, rj]
        return self.C[..., bi - ndt, bj - ndt, ri, rj]   # corner (lower stored)

    def to_dense_band(self, lower_only: bool = False) -> np.ndarray:
        """The stored band + arrow entries as a dense (padded_n, padded_n)
        float32 array (zeros off the pattern), symmetrized unless
        ``lower_only``."""
        return BandedCTSF(self.grid, self.Dr, self.R, self.C).to_dense(lower_only=lower_only)

    def arrays(self) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        return self.Dr, self.R, self.C

    def nbytes(self) -> int:
        return int((self.Dr.numel() + self.R.numel() + self.C.numel()) * 4)


def _tril_tiles(sc_full: torch.Tensor) -> torch.Tensor:
    """The lower tile triangle of the (..., nat, nat, t, t) corner block
    (the storage convention shared with BandedCTSF)."""
    nat = sc_full.shape[-4]
    keep = torch.ones((nat, nat), dtype=torch.bool, device=sc_full.device).tril()
    return torch.where(keep[:, :, None, None], sc_full, torch.zeros_like(sc_full))


def corner_sigma(C: torch.Tensor) -> torch.Tensor:
    """The seed of the recurrence: the full (symmetric) corner block
    ``Σ_cc = L_c^{-T} L_c^{-1}`` of the factor's (..., nat, nat, t, t)
    corner, by one dense triangular solve (nat t square) and one product,
    each batched over the leading axes."""
    lead, nat, t = tuple(C.shape[:-4]), C.shape[-4], C.shape[-1]
    if not nat:
        return C.new_zeros(lead + (0, 0, t, t))
    nc = nat * t
    cd = C.transpose(-3, -2).reshape(lead + (nc, nc))
    eye = torch.eye(nc, dtype=C.dtype, device=C.device)
    winv = torch.linalg.solve_triangular(cd, eye, upper=False)
    return (winv.mT @ winv).reshape(lead + (nat, t, nat, t)).transpose(-3, -2).contiguous()


def _selinv_impl(Dr, R, C, grid: TileGrid, impl=None, start_tile: int = 0):
    """Blocked Takahashi sweep over one factor, or a batch of them (a
    leading axis on every array): ``(Sd, Sr, Sc)`` in the row-band /
    arrow-row / lower-corner layout of :class:`SelectedInverse`.
    ``start_tile`` declares the first columns an identity-embedding prefix.
    The device spans ``selinv.seed`` (the corner's Σ) and ``selinv.sweep``
    (the layout conversions, the pre-pass and the recurrence) split the
    time."""
    t, ndt, nat, bt = grid.t, grid.n_diag_tiles, grid.n_arrow_tiles, grid.band_tiles
    lead = tuple(Dr.shape[:-4])
    with telemetry.span("selinv.seed", device=True):
        sc_full = corner_sigma(C)
        sc = _tril_tiles(sc_full)
    with telemetry.span("selinv.sweep", device=True):
        if ndt == 0:
            return Dr.new_zeros(lead + (0, bt + 1, t, t)), R.new_zeros(lead + (0, nat, t, t)), sc
        panels, sr = ops.selinv_sweep(band_row_to_col(Dr), R, sc_full, start_tile, impl=impl)
        # panels[j, e] = Σ_{j+e, j} -> Sd[m, d] = Σ_{m, m-d}
        return band_col_to_row(panels), sr, sc


def selected_inverse(factor: CholeskyFactor, *,
                     options: Optional[SolverOptions] = None) -> SelectedInverse:
    """Band + arrow block of Σ = A^{-1} from a banded-arrowhead factor, by
    the blocked Takahashi recurrence: one backward tile sweep, whatever
    the number of entries wanted.  On the card the sweep is two CUDA
    launches, a pre-pass and the recurrence; ``options.impl`` forces a
    backend.  An embedded factor (``factor.source_grid``, or
    ``options.policy``) runs it on the canonical grid, the identity prefix
    skipped, and returns Σ on the source grid: every entry an exact entry
    of the source problem's inverse."""
    from .solve import _resolve_embedding
    opts = options if options is not None else SolverOptions()
    with telemetry.span("selinv.selected_inverse") as sp:
        c, src, pad = _resolve_embedding(factor, opts.policy)
        sp.tag(grid=telemetry.rung_tag(c.grid))
        out = SelectedInverse(c.grid, *_selinv_impl(c.Dr, c.R, c.C, c.grid, opts.impl, pad))
        if src is None:
            return out
        from .gridpolicy import restrict_selinv
        return restrict_selinv(out, src)


# what selinv_batched builds a key (core/batching.py), as the batched
# factorization's cache
_BATCHED_SELINV_CACHE = LRUCache(maxsize=BATCHED_CACHE, name="batched_selinv")


def _batched_selinv_fn(grid: TileGrid, opts: SolverOptions, use_start: bool = False
                       ) -> BatchedEntry:
    """The batched recurrence's entry for ``grid`` under ``(grid,
    opts.compile_key(), use_start)`` in the cache ``batched_selinv``: its
    ``call`` takes ``(Dr, R, C, start_tile)``, its plan is the
    recurrence's ``selinv_plan``."""
    key = (grid, opts.compile_key(), use_start)

    def build() -> BatchedEntry:
        plans = ({"selinv": selinv_plan(grid.t, grid.band_tiles, grid.n_arrow_tiles)}
                 if _plannable(grid) else {})
        return BatchedEntry(call=lambda dr, r, c, s: _selinv_impl(dr, r, c, grid, opts.impl, s),
                            plans=plans)

    return _BATCHED_SELINV_CACHE.get_or_create(key, build)


def selinv_batched(factor: CholeskyFactor, *, bucket: bool = True,
                   options: Optional[SolverOptions] = None) -> SelectedInverse:
    """Selected inversion of a batch of same-grid factors (a leading batch
    axis on the CTSF arrays, as ``factorize_window_batched`` returns them):
    a :class:`SelectedInverse` whose arrays carry the batch axis, and
    whose ``diagonal()`` and ``covariance(i, j)`` broadcast over it.  On
    the card the whole batch is one pre-pass launch (a block for each
    column of each element) and one recurrence launch (a cluster an
    element); each element's sweep is bit for bit the unbatched sweep's on
    its factor.  ``bucket`` pads the batch to the next power of two
    (repeating its last factor) and strips the padding's results.  An
    embedded factor (``factor.source_grid``, or ``options.policy``) runs
    on the canonical grid, the identity prefix skipped, and is restricted
    back to the source grid; the cache ``batched_selinv`` keys on the
    canonical grid, so a stream of grids on one rung shares one entry."""
    from .solve import _resolve_embedding
    opts = options if options is not None else SolverOptions()
    with telemetry.span("selinv.batched") as sp:
        with telemetry.span("selinv.prepare"):
            c, src, pad = _resolve_embedding(factor, opts.policy)
            if c.Dr.dim() != 5:
                raise ValueError(f"selinv_batched needs a leading batch axis, got Dr.ndim="
                                 f"{c.Dr.dim()}")
            sp.tag(b=c.Dr.shape[0], grid=telemetry.rung_tag(c.grid))
            entry = _batched_selinv_fn(c.grid, opts, use_start=src is not None)
            padded, nb = pad_batch((c.Dr, c.R, c.C), bucket)
        sd, sr, sc = cut_batch(entry.call(*padded, pad), nb)
        out = SelectedInverse(c.grid, sd, sr, sc)
        if src is None:
            return out
        from .gridpolicy import restrict_selinv
        return restrict_selinv(out, src)
