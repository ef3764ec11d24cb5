"""Canonical-grid bucketing for mixed-size traffic.

Every distinct :class:`~repro_torch.core.structure.TileGrid` that reaches
the batched entry points (``factorize_window_batched``,
``solve_many_batched``, ``selinv_batched``, ``concurrent_*``) builds its
own bound callable and launch plans (``core/batching.py``'s LRU caches),
and every distinct corner shape its own CUDA graphs
(``solve.corner_graph_key``), so traffic mixing problem sizes churns
those caches.  This module trades a little padded compute for a bounded
set of built things:

* :class:`GridBucketPolicy` maps any grid to a small canonical set —
  ``n_diag_tiles`` rounds up pow2-style, ``band_tiles`` and
  ``n_arrow_tiles`` round up to policy rungs — so a mixed-grid workload
  builds O(#canonical rungs) entries instead of O(#distinct grids).
* :func:`embed_ctsf` pads a :class:`~repro_torch.core.ctsf.BandedCTSF`
  onto the canonical grid with identity diagonal tiles and zero band and
  arrow slack: ``blockdiag(I_prefix, A)`` with an identity-extended
  corner, whose factor, solves, log-determinant and selected inverse are
  exact on the original entries (:func:`restrict_factor`,
  :func:`restrict_selinv` and :func:`restrict_rhs` slice them back out).
* The identity prefix occupies band tiles ``0 .. pad_diag-1``; every sweep
  kernel skips it through its ``start_tile``, so diagonal slack costs
  almost nothing.  Band and arrow widening does cost operations;
  :func:`padded_flop_overhead` counts them.

Embedding layout (source grid ``g`` -> canonical grid ``cg``)::

    pad_diag  = cg.n_diag_tiles  - g.n_diag_tiles   (identity prefix)
    pad_band  = cg.band_tiles    - g.band_tiles     (zero band slack)
    pad_arrow = cg.n_arrow_tiles - g.n_arrow_tiles  (identity corner tail)

    Dr_c[pad_diag + m, d] = Dr[m, d]    Dr_c[m < pad_diag, 0] = I
    R_c[pad_diag + k, i]  = R[k, i]     (zero for prefix rows / i >= nat)
    C_c[i, j] = C[i, j]                 C_c[i >= nat, i] = I

Port of the JAX package's ``core/gridpolicy.py``.  The arrays keep their
device and leading batch axes.
"""
from __future__ import annotations

import dataclasses
from typing import Iterable, Sequence, Tuple

import torch

from repro_torch.runtime import telemetry
from .batching import next_pow2
from .ctsf import BandedCTSF
from .structure import TileGrid

__all__ = ["GridBucketPolicy", "assemble_rung_batch", "assemble_rung_rhs",
           "embed_ctsf", "embed_rhs", "restrict_rhs", "restrict_factor",
           "restrict_selinv", "padded_flop_overhead"]


def _round_to_rungs(v: int, rungs: Sequence[int]) -> int:
    """The smallest rung >= v; past the top rung, the next power of two."""
    for r in rungs:
        if r >= v:
            return r
    return next_pow2(v)


@dataclasses.dataclass(frozen=True)
class GridBucketPolicy:
    """Maps tile grids onto a small canonical set.

    Attributes:
      band_rungs:  allowed canonical ``band_tiles`` values (ascending).
      arrow_rungs: allowed canonical ``n_arrow_tiles`` values (ascending).
      min_diag_tiles: floor for the pow2-rounded ``n_diag_tiles``.

    Canonical grids are built with :meth:`TileGrid.from_tile_counts`, so
    two grids that land on the same rungs give equal (hashable-equal)
    canonical grids: what collapses the per-grid caches.  Values above the
    top rung round up to the next power of two."""

    band_rungs: Tuple[int, ...] = (1, 2, 4, 8, 16)
    arrow_rungs: Tuple[int, ...] = (0, 1, 2, 4)
    min_diag_tiles: int = 4

    def __post_init__(self):
        for name in ("band_rungs", "arrow_rungs"):
            rungs = getattr(self, name)
            if not rungs or list(rungs) != sorted(set(rungs)):
                raise ValueError(f"{name} must be ascending and non-empty")
        if self.band_rungs[0] < 1:
            raise ValueError("band_rungs must start at >= 1 (a multi-tile "
                             "diagonal always has band_tiles >= 1)")
        if self.min_diag_tiles < 1:
            raise ValueError("min_diag_tiles must be >= 1")

    def rungs_for(self, grid: TileGrid) -> Tuple[int, int, int]:
        """Canonical (n_diag_tiles, band_tiles, n_arrow_tiles) for a grid."""
        ndt, bt, nat = grid.n_diag_tiles, grid.band_tiles, grid.n_arrow_tiles
        nat_c = _round_to_rungs(nat, self.arrow_rungs) if nat else 0
        if ndt == 0:
            return 0, 0, nat_c
        bt_c = _round_to_rungs(max(bt, 1), self.band_rungs)
        ndt_c = max(next_pow2(ndt), self.min_diag_tiles)
        while ndt_c - 1 < bt_c:          # from_tile_counts needs bt <= ndt-1
            ndt_c *= 2
        return ndt_c, bt_c, nat_c

    def canonicalize(self, grid: TileGrid) -> TileGrid:
        """The canonical grid a problem on ``grid`` embeds into (same tile
        size; only the tile counts are bucketed).

        When telemetry is enabled each call counts a hit on the chosen
        rung (``gridpolicy.rung_hit{rung=...}``) and observes the padded
        flop overhead of the embedding (the
        ``gridpolicy.padded_flop_overhead`` histogram): the two numbers
        that say whether the policy's rung set fits the traffic."""
        cgrid = TileGrid.from_tile_counts(grid.t, *self.rungs_for(grid))
        if telemetry.enabled():
            telemetry.inc("gridpolicy.rung_hit", rung=telemetry.rung_tag(cgrid))
            telemetry.observe("gridpolicy.padded_flop_overhead",
                              padded_flop_overhead(grid, cgrid))
        return cgrid

    def join(self, grids: Iterable[TileGrid]) -> TileGrid:
        """The smallest canonical grid every grid of ``grids`` embeds into:
        the shared rung ``concurrent.stack_ctsf`` stacks unequal structures
        on.  All grids must share one tile size."""
        grids = list(grids)
        if not grids:
            raise ValueError("join needs at least one grid")
        ts = {g.t for g in grids}
        if len(ts) > 1:
            raise ValueError(f"cannot join grids with mixed tile sizes {sorted(ts)}")
        rungs = [self.rungs_for(g) for g in grids]
        # the elementwise max of rung triples is itself one: bt_c > 0 means
        # some grid was banded, and its ndt_c - 1 >= bt_c already
        return TileGrid.from_tile_counts(grids[0].t, *(max(r[i] for r in rungs)
                                                       for i in range(3)))


def _check_embeddable(grid: TileGrid, cgrid: TileGrid) -> Tuple[int, int, int]:
    """Pad widths (diag, band, arrow) of the embedding, checked to be one.
    A band-less source embeds into a banded canonical grid too: its whole
    band part is identity prefix."""
    if grid.t != cgrid.t:
        raise ValueError(f"tile size mismatch: {grid.t} vs {cgrid.t}")
    pads = (cgrid.n_diag_tiles - grid.n_diag_tiles,
            cgrid.band_tiles - grid.band_tiles,
            cgrid.n_arrow_tiles - grid.n_arrow_tiles)
    if min(pads) < 0:
        raise ValueError(
            f"grid (ndt={grid.n_diag_tiles}, bt={grid.band_tiles}, "
            f"nat={grid.n_arrow_tiles}) does not embed into canonical "
            f"(ndt={cgrid.n_diag_tiles}, bt={cgrid.band_tiles}, "
            f"nat={cgrid.n_arrow_tiles})")
    return pads


def _lead_pad(x: torch.Tensor, spec) -> torch.Tensor:
    """Zero padding of the trailing ``len(spec)`` axes by ``(before, after)``
    pairs, leading batch axes left as they are."""
    lead = x.shape[:x.dim() - len(spec)]
    shape = lead + tuple(n + a + b for n, (a, b) in zip(x.shape[x.dim() - len(spec):], spec))
    out = x.new_zeros(shape)
    idx = (Ellipsis,) + tuple(slice(a, a + n) for n, (a, _) in
                              zip(x.shape[x.dim() - len(spec):], spec))
    out[idx] = x
    return out


def _embed_arrays(Dr, R, C, grid: TileGrid, cgrid: TileGrid):
    """Identity-diagonal embedding of (possibly batched) CTSF arrays, for
    matrices and factors alike: the Cholesky factor of ``blockdiag(I, A)``
    is ``blockdiag(I, L)``, so embedding commutes with factorization."""
    pad_d, pad_b, pad_a = _check_embeddable(grid, cgrid)
    ident = torch.eye(grid.t, dtype=Dr.dtype, device=Dr.device)
    Dr_c = _lead_pad(Dr, [(pad_d, 0), (0, pad_b), (0, 0), (0, 0)])
    if pad_d:
        Dr_c[..., :pad_d, 0, :, :] = ident
    R_c = _lead_pad(R, [(pad_d, 0), (0, pad_a), (0, 0), (0, 0)])
    C_c = _lead_pad(C, [(0, pad_a), (0, pad_a), (0, 0), (0, 0)])
    for i in range(grid.n_arrow_tiles, cgrid.n_arrow_tiles):
        C_c[..., i, i, :, :] = ident
    return Dr_c, R_c, C_c


def embed_ctsf(mat: BandedCTSF, cgrid: TileGrid) -> BandedCTSF:
    """Embed a banded-arrowhead matrix (or factor) into a canonical grid:
    ``blockdiag(I_prefix, A)`` with the corner extended by identity tiles,
    SPD iff ``A`` is, factor ``blockdiag(I, L)``, ``logdet`` unchanged and
    ``Σ = blockdiag(I, A^{-1})``.  Leading batch axes pass through."""
    return BandedCTSF(cgrid, *_embed_arrays(mat.Dr, mat.R, mat.C, mat.grid, cgrid))


def _restrict_arrays(Dr, R, C, cgrid: TileGrid, grid: TileGrid):
    pad_d, _, _ = _check_embeddable(grid, cgrid)
    ndt, b1, nat = grid.n_diag_tiles, grid.band_tiles + 1, grid.n_arrow_tiles
    return (Dr[..., pad_d:pad_d + ndt, :b1, :, :].contiguous(),
            R[..., pad_d:pad_d + ndt, :nat, :, :].contiguous(),
            C[..., :nat, :nat, :, :].contiguous())


def restrict_factor(factor, grid: TileGrid = None):
    """Slice an embedded Cholesky factor back onto its source grid, the
    inverse of factorizing ``embed_ctsf(A, cgrid)``; ``grid`` defaults to
    ``factor.source_grid``.  As the reference's, the result is the bare
    factor: the status word (its ``first_bad`` counts canonical columns)
    and ``info`` stay on the embedded factor."""
    from .cholesky import CholeskyFactor
    grid = grid or factor.source_grid
    if grid is None:
        raise ValueError("restrict_factor needs a source grid (factor has "
                         "no source_grid and none was given)")
    c = factor.ctsf
    return CholeskyFactor(BandedCTSF(grid, *_restrict_arrays(c.Dr, c.R, c.C, c.grid, grid)))


def restrict_selinv(sel, grid: TileGrid):
    """Slice an embedded selected inverse back onto its source grid; the
    entries kept are exact entries of the original ``A^{-1}`` (the prefix
    is decoupled: ``Σ_embedded = blockdiag(I, Σ)``)."""
    from .selinv import SelectedInverse
    return SelectedInverse(grid, *_restrict_arrays(sel.Dr, sel.R, sel.C, sel.grid, grid))


def embed_rhs(B: torch.Tensor, grid: TileGrid, cgrid: TileGrid) -> torch.Tensor:
    """Lift a right-hand-side panel ``(..., padded_n, k)`` from the source
    padded layout into the canonical one: band rows shift past the identity
    prefix (which solves to zero against zero right-hand sides), arrow rows
    move past the band slack."""
    pad_d, _, pad_a = _check_embeddable(grid, cgrid)
    t, ndt = grid.t, grid.n_diag_tiles
    if B.shape[-2] != grid.padded_n:
        raise ValueError(f"rhs panel rows {B.shape[-2]} != padded_n "
                         f"{grid.padded_n} of the source grid")
    zeros = lambda rows: B.new_zeros(B.shape[:-2] + (rows, B.shape[-1]))
    return torch.cat([zeros(pad_d * t), B[..., :ndt * t, :], B[..., ndt * t:, :],
                      zeros(pad_a * t)], dim=-2)


def restrict_rhs(X: torch.Tensor, grid: TileGrid, cgrid: TileGrid) -> torch.Tensor:
    """Project a solution panel from the canonical layout back to the
    source padded layout (the inverse of :func:`embed_rhs`)."""
    pad_d, _, _ = _check_embeddable(grid, cgrid)
    t, ndt, nat = grid.t, grid.n_diag_tiles, grid.n_arrow_tiles
    off_a = cgrid.n_diag_tiles * t
    if X.shape[-2] != cgrid.padded_n:
        raise ValueError(f"solution panel rows {X.shape[-2]} != padded_n "
                         f"{cgrid.padded_n} of the canonical grid")
    return torch.cat([X[..., pad_d * t:(pad_d + ndt) * t, :],
                      X[..., off_a:off_a + nat * t, :]], dim=-2)


def assemble_rung_batch(mats: Sequence[BandedCTSF],
                        cgrid: TileGrid) -> Tuple[BandedCTSF, int]:
    """Embed same-rung matrices (any source grids) onto ``cgrid`` and
    stack them on a leading batch axis.  Returns ``(batch, start_tile)``,
    ``start_tile`` the smallest identity-prefix depth of the batch: the
    deepest skip right for every element.  A deeper element's rows between
    ``start_tile`` and its own depth are computed, but they are identity
    tiles whose factor is themselves, so no element's factor changes."""
    if not mats:
        raise ValueError("assemble_rung_batch needs at least one matrix")
    embedded = [embed_ctsf(m, cgrid) for m in mats]
    start = min(cgrid.n_diag_tiles - m.grid.n_diag_tiles for m in mats)
    return BandedCTSF(cgrid, *(torch.stack([getattr(e, x) for e in embedded])
                               for x in ("Dr", "R", "C"))), start


def assemble_rung_rhs(panels: Sequence[torch.Tensor], grids: Sequence[TileGrid],
                      cgrid: TileGrid) -> torch.Tensor:
    """Lift per-request panels (each in its own source padded layout) into
    the canonical layout and stack them: ``(B, cgrid.padded_n, k)``; the
    results come back out through :func:`restrict_rhs`."""
    if len(panels) != len(grids):
        raise ValueError(f"{len(panels)} panels for {len(grids)} grids")
    if not panels:
        raise ValueError("assemble_rung_rhs needs at least one panel")
    return torch.stack([embed_rhs(p, g, cgrid) for p, g in zip(panels, grids)])


def _sweep_tile_matmuls(ndt: int, bt: int, nat: int) -> int:
    """Tile-product count model of one band + arrow factorization sweep
    (band update, arrow update, panel substitutions, corner Schur): the
    unit :func:`padded_flop_overhead` compares in."""
    band_update = bt * (bt + 1) // 2      # U[e] pairs per panel
    arrow_update = nat * bt               # V[i] pairs per panel
    subst = bt + nat                      # panel + arrow substitutions
    schur = nat * nat                     # corner Schur terms per panel
    return max(ndt, 1) * (band_update + arrow_update + subst + schur + 1)


def padded_flop_overhead(grid: TileGrid, cgrid: TileGrid) -> float:
    """The fraction of extra tile products the canonical embedding pays
    over the source grid, with the identity prefix skipped (the sweeps'
    ``start_tile``): only band and arrow widening costs.  0.0 means the
    grid is already on its rung."""
    _check_embeddable(grid, cgrid)
    src = _sweep_tile_matmuls(grid.n_diag_tiles, grid.band_tiles, grid.n_arrow_tiles)
    emb = _sweep_tile_matmuls(grid.n_diag_tiles, cgrid.band_tiles, cgrid.n_arrow_tiles)
    return emb / src - 1.0
