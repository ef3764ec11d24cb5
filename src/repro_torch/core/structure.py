"""Structural description of block-arrowhead sparse matrices.

The paper (sTiles, §I / §III) targets symmetric positive-definite matrices
whose nonzeros live in (i) a band of variable width around the diagonal and
(ii) a dense "arrowhead" occupying the last ``arrow`` rows/columns.  This
module measures and represents that structure at both the element level and
the tile level; everything here is host-side numpy (the paper's
"preprocessing phase") — no jax.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import numpy as np
import scipy.sparse as sp

__all__ = [
    "ArrowheadStructure",
    "TileGrid",
    "measure_arrowhead",
    "tile_pattern_from_coo",
    "banded_arrowhead_tile_pattern",
]


@dataclasses.dataclass(frozen=True)
class ArrowheadStructure:
    """Element-level description of a block-arrowhead SPD matrix.

    Attributes:
      n:          full matrix dimension.
      bandwidth:  max |i - j| over nonzeros with both i, j < n - arrow.
      arrow:      thickness of the dense trailing block ("arrowhead region").
    """

    n: int
    bandwidth: int
    arrow: int

    def __post_init__(self):
        if self.arrow < 0 or self.arrow > self.n:
            raise ValueError(f"arrow={self.arrow} out of range for n={self.n}")
        if self.bandwidth < 0:
            raise ValueError("bandwidth must be >= 0")

    @property
    def n_diag(self) -> int:
        """Size of the banded (non-arrow) leading part."""
        return self.n - self.arrow

    def density(self) -> float:
        """Fraction of nonzero elements implied by the structure (full sym)."""
        nd, b, a = self.n_diag, self.bandwidth, self.arrow
        band = sum(min(b, nd - 1 - i) for i in range(nd)) * 2 + nd
        arrowhead = 2 * a * nd + a * a
        return (band + arrowhead) / float(self.n * self.n)


@dataclasses.dataclass(frozen=True)
class TileGrid:
    """Tile-level view of an :class:`ArrowheadStructure` (paper §III-B).

    The tile size ``t`` is the paper's key performance knob (120 on CPU /
    600 on GPU there; multiples of 128 on TPU here — see DESIGN.md §2).
    The diagonal part is padded up to a whole number of tiles; the arrow part
    likewise.  Tiles are indexed by (row_tile, col_tile) over the padded
    matrix.
    """

    structure: ArrowheadStructure
    t: int  # tile size

    def __post_init__(self):
        if self.t <= 0:
            raise ValueError("tile size must be positive")

    @classmethod
    def from_tile_counts(cls, t: int, n_diag_tiles: int, band_tiles: int,
                         n_arrow_tiles: int) -> "TileGrid":
        """Construct the *tile-aligned* grid with exactly the given tile
        counts — the canonical-grid constructor of
        :mod:`repro.core.gridpolicy`.

        The underlying :class:`ArrowheadStructure` is chosen so every
        derived property round-trips (``n_diag = n_diag_tiles * t``,
        ``arrow = n_arrow_tiles * t``, ``bandwidth = band_tiles*t - 1``),
        i.e. ``padded_n == n`` and ``padded_index`` is the identity.  Two
        calls with equal tile counts produce equal (hashable) grids, which
        is what makes canonical grids usable as compile-cache keys.
        """
        if n_diag_tiles < 0 or n_arrow_tiles < 0 or band_tiles < 0:
            raise ValueError("tile counts must be >= 0")
        if n_diag_tiles == 0 and band_tiles > 0:
            raise ValueError("band_tiles > 0 needs a diagonal part")
        if n_diag_tiles > 0 and band_tiles > n_diag_tiles - 1:
            raise ValueError(
                f"band_tiles={band_tiles} exceeds n_diag_tiles-1="
                f"{n_diag_tiles - 1}")
        if n_diag_tiles > 1 and band_tiles == 0:
            # the band_tiles property maps any bandwidth >= 0 to >= 1 when
            # there is more than one diagonal tile, so bt=0 is representable
            # only for single-tile (or empty) diagonal parts
            raise ValueError("band_tiles=0 needs n_diag_tiles <= 1")
        structure = ArrowheadStructure(
            n=(n_diag_tiles + n_arrow_tiles) * t,
            bandwidth=max(band_tiles * t - 1, 0),
            arrow=n_arrow_tiles * t)
        grid = cls(structure, t)
        derived = (grid.n_diag_tiles, grid.band_tiles, grid.n_arrow_tiles)
        if derived != (n_diag_tiles, band_tiles, n_arrow_tiles):
            # the round-trip is what makes canonical grids trustworthy as
            # compile-cache keys — fail loudly even under `python -O`
            raise RuntimeError(
                f"tile-count round-trip failed: requested "
                f"{(n_diag_tiles, band_tiles, n_arrow_tiles)}, derived "
                f"{derived} (constructor bug)")
        return grid

    @property
    def n_diag_tiles(self) -> int:
        return max(1, math.ceil(self.structure.n_diag / self.t)) if self.structure.n_diag > 0 else 0

    @property
    def n_arrow_tiles(self) -> int:
        return math.ceil(self.structure.arrow / self.t) if self.structure.arrow > 0 else 0

    @property
    def n_tiles(self) -> int:
        return self.n_diag_tiles + self.n_arrow_tiles

    @property
    def band_tiles(self) -> int:
        """Number of sub-diagonal tile rows that can hold band nonzeros.

        An element pair (i, j) with i - j <= bandwidth maps to tiles whose
        row-tile/col-tile offset is at most ceil stated below; this is the
        `b` of the banded window backend.
        """
        if self.structure.n_diag == 0:
            return 0
        return min(self.n_diag_tiles - 1,
                   math.ceil((self.structure.bandwidth + 1) / self.t - 1e-12))

    @property
    def padded_n(self) -> int:
        return self.n_tiles * self.t

    def elem_to_tile(self, i: int, j: int) -> Tuple[int, int]:
        return i // self.t, j // self.t

    def padded_index(self, i: int) -> int:
        """Map an element index of the original matrix into the padded one.

        Diagonal part occupies [0, n_diag) -> [0, n_diag) (pad after), arrow
        part occupies [n_diag, n) -> [n_diag_tiles*t, ...).
        """
        s = self.structure
        if i < s.n_diag:
            return i
        return self.n_diag_tiles * self.t + (i - s.n_diag)

    def padded_indices(self, i: np.ndarray) -> np.ndarray:
        """:meth:`padded_index` of every entry of an integer array."""
        i = np.asarray(i, dtype=np.int64)
        nd = self.structure.n_diag
        return np.where(i < nd, i, self.n_diag_tiles * self.t + (i - nd))


def measure_arrowhead(pattern: sp.spmatrix, arrow_hint: Optional[int] = None,
                      arrow_density_threshold: float = 0.5) -> ArrowheadStructure:
    """Measure bandwidth and arrow thickness of a sparse symmetric pattern.

    The paper's preprocessing "computes the bandwidth" (§III-A, proposed ND
    step 1).  Arrow thickness is detected as the largest trailing row block
    whose rows are denser than ``arrow_density_threshold`` relative to a
    dense row, unless ``arrow_hint`` is given (applications such as INLA know
    the number of fixed effects a priori).
    """
    coo = sp.coo_matrix(pattern)
    n = coo.shape[0]
    if coo.shape[0] != coo.shape[1]:
        raise ValueError("pattern must be square")
    rows, cols = coo.row, coo.col

    if arrow_hint is not None:
        arrow = int(arrow_hint)
    else:
        # Row nonzero counts; scan from the bottom while rows look dense.
        counts = np.bincount(rows, minlength=n)
        arrow = 0
        for i in range(n - 1, -1, -1):
            if counts[i] >= arrow_density_threshold * (i + 1):
                arrow += 1
            else:
                break
        arrow = min(arrow, n - 1)

    nd = n - arrow
    mask = (rows < nd) & (cols < nd)
    if mask.any():
        bandwidth = int(np.abs(rows[mask] - cols[mask]).max())
    else:
        bandwidth = 0
    return ArrowheadStructure(n=n, bandwidth=bandwidth, arrow=arrow)


def tile_pattern_from_coo(pattern: sp.spmatrix, grid: TileGrid) -> np.ndarray:
    """Boolean (n_tiles, n_tiles) lower-triangular tile nonzero map (CTSF map).

    Element (i, j) of the (symmetrized, lower) pattern marks tile
    (i//t, j//t); this is exactly the paper's Fig. 5 mapping.  Only tiles
    that receive at least one element are marked — sTiles allocates nothing
    for all-zero tiles.
    """
    coo = sp.coo_matrix(pattern)
    nt = grid.n_tiles
    out = np.zeros((nt, nt), dtype=bool)
    r = grid.padded_indices(np.maximum(coo.row, coo.col))
    c = grid.padded_indices(np.minimum(coo.row, coo.col))
    out[r // grid.t, c // grid.t] = True
    out[np.arange(nt), np.arange(nt)] = True  # diagonal tiles always exist
    return np.tril(out)


def banded_arrowhead_tile_pattern(grid: TileGrid) -> np.ndarray:
    """Dense-band tile pattern implied by the structure alone (no zeros inside
    the band). This is what the `window` backend factorizes; the difference
    between this and :func:`tile_pattern_from_coo` is the paper's
    'extra flops vs. regularity' trade (§I)."""
    nt, ndt, b = grid.n_tiles, grid.n_diag_tiles, grid.band_tiles
    out = np.zeros((nt, nt), dtype=bool)
    for k in range(ndt):
        out[k:min(ndt, k + b + 1), k] = True
    out[ndt:, :] = True  # arrow rows are dense
    return np.tril(out)
