"""Compressed Tile Storage Format (CTSF, paper §III-B, Fig. 5) on a torch
device, the two layouts of the JAX package's ``core/ctsf.py``:

* :class:`TileMatrix` — the general CTSF: only the nonzero tiles of the
  factor's pattern (fill included, from symbolic factorization) are stored,
  stacked in one ``(n_alloc, t, t)`` buffer, with a host-side map from
  ``(row_tile, col_tile)`` to buffer slot.  The task-list factorization
  works on it.
* :class:`BandedCTSF` — the regular banded-arrowhead layout the window
  factorization works on:

    Dr: (ndt, bt+1, t, t)  band rows   — Dr[m, d] = A_tile[m, m-d] (d<=min(m,bt))
    R:  (ndt, nat, t, t)   arrow rows  — R[k, i]  = A_tile[ndt+i, k]
    C:  (nat, nat, t, t)   corner      — C[i, j]  = A_tile[ndt+i, ndt+j] (lower)

Both fill their tiles straight from the matrix's COO entries, bit-identical
to slicing the dense padded matrix as the reference does, without building
it.  All float32.  The arrays live on the card unless the caller asks for
the CPU: ``device=None`` means ``cuda:0`` and raises where there is no card.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple, Union

import numpy as np
import scipy.sparse as sp
import torch

from .structure import ArrowheadStructure, TileGrid, tile_pattern_from_coo
from .symbolic import SymbolicFactorization, symbolic_factorize

__all__ = ["BandedCTSF", "TileMatrix", "resolve_device"]


def resolve_device(device=None) -> torch.device:
    """``device`` as a ``torch.device``; None means the first card, and
    raises when there is none (pass ``device="cpu"`` to run on the CPU)."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available; pass "
                               "device='cpu' to build the matrix on the CPU")
        return torch.device("cuda", 0)
    return torch.device(device)


def _as_grid(grid: Union[TileGrid, Tuple[int, int, int, int]]) -> TileGrid:
    """A port ``TileGrid``, or one rebuilt from ``(n, bandwidth, arrow, t)``."""
    if isinstance(grid, TileGrid):
        return grid
    n, bandwidth, arrow, t = (int(x) for x in grid)
    return TileGrid(ArrowheadStructure(n=n, bandwidth=bandwidth, arrow=arrow), t)


def _padding_diagonal(grid: TileGrid) -> np.ndarray:
    """Padded indices of the identity diagonal that keeps padded tiles SPD:
    the band's padding, then the arrow's."""
    ndt_t = grid.n_diag_tiles * grid.t
    return np.concatenate([np.arange(grid.structure.n_diag, ndt_t),
                           np.arange(ndt_t + grid.structure.arrow, grid.padded_n)])


@dataclasses.dataclass
class TileMatrix:
    """General CTSF: the stacked nonzero tiles of the factor's pattern and
    the host-side map from tile coordinates to buffer slot.  Slots are
    numbered in row-major order of the factor pattern (``np.argwhere``), as
    the reference numbers them; fill tiles start at zero."""

    grid: TileGrid
    symbolic: SymbolicFactorization
    slot: Dict[Tuple[int, int], int]       # (row_tile, col_tile) -> buffer slot
    tiles: torch.Tensor                    # (n_alloc, t, t) float32
    # the task list's schedule on a device, built once (core.cholesky)
    schedules: dict = dataclasses.field(default_factory=dict, repr=False, compare=False)
    # the digest of the sparsity pattern, computed once (core.cholesky's
    # tasklist_graph_key): what the task list's CUDA graphs are cached on
    pattern_key: Optional[str] = dataclasses.field(default=None, repr=False, compare=False)

    @property
    def device(self) -> torch.device:
        return self.tiles.device

    @classmethod
    def from_sparse(cls, mat: sp.spmatrix, grid: TileGrid,
                    symbolic: Optional[SymbolicFactorization] = None,
                    device=None) -> "TileMatrix":
        """Tiles of the (full, symmetric) matrix's lower tile pattern, filled
        straight from its COO entries: each entry lands in the slot of the
        tile that holds its padded position (entries of tiles above the
        diagonal are dropped), and the padding diagonal is the identity."""
        dev = resolve_device(device)
        a_tiles = tile_pattern_from_coo(mat, grid)
        symb = symbolic or symbolic_factorize(a_tiles)
        coords = np.argwhere(symb.l_pattern)
        slot = {(int(i), int(j)): idx for idx, (i, j) in enumerate(coords)}
        t, nt = grid.t, grid.n_tiles
        # slot of each input tile, -1 where nothing is filled
        filled = np.full((nt, nt), -1, dtype=np.int64)
        filled[coords[:, 0], coords[:, 1]] = np.arange(len(coords))
        filled[~a_tiles] = -1
        buf = np.zeros((len(coords), t, t), dtype=np.float32)
        coo = sp.coo_matrix(mat)
        r, c = grid.padded_indices(coo.row), grid.padded_indices(coo.col)
        s = filled[r // t, c // t]
        keep = s >= 0
        buf[s[keep], r[keep] % t, c[keep] % t] = coo.data[keep]
        pad = _padding_diagonal(grid)
        s = filled[pad // t, pad // t]
        buf[s[s >= 0], pad[s >= 0] % t, pad[s >= 0] % t] = 1.0
        return cls(grid, symb, slot, torch.from_numpy(buf).to(dev))

    @classmethod
    def from_arrays(cls, grid: Union[TileGrid, Tuple[int, int, int, int]],
                    symbolic: SymbolicFactorization, slot: Dict[Tuple[int, int], int],
                    tiles, device=None) -> "TileMatrix":
        """Carry a tile matrix over from the JAX package: its slot map and
        its tile buffer (``np.asarray(tm.tiles)``), with the port's symbolic
        factorization of the same pattern and the grid as
        :meth:`BandedCTSF.from_arrays` takes it."""
        g = _as_grid(grid)
        buf = np.array(tiles, dtype=np.float32)
        slot = {(int(i), int(j)): int(v) for (i, j), v in slot.items()}
        want = (int(symbolic.l_pattern.sum()), g.t, g.t)
        if buf.shape != want or sorted(slot.values()) != list(range(want[0])):
            raise ValueError(f"tiles have shape {buf.shape} for {len(slot)} slots; the "
                             f"factor pattern wants {want}")
        return cls(g, symbolic, slot, torch.from_numpy(buf).to(resolve_device(device)))

    def to_dense(self, tiles: Optional[torch.Tensor] = None,
                 lower_only: bool = True) -> np.ndarray:
        """The dense padded matrix of ``tiles`` (this matrix's own buffer by
        default, or a factor's with the same slot map), float32."""
        t = self.grid.t
        out = np.zeros((self.grid.padded_n, self.grid.padded_n), dtype=np.float32)
        buf = (self.tiles if tiles is None else tiles).detach().cpu().numpy()
        for (i, j), idx in self.slot.items():
            out[i * t:(i + 1) * t, j * t:(j + 1) * t] = buf[idx]
        if not lower_only:
            out = np.tril(out) + np.tril(out, -1).T
        return out

    @property
    def n_alloc(self) -> int:
        return self.tiles.shape[0]

    def nbytes(self) -> int:
        return int(self.tiles.numel() * 4)


@dataclasses.dataclass
class BandedCTSF:
    """Regular banded-arrowhead tile layout (see the module docstring)."""

    grid: TileGrid
    Dr: torch.Tensor
    R: torch.Tensor
    C: torch.Tensor

    @property
    def device(self) -> torch.device:
        return self.Dr.device

    @classmethod
    def from_sparse(cls, mat: sp.spmatrix, grid: TileGrid,
                    device=None) -> "BandedCTSF":
        """Fill the tiles straight from the COO entries of the (full,
        symmetric) matrix.  The tiles are bit-identical to slicing the
        dense padded matrix (``from_dense_padded``), without building it:
        each entry lands in the band, arrow or corner tile that holds its
        padded position, and the padding diagonal is the identity."""
        dev = resolve_device(device)
        t, ndt, nat, bt = grid.t, grid.n_diag_tiles, grid.n_arrow_tiles, grid.band_tiles
        coo = sp.coo_matrix(mat)
        r = grid.padded_indices(coo.row)
        c = grid.padded_indices(coo.col)
        tr, tc, ir, ic = r // t, c // t, r % t, c % t
        data = coo.data
        Dr = np.zeros((ndt, bt + 1, t, t), dtype=np.float32)
        R = np.zeros((ndt, nat, t, t), dtype=np.float32)
        C = np.zeros((nat, nat, t, t), dtype=np.float32)
        band = (tr < ndt) & (tc <= tr) & (tr - tc <= bt)
        Dr[tr[band], (tr - tc)[band], ir[band], ic[band]] = data[band]
        arrow = (tr >= ndt) & (tc < ndt)
        R[tc[arrow], (tr - ndt)[arrow], ir[arrow], ic[arrow]] = data[arrow]
        corner = (tr >= ndt) & (tc >= ndt) & (tc <= tr)
        C[(tr - ndt)[corner], (tc - ndt)[corner], ir[corner], ic[corner]] = data[corner]
        # pad diagonal with identity so padded tiles stay SPD
        for k in _padding_diagonal(grid):
            if k < ndt * t:
                Dr[k // t, 0, k % t, k % t] = 1.0
            else:
                kk = k - ndt * t
                C[kk // t, kk // t, kk % t, kk % t] = 1.0
        return cls._on(grid, Dr, R, C, dev)

    @classmethod
    def from_dense_padded(cls, dense: np.ndarray, grid: TileGrid,
                          device=None) -> "BandedCTSF":
        """Slice the tiles out of the dense padded (lower-symmetric) matrix."""
        dev = resolve_device(device)
        t, ndt, nat, bt = grid.t, grid.n_diag_tiles, grid.n_arrow_tiles, grid.band_tiles
        Dr = np.zeros((ndt, bt + 1, t, t), dtype=np.float32)
        for m in range(ndt):
            for d in range(min(m, bt) + 1):
                j = m - d
                Dr[m, d] = dense[m * t:(m + 1) * t, j * t:(j + 1) * t]
        R = np.zeros((ndt, nat, t, t), dtype=np.float32)
        C = np.zeros((nat, nat, t, t), dtype=np.float32)
        off = ndt * t
        for k in range(ndt):
            for i in range(nat):
                R[k, i] = dense[off + i * t: off + (i + 1) * t, k * t:(k + 1) * t]
        for i in range(nat):
            for j in range(i + 1):
                C[i, j] = dense[off + i * t: off + (i + 1) * t,
                                off + j * t: off + (j + 1) * t]
        return cls._on(grid, Dr, R, C, dev)

    @classmethod
    def eye(cls, grid: TileGrid, device=None) -> "BandedCTSF":
        """Identity matrix in the banded-arrowhead layout."""
        dev = resolve_device(device)
        t, ndt, nat, bt = grid.t, grid.n_diag_tiles, grid.n_arrow_tiles, grid.band_tiles
        Dr = np.zeros((ndt, bt + 1, t, t), dtype=np.float32)
        Dr[:, 0] = np.eye(t, dtype=np.float32)
        R = np.zeros((ndt, nat, t, t), dtype=np.float32)
        C = np.zeros((nat, nat, t, t), dtype=np.float32)
        for i in range(nat):
            C[i, i] = np.eye(t, dtype=np.float32)
        return cls._on(grid, Dr, R, C, dev)

    @classmethod
    def from_arrays(cls, grid: Union[TileGrid, Tuple[int, int, int, int]],
                    Dr, R, C, device=None) -> "BandedCTSF":
        """Carry a matrix over from the JAX package: its ``Dr``, ``R`` and
        ``C`` as numpy arrays (``np.asarray(bm.Dr)`` and so on) and its grid
        as ``(n, bandwidth, arrow, t)``, from which the port's ``TileGrid``
        is rebuilt (a port ``TileGrid`` is taken as it is)."""
        g = _as_grid(grid)
        t, ndt, nat, bt = g.t, g.n_diag_tiles, g.n_arrow_tiles, g.band_tiles
        arrs = [np.array(x, dtype=np.float32) for x in (Dr, R, C)]
        want = [(ndt, bt + 1, t, t), (ndt, nat, t, t), (nat, nat, t, t)]
        for name, a, w in zip(("Dr", "R", "C"), arrs, want):
            if a.shape != w:
                raise ValueError(f"{name} has shape {a.shape}, the grid wants {w}")
        return cls._on(g, *arrs, resolve_device(device))

    @classmethod
    def _on(cls, grid, Dr, R, C, device) -> "BandedCTSF":
        return cls(grid, *(torch.from_numpy(np.ascontiguousarray(x)).to(device)
                           for x in (Dr, R, C)))

    def to_dense(self, lower_only: bool = True) -> np.ndarray:
        """The dense padded matrix (lower triangle, or symmetric), float32."""
        g = self.grid
        t, ndt, nat, bt = g.t, g.n_diag_tiles, g.n_arrow_tiles, g.band_tiles
        out = np.zeros((g.padded_n, g.padded_n), dtype=np.float32)
        Dr, R, C = (x.detach().cpu().numpy() for x in (self.Dr, self.R, self.C))
        for m in range(ndt):
            for d in range(min(m, bt) + 1):
                j = m - d
                out[m * t:(m + 1) * t, j * t:(j + 1) * t] = Dr[m, d]
        off = ndt * t
        for k in range(ndt):
            for i in range(nat):
                out[off + i * t: off + (i + 1) * t, k * t:(k + 1) * t] = R[k, i]
        for i in range(nat):
            for j in range(i + 1):
                out[off + i * t: off + (i + 1) * t, off + j * t: off + (j + 1) * t] = C[i, j]
        if not lower_only:
            out = np.tril(out) + np.tril(out, -1).T
        return out

    def arrays(self) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        return self.Dr, self.R, self.C
