"""Banded-arrowhead Compressed Tile Storage Format on a torch device.

:class:`BandedCTSF` is the regular banded-arrowhead layout the window
factorization works on, the same layout as the JAX package's
``BandedCTSF``:

    Dr: (ndt, bt+1, t, t)  band rows   — Dr[m, d] = A_tile[m, m-d] (d<=min(m,bt))
    R:  (ndt, nat, t, t)   arrow rows  — R[k, i]  = A_tile[ndt+i, k]
    C:  (nat, nat, t, t)   corner      — C[i, j]  = A_tile[ndt+i, ndt+j] (lower)

All float32.  The arrays live on the card unless the caller asks for the
CPU: ``device=None`` means ``cuda:0`` and raises where there is no card.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple, Union

import numpy as np
import scipy.sparse as sp
import torch

from .structure import ArrowheadStructure, TileGrid

__all__ = ["BandedCTSF", "resolve_device"]


def resolve_device(device=None) -> torch.device:
    """``device`` as a ``torch.device``; None means the first card, and
    raises when there is none (pass ``device="cpu"`` to run on the CPU)."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available; pass "
                               "device='cpu' to build the matrix on the CPU")
        return torch.device("cuda", 0)
    return torch.device(device)


def _padded_index(grid: TileGrid, i: np.ndarray) -> np.ndarray:
    """Vectorized ``TileGrid.padded_index``."""
    nd = grid.structure.n_diag
    return np.where(i < nd, i, grid.n_diag_tiles * grid.t + (i - nd))


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
        r = _padded_index(grid, coo.row.astype(np.int64))
        c = _padded_index(grid, coo.col.astype(np.int64))
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
        for k in range(grid.structure.n_diag, ndt * t):
            Dr[k // t, 0, k % t, k % t] = 1.0
        for k in range(ndt * t + grid.structure.arrow, grid.padded_n):
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
        if isinstance(grid, TileGrid):
            g = grid
        else:
            n, bandwidth, arrow, t = (int(x) for x in grid)
            g = TileGrid(ArrowheadStructure(n=n, bandwidth=bandwidth, arrow=arrow), t)
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
