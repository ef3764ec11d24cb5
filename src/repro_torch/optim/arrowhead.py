"""sTiles-powered banded-arrowhead curvature preconditioner.

Port of the JAX package's ``optim/arrowhead.py``, the one LM piece that
rides the solver.  The curvature of a deep transformer, restricted to a
sketched per-layer subspace, is taken to be a **banded arrowhead matrix**
over layer blocks:

  * one r-dim sketch per layer (a fixed random coordinate sample of the
    layer's gradient) -> "diagonal blocks";
  * EMA of cross-layer sketch outer products within a band -> "band";
  * EMA against the embedding-group sketch -> "arrowhead".

Every ``precond_every`` steps the (L+1)·r banded-arrowhead matrix is
factorized by the port's window factorization (the tile size *is* the
sketch dim; on the card the fused band-Cholesky sweep, one ``potrf`` and
one ``trsm`` of the one-tile corner), and each step preconditions the
gradient by the two band-solve sweeps and the corner's ``solve_panel``
pair (replayed from the solves' corner graph):

    d = g  +  Pᵀ (A⁻¹ ĝ − ĝ)        (identity on the unsketched complement)

so with A = I the update reduces exactly to the raw gradient.  The sample
plans are drawn on the host in the reference's leaf order from one seeded
numpy generator, so both packages sketch the same coordinates.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Tuple

import numpy as np
import torch

from repro_torch import pytree
from repro_torch.core.cholesky import _factorize_window_impl
from repro_torch.core.ctsf import resolve_device
from repro_torch.core.solve import _backward_impl, _forward_impl
from repro_torch.core.structure import ArrowheadStructure, TileGrid

__all__ = ["ArrowheadPrecond", "build_precond"]

_LAYER_SEGMENTS = ("layers", "mamba", "enc_layers", "dec_layers")


def _group_leaves(params) -> Tuple[List[Tuple[str, Any]], List[Tuple[str, Any]]]:
    """Split params into stacked layer leaves and global ('arrow') leaves."""
    layer_leaves, arrow_leaves = [], []
    for keys, leaf in pytree.leaves_with_path(params):
        if any(seg in keys for seg in _LAYER_SEGMENTS):
            layer_leaves.append((keys, leaf))
        else:
            arrow_leaves.append((keys, leaf))
    return layer_leaves, arrow_leaves


@dataclasses.dataclass
class ArrowheadPrecond:
    """Static description of the preconditioner; its state is a dict of
    tensors (:meth:`init_state`)."""
    r: int                    # sketch dim = sTiles tile size
    band: int                 # band width in layer blocks
    n_layers: int
    ema: float
    damping: float
    grid: TileGrid
    # host-side index plans: per leaf (name, sampled flat indices)
    layer_plan: List[Tuple[str, np.ndarray]]
    arrow_plan: List[Tuple[str, np.ndarray]]
    # the plans' indices as int64 tensors, per device
    _index: Dict[str, Tuple[list, list]] = dataclasses.field(
        default_factory=dict, repr=False, compare=False)

    def init_state(self, device=None) -> Dict[str, torch.Tensor]:
        """Zero statistics on ``device`` (None: the card)."""
        dev = resolve_device(device)
        g = self.grid
        t, ndt, nat, bt = g.t, g.n_diag_tiles, g.n_arrow_tiles, g.band_tiles
        return {
            "Dr": torch.zeros((ndt, bt + 1, t, t), dtype=torch.float32, device=dev),
            "R": torch.zeros((ndt, nat, t, t), dtype=torch.float32, device=dev),
            "C": torch.zeros((nat, nat, t, t), dtype=torch.float32, device=dev),
            "count": torch.zeros((), dtype=torch.int32, device=dev),
        }

    def _indices(self, device: torch.device):
        key = str(device)
        if key not in self._index:
            as_t = lambda plan: [torch.as_tensor(idx, dtype=torch.int64, device=device)
                                 for _, idx in plan]
            self._index[key] = (as_t(self.layer_plan), as_t(self.arrow_plan))
        return self._index[key]

    # ---- sketching ---------------------------------------------------------

    def sketch(self, grads) -> Tuple[torch.Tensor, torch.Tensor]:
        """Project grads to per-layer sketches.

        Returns (layer_sketch (L, r), arrow_sketch (r,)).
        """
        layer_leaves, arrow_leaves = _group_leaves(grads)
        by_name, by_name_a = dict(layer_leaves), dict(arrow_leaves)
        lidx, aidx = self._indices(layer_leaves[0][1].device)
        parts = [by_name[name].reshape(self.n_layers, -1).to(torch.float32)[:, idx]
                 for (name, _), idx in zip(self.layer_plan, lidx)]
        lsk = torch.cat(parts, dim=1)[:, : self.r]
        aparts = [by_name_a[name].reshape(-1).to(torch.float32)[idx]
                  for (name, _), idx in zip(self.arrow_plan, aidx)]
        ask = torch.cat(aparts)[: self.r]
        return lsk, ask

    # ---- statistics --------------------------------------------------------

    def update_stats(self, state, grads):
        lsk, ask = self.sketch(grads)                    # (L, r), (r,)
        bt = self.grid.band_tiles
        e = self.ema
        # band blocks: Dr[m, d] += lsk_m lsk_{m-d}^T
        lpad = torch.cat([lsk.new_zeros((bt, lsk.shape[1])), lsk])
        wins = torch.stack([lpad[bt - d: bt - d + self.n_layers] for d in range(bt + 1)],
                           dim=1)                        # (L, bt+1, r)
        dr_new = torch.einsum("la,ldb->ldab", lsk, wins)
        r_new = torch.einsum("la,b->lab", lsk, ask)[:, None]
        c_new = torch.einsum("a,b->ab", ask, ask)[None, None]
        return {
            "Dr": e * state["Dr"] + (1 - e) * dr_new,
            "R": e * state["R"] + (1 - e) * r_new,
            "C": e * state["C"] + (1 - e) * c_new,
            "count": state["count"] + 1,
        }

    # ---- factorize + solve -------------------------------------------------

    def damped(self, state) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """The matrix :meth:`factorize` factorizes, as ``(Dr, R, C)`` tiles:
        the statistics with an adaptive diagonal damping.

        The band+arrow *truncation* of the PSD gradient-moment EMA is not
        itself PSD, so the diagonal damping is lifted per block row by the
        Frobenius mass of that row's off-diagonal blocks — block-Gershgorin
        diagonal dominance guarantees λ_min(A) ≥ damping > 0 (‖·‖₂ ≤ ‖·‖_F).
        """
        g = self.grid
        t, ndt, bt = g.t, g.n_diag_tiles, g.band_tiles
        Dr0, R0, C0 = state["Dr"], state["R"], state["C"]
        eye = torch.eye(t, dtype=torch.float32, device=Dr0.device)

        def fro(x):
            return torch.sqrt(torch.sum(torch.square(x), dim=(-2, -1)) + 1e-30)

        band_mass = fro(Dr0[:, 1:]) if bt else Dr0.new_zeros((ndt, 0))
        upper = band_mass.sum(dim=1) if bt else Dr0.new_zeros(ndt)
        lower = Dr0.new_zeros(ndt)
        for d in range(1, bt + 1):
            if d < ndt:
                lower[:ndt - d] += band_mass[d:, d - 1]
        arrow_mass = fro(R0).sum(dim=1)
        row_damp = self.damping + upper + lower + arrow_mass
        corner_damp = self.damping + fro(R0).sum()
        dr = Dr0.clone()
        dr[:, 0] += row_damp[:, None, None] * eye
        c = C0.clone()
        c[0, 0] += corner_damp * eye
        return dr, R0, c

    def factorize(self, state, *, impl=None) -> Dict[str, torch.Tensor]:
        """Factorize the damped statistics (:meth:`damped`) with sTiles.
        The factorization's status word is not read: the damping makes A
        diagonally dominant.  ``impl`` forces a backend (None: the CUDA
        kernels on the card, the plain versions elsewhere)."""
        dr, R0, c = self.damped(state)
        Dr, R, C, _status = _factorize_window_impl(dr, R0, c, self.grid, impl, 4)
        return {"Dr": Dr, "R": R, "C": C}

    def solve_sketch(self, factor, lsk: torch.Tensor, ask: torch.Tensor, *, impl=None):
        """``A⁻¹ ĝ`` for the sketch ``ĝ = (lsk, ask)``: the forward and
        backward band-solve sweeps and the corner at k = 1.  Returns
        ``(sol_l (L, r), sol_a (r,))``."""
        rhs = torch.cat([lsk.reshape(-1), ask])          # ((L+1)·r,)
        g = self.grid
        # the solve sweeps take (tiles, t, k) RHS panels; this is the k=1 case
        bd = rhs[: g.n_diag_tiles * g.t].reshape(g.n_diag_tiles, g.t, 1)
        ba = rhs[g.n_diag_tiles * g.t:].reshape(g.n_arrow_tiles, g.t, 1)
        yd, ya = _forward_impl(factor["Dr"], factor["R"], factor["C"], bd, ba, g, impl)
        xd, xa = _backward_impl(factor["Dr"], factor["R"], factor["C"], yd, ya, g, impl)
        return xd[..., 0].reshape(self.n_layers, self.r), xa[..., 0].reshape(-1)[: self.r]

    def precondition(self, factor, grads, *, impl=None):
        """d = g + lift(A^{-1} ĝ − ĝ); returns a new tree (``grads`` is
        not written).  ``impl`` as in :meth:`factorize`."""
        lsk, ask = self.sketch(grads)
        sol_l, sol_a = self.solve_sketch(factor, lsk, ask, impl=impl)
        # scale correction so magnitudes stay gradient-like
        return self._lift(grads, sol_l - lsk, sol_a - ask)

    def _lift(self, grads, dl, da):
        """Add ``dl`` / ``da`` at the plans' coordinates of copies of the
        sampled leaves.  ``index_add_`` accumulates repeated indices, as the
        reference's ``.at[idx].add`` does: a top-up plan entry may sample a
        leaf already in the plan, at indices the first entry shares."""
        layer_leaves, arrow_leaves = _group_leaves(grads)
        by_name, by_name_a = dict(layer_leaves), dict(arrow_leaves)
        lidx, aidx = self._indices(dl.device)
        lifted: Dict[str, torch.Tensor] = {}
        for plan, idxs, leaves, upd, rows in (
                (self.layer_plan, lidx, by_name, dl, self.n_layers),
                (self.arrow_plan, aidx, by_name_a, da[None], 1)):
            off = 0
            for (name, idx), idx_t in zip(plan, idxs):
                width = min(len(idx), self.r - off) if off < self.r else 0
                if width <= 0:
                    continue
                if name not in lifted:
                    lifted[name] = leaves[name].reshape(rows, -1).clone()
                flat = lifted[name]
                flat.index_add_(1, idx_t[:width], upd[:, off: off + width].to(flat.dtype))
                off += width
        return pytree.unflatten(grads, [
            lifted[p].reshape(leaf.shape) if p in lifted else leaf
            for p, leaf in pytree.leaves_with_path(grads)])


def build_precond(params, r: int = 32, band: int = 2, ema: float = 0.95,
                  damping: float = 1e-3, seed: int = 0) -> ArrowheadPrecond:
    """Host-side construction: sampling plans + the sTiles grid.  Reads only
    the leaves' shapes, in the reference's order."""
    layer_leaves, arrow_leaves = _group_leaves(params)
    if not layer_leaves:
        raise ValueError("no stacked layer params found")
    n_layers = layer_leaves[0][1].shape[0]
    rng = np.random.default_rng(seed)
    sizes = [(name, int(np.prod(leaf.shape)) // leaf.shape[0])
             for name, leaf in layer_leaves]
    total = sum(s for _, s in sizes)
    layer_plan, acc = [], 0
    for name, s in sizes:
        k = max(1, round(r * s / total))
        k = min(k, s, r - acc)
        if k <= 0:
            continue
        layer_plan.append((name, rng.choice(s, size=k, replace=False)))
        acc += k
    # top up to exactly r from the largest leaf (which may already be in
    # the plan: its entries are then lifted twice, accumulating)
    if acc < r:
        name, s = max(sizes, key=lambda x: x[1])
        layer_plan.append((name, rng.choice(s, size=r - acc, replace=False)))
    asizes = [(name, int(np.prod(leaf.shape))) for name, leaf in arrow_leaves]
    atotal = sum(s for _, s in asizes)
    arrow_plan, acc = [], 0
    for name, s in asizes:
        k = max(1, round(r * s / atotal))
        k = min(k, s, r - acc)
        if k <= 0:
            continue
        arrow_plan.append((name, rng.choice(s, size=k, replace=False)))
        acc += k
    if acc < r and asizes:
        name, s = max(asizes, key=lambda x: x[1])
        arrow_plan.append((name, rng.choice(s, size=r - acc, replace=False)))

    struct = ArrowheadStructure(n=(n_layers + 1) * r, bandwidth=band * r - 1, arrow=r)
    grid = TileGrid(struct, t=r)
    return ArrowheadPrecond(r=r, band=band, n_layers=n_layers, ema=ema,
                            damping=damping, grid=grid,
                            layer_plan=layer_plan, arrow_plan=arrow_plan)
