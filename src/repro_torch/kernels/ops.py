"""Tile-kernel entry points, dispatched by device.

``impl=None`` takes the plain version (``ref.py``) for a tensor on the CPU
and the CUDA kernel for a tensor on the card; there is no fallback from
one to the other.  ``impl="ref"`` forces the plain version on any device
(``chip_smoke.py`` uses it to check the kernels); ``impl="cuda"`` forces
the kernel, and raises for a CPU tensor.

The task list's tile updates (``potrf``, ``trsm``, ``syrk``, ``gemm``) take
``out=``: the kernel writes its result there (it may be the updated tile
itself, a slot of the tile buffer), and the plain version copies into it.

``plain_calls`` counts the calls that took a plain version, by kernel
name: the CPU's launch count (``runtime/telemetry.py::count_launches``),
one a sweep as a kernel is one launch a sweep.
"""
from __future__ import annotations

from collections import Counter
from typing import Optional

import torch

from . import ref
from .band_cholesky import band_cholesky_partitioned_sweep_cuda, band_cholesky_sweep_cuda
from .band_solve import band_backward_sweep_cuda, band_forward_sweep_cuda
from .band_update import band_update_cuda
from .gemm import geadd_cuda, gemm_cuda, syrk_cuda
from .potrf import potrf_cuda
from .selinv import selinv_step_cuda, selinv_sweep_cuda
from .trsm import solve_panel_cuda, trsm_cuda

__all__ = ["potrf", "trsm", "syrk", "gemm", "geadd", "solve_panel", "selinv_step",
           "band_update", "band_forward_sweep", "band_backward_sweep", "band_cholesky_sweep",
           "band_cholesky_partitioned_sweep", "selinv_sweep", "resolve_impl", "IMPLS"]

IMPLS = ("ref", "cuda")

plain_calls: Counter = Counter()


def resolve_impl(impl: Optional[str], x: torch.Tensor) -> str:
    """The backend a call on ``x`` runs: ``impl`` if given, else by device."""
    if impl is None:
        if x.device.type == "cuda":
            return "cuda"
        if x.device.type == "cpu":
            return "ref"
        raise ValueError(f"no kernel backend for device {x.device}")
    if impl not in IMPLS:
        raise ValueError(f"unknown impl {impl!r} (want one of {IMPLS} or None)")
    return impl


def _plain(name: str):
    """Count one call of kernel ``name``'s plain version."""
    plain_calls[name] += 1


def _into(out: Optional[torch.Tensor], x: torch.Tensor) -> torch.Tensor:
    """A plain version's result, copied into ``out`` when there is one."""
    return x if out is None else out.copy_(x)


def potrf(a: torch.Tensor, impl: Optional[str] = None,
          out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Cholesky of a (..., t, t) batch of SPD tiles."""
    if resolve_impl(impl, a) == "cuda":
        return potrf_cuda(a, out=out)
    _plain("potrf")
    return _into(out, ref.potrf_ref(a))


def trsm(l_kk: torch.Tensor, a_mk: torch.Tensor, impl: Optional[str] = None,
         out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``X = A L^{-T}`` for a (..., t, t) batch of A against one L, one L per
    tile, or one L per group: L (..., 1, t, t) against A (..., n, t, t)."""
    if resolve_impl(impl, a_mk) == "cuda":
        return trsm_cuda(l_kk, a_mk, out=out)
    _plain("trsm")
    return _into(out, ref.trsm_ref(l_kk, a_mk))


def syrk(c_kk: torch.Tensor, a_kn: torch.Tensor, impl: Optional[str] = None,
         out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``C - A A^T`` over the full tile (the diagonal tile's update)."""
    if resolve_impl(impl, c_kk) == "cuda":
        return syrk_cuda(c_kk, a_kn, out=out)
    _plain("syrk")
    return _into(out, ref.syrk_ref(c_kk, a_kn))


def gemm(c_mk: torch.Tensor, a_mn: torch.Tensor, b_kn: torch.Tensor,
         impl: Optional[str] = None, out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``C - A B^T``, batched over C's leading dims with A and B broadcast."""
    if resolve_impl(impl, c_mk) == "cuda":
        return gemm_cuda(c_mk, a_mn, b_kn, out=out)
    _plain("gemm")
    return _into(out, ref.gemm_ref(c_mk, a_mn, b_kn))


def geadd(a: torch.Tensor, b: torch.Tensor, impl: Optional[str] = None) -> torch.Tensor:
    """``A + B``: the combine of the Alg. 3 tree reduction."""
    if resolve_impl(impl, a) == "cuda":
        return geadd_cuda(a, b)
    _plain("geadd")
    return ref.geadd_ref(a, b)


def solve_panel(l_kk: torch.Tensor, b_panel: torch.Tensor, trans: bool = False,
                impl: Optional[str] = None) -> torch.Tensor:
    """``L X = B`` (or ``L^T X = B``) for a (..., t, k) batch of panels
    against one (t, t) L, or against one L a panel, ``l_kk (..., t, t)``
    (the batched solves' corner)."""
    if resolve_impl(impl, b_panel) == "cuda":
        return solve_panel_cuda(l_kk, b_panel, trans=trans)
    _plain("solve_panel")
    return ref.solve_panel_ref(l_kk, b_panel, trans=trans)


def selinv_step(s_row: torch.Tensor, g_col: torch.Tensor,
                impl: Optional[str] = None) -> torch.Tensor:
    """One Takahashi tile step: ``u[e] = sum_j s_row[e, j] @ g_col[j]`` for
    ``s_row (e_n, j_n, t, t)`` and ``g_col (j_n, t, t)`` -> ``(e_n, t, t)``,
    zeros when ``e_n`` or ``j_n`` is 0."""
    if resolve_impl(impl, s_row) == "cuda":
        return selinv_step_cuda(s_row, g_col)
    _plain("selinv_step")
    return ref.selinv_step_ref(s_row, g_col)


def band_update(w: torch.Tensor, impl: Optional[str] = None) -> torch.Tensor:
    """The window sweep's band-panel update: ``u[e] = sum_{j=1..b-e}
    w[e, e+j] @ w[0, j]^T`` for a ``(..., b+1, b+1, t, t)`` window ->
    ``(..., b+1, t, t)``; ``"cuda"`` is one launch for a window or a
    batch of them.  The plain backend sums only the nonzero pairs, one
    after another, for ``b + 1 <= 6``, and takes the masked einsum for
    wider bands, as the reference's dispatch does."""
    if resolve_impl(impl, w) == "cuda":
        return band_update_cuda(w)
    _plain("band_update")
    if w.shape[-4] <= 6:
        return ref.band_update_unrolled_ref(w)
    return ref.band_update_ref(w)


def band_forward_sweep(Dr: torch.Tensor, R: torch.Tensor, bd: torch.Tensor,
                       start_tile: int = 0, impl: Optional[str] = None):
    """Forward band sweep ``L Y = B`` plus the arrow sums ``acc_a[i] =
    sum_m R[m, i] @ Y_m``: ``(yd (ndt, t, k), acc_a (nat, t, k))``.
    ``"cuda"`` is one kernel launch; ``"ref"`` a loop of ``solve_panel``.
    A leading batch axis on every input is one launch for the batch."""
    if resolve_impl(impl, bd) == "cuda":
        return band_forward_sweep_cuda(Dr, R, bd, start_tile=start_tile)
    _plain("band_forward_sweep")
    return ref.band_forward_sweep_ref(Dr, R, bd, start_tile=start_tile)


def band_backward_sweep(Dr: torch.Tensor, R: torch.Tensor, yd: torch.Tensor,
                        xa: torch.Tensor, start_tile: int = 0,
                        impl: Optional[str] = None) -> torch.Tensor:
    """Backward band sweep ``L^T X = Y - R^T Xa``: ``xd (ndt, t, k)``, with
    the same backend split and batch axis as :func:`band_forward_sweep`."""
    if resolve_impl(impl, yd) == "cuda":
        return band_backward_sweep_cuda(Dr, R, yd, xa, start_tile=start_tile)
    _plain("band_backward_sweep")
    return ref.band_backward_sweep_ref(Dr, R, yd, xa, start_tile=start_tile)


def band_cholesky_sweep(Ac: torch.Tensor, R: torch.Tensor, nchunks: int = 1,
                        start_tile: int = 0, impl: Optional[str] = None):
    """Whole band+arrow Cholesky factorization as one sweep: ``Ac (ndt,
    bt+1, t, t)`` column-band tiles and ``R (ndt, nat, t, t)`` arrow rows
    -> ``(panels, R_out, schur, status)``: column panels of L, factored
    arrow rows, per-chunk corner-Schur partial sums and the (3,) float32
    status word ``[min_pivot, nonfinite, first_bad]``.  ``"cuda"`` is one
    kernel launch; ``"ref"`` the column loop of ``ref.py``.  A leading
    batch axis on ``Ac`` and ``R`` is one launch for the whole batch."""
    if resolve_impl(impl, Ac) == "cuda":
        return band_cholesky_sweep_cuda(Ac, R, nchunks=nchunks,
                                        start_tile=start_tile)
    _plain("band_cholesky_sweep")
    return ref.band_cholesky_sweep_ref(Ac, R, nchunks=nchunks,
                                       start_tile=start_tile)


def band_cholesky_partitioned_sweep(Ac: torch.Tensor, R: torch.Tensor, boundaries,
                                    start_tile: int = 0, impl: Optional[str] = None):
    """The sweep of :func:`band_cholesky_sweep` over the independent
    partitions ``[boundaries[p], boundaries[p+1])`` of a block-separable
    band -> ``(panels, R_out, schur, status)`` with ``schur (P, nat, nat,
    t, t)``, one corner-Schur leaf per partition, and ``first_bad`` global.
    ``"cuda"`` is one kernel launch, a cluster per partition (and per batch
    element, with a leading batch axis); ``"ref"`` the column loop of
    ``ref.py`` on each partition."""
    if resolve_impl(impl, Ac) == "cuda":
        return band_cholesky_partitioned_sweep_cuda(Ac, R, boundaries, start_tile=start_tile)
    _plain("band_cholesky_partitioned_sweep")
    return ref.band_cholesky_partitioned_sweep_ref(Ac, R, boundaries, start_tile=start_tile)


def selinv_sweep(lcol: torch.Tensor, R: torch.Tensor, sc_full: torch.Tensor,
                 start_tile: int = 0, impl: Optional[str] = None):
    """Whole backward Takahashi recurrence: ``lcol (ndt, bt+1, t, t)``
    column view of the factor, ``R (ndt, nat, t, t)`` and the full corner
    ``sc_full (nat, nat, t, t)`` -> ``(panels, acols)`` of Σ.  ``"cuda"``
    is two kernel launches, a pre-pass and the recurrence; ``"ref"`` the
    column loop of ``ref.py``.  A leading batch axis on every input is the
    same two launches for the batch."""
    if resolve_impl(impl, lcol) == "cuda":
        return selinv_sweep_cuda(lcol, R, sc_full, start_tile=start_tile)
    _plain("selinv_sweep")
    return ref.selinv_sweep_ref(lcol, R, sc_full, start_tile=start_tile)
