"""Triangular solves, log-determinant, GMRF sampling and marginal variances
from a banded-arrowhead factor.

INLA needs, per factorization: solves ``A x = b`` (posterior means),
``log det A``, samples ``L^{-T} z`` (posterior draws) and selected entries
of ``A^{-1}`` (posterior variances).  Every solve here is a multi-RHS panel
sweep over ``(padded_n, k)`` right-hand sides; the single-RHS entry points
are its k = 1 case.  On the card each band sweep is one CUDA kernel launch
(``kernels.ops.band_forward_sweep`` / ``band_backward_sweep``) and each
corner tile one ``solve_panel`` launch; the corner's loop of small launches
is captured once a shape into a CUDA graph and replayed (see
:func:`corner_graph_key`), as the reference compiles it once a grid with
``jax.jit``.  On the CPU the plain versions run, eagerly.

:func:`solve_many_batched` solves a batched factor (the θ-batch of
``factorize_window_batched``) against per-element panels with the same
launches as one solve: each sweep one launch for the batch, the corner one
``solve_panel`` a tile, each element against its own corner tile.  A
jitter-recovered factor (``factor.info`` with a retained original matrix
and ``tau > 0``, from ``regularize=``) gets one residual-checked
refinement step against the original matrix (:func:`_refine_panels`);
in a batch it is masked to the recovered elements, so clean siblings come
back bit for bit as an unrefined call gives them.

Port of the JAX package's ``core/solve.py``.  The canonical-grid
embedding (``policy=``) and ``start_tile=`` of ``solve_many_batched`` are
not ported yet (they come with the bucketing policy), so every factor here
is solved on its own grid.
"""
from __future__ import annotations

import dataclasses
from collections import Counter
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.kernels import ops
from repro_torch.kernels.trsm import solve_panel_cuda
from .cholesky import CholeskyFactor, GraphCache
from .options import SolverOptions

__all__ = ["forward_solve", "backward_solve", "solve", "logdet",
           "forward_solve_many", "backward_solve_many", "solve_many",
           "solve_many_batched", "sample_gmrf", "sample_gmrf_many", "marginal_variances"]


def _split_rhs(g, b: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Split an (padded_n, k) RHS panel into band (ndt, t, k) and arrow
    (nat, t, k) tile panels (views of ``b``)."""
    t, ndt, nat = g.t, g.n_diag_tiles, g.n_arrow_tiles
    if b.dim() != 2 or b.shape[0] != g.padded_n:
        raise ValueError(
            f"rhs panel must be (padded_n={g.padded_n}, k), got {tuple(b.shape)}")
    k = b.shape[1]
    b = b.contiguous()
    return b[:ndt * t].reshape(ndt, t, k), b[ndt * t:].reshape(nat, t, k)


def _merge_panels(xd: torch.Tensor, xa: torch.Tensor) -> torch.Tensor:
    """Rejoin band and arrow tile panels into one (padded_n, k) panel, the
    inverse of :func:`_split_rhs`; a k = 0 panel round-trips."""
    k = xd.shape[-1]
    return torch.cat([xd.reshape(xd.shape[0] * xd.shape[1], k),
                      xa.reshape(xa.shape[0] * xa.shape[1], k)])


def _forward_corner(C, ba, acc_a, impl):
    """The arrow rows of ``L Y = B``: ``Y_a = Lc^{-1} (B_a - acc_a)`` by block
    forward substitution, one ``solve_panel`` a corner tile (for a batch,
    one for every element's tile ``i``, each against its own)."""
    rhs0 = ba - acc_a
    ya = torch.zeros_like(rhs0)
    for i in range(C.shape[-4]):
        # rhs_i = rhs0_i - sum_{j<i} C[i, j] Y_j
        contrib = torch.einsum("...jab,...jbk->...ak", C[..., i, :i, :, :], ya[..., :i, :, :])
        ya[..., i, :, :] = ops.solve_panel(C[..., i, i, :, :].contiguous(),
                                           (rhs0[..., i, :, :] - contrib).contiguous(),
                                           impl=impl)
    return ya


def _backward_corner(C, ya, impl):
    """The arrow rows of ``L^T X = Y``: ``Lc^T X_a = Y_a`` by block backward
    substitution, one ``solve_panel`` a corner tile (batched as in
    :func:`_forward_corner`)."""
    xa = torch.zeros_like(ya)
    for i in range(C.shape[-4] - 1, -1, -1):
        # rhs_i = Y_i - sum_{j>i} C[j, i]^T X_j
        contrib = torch.einsum("...jba,...jbk->...ak", C[..., i + 1:, i, :, :],
                               xa[..., i + 1:, :, :])
        xa[..., i, :, :] = ops.solve_panel(C[..., i, i, :, :].contiguous(),
                                           (ya[..., i, :, :] - contrib).contiguous(),
                                           trans=True, impl=impl)
    return xa


# captured corners kept at once: a matrix's solves use five shapes (k = 1
# and the panel width, both directions, and marginal_variances' panels),
# and its θ-batch's solves four more (a batched corner is a key of its own)
CORNER_GRAPH_CACHE = 16


def corner_graph_key(C: torch.Tensor, panel: torch.Tensor, backward: bool) -> tuple:
    """What a captured corner is cached on: ``(t, nat, k, backward,
    device)`` of the corner ``C (..., nat, nat, t, t)`` and an arrow panel
    ``(..., nat, t, k)``, then the leading batch shape, if any (a batched
    factor's corner is another graph a batch size); not the values, the
    factor or ``impl``, so every factor of a grid (every θ step of an INLA
    fit) replays one graph."""
    return ((C.shape[-1], C.shape[-4], panel.shape[-1], bool(backward), str(C.device))
            + tuple(C.shape[:-4]))


@dataclasses.dataclass
class _CornerGraph:
    graph: "torch.cuda.CUDAGraph"
    inputs: tuple                   # C and the panels, copied in before a replay
    out: torch.Tensor               # the solved arrow panel, written by a replay
    launches: Counter               # the graph's launches by kernel wrapper name


corner_graphs = GraphCache(CORNER_GRAPH_CACHE)


def _corner_on_graph(C: torch.Tensor, panel: torch.Tensor, impl) -> bool:
    """Whether the corner runs from a CUDA graph: on the card with the CUDA
    kernels, outside a capture of the caller's own (whose capture takes the
    launches instead), with columns to solve."""
    return (C.device.type == "cuda" and ops.resolve_impl(impl, C) == "cuda"
            and panel.shape[-1] > 0 and not torch.cuda.is_current_stream_capturing())


def _capture_corner(body, C, panels) -> _CornerGraph:
    """Capture ``body`` on static copies of ``C`` and the panels into a CUDA
    graph whose output stays in the graph's pool.  A failed capture raises."""
    inputs = tuple(x.clone() for x in (C,) + tuple(panels))
    graph = torch.cuda.CUDAGraph()
    before = solve_panel_cuda.launches
    with torch.cuda.graph(graph):
        out = body(*inputs, "cuda")
    return _CornerGraph(graph, inputs, out,
                        Counter(solve_panel_cuda=solve_panel_cuda.launches - before))


def _corner(body, backward: bool, C, panels, impl):
    """``body(C, *panels, impl)``, the corner's loop.  On the card with the
    CUDA kernels from the graph of its :func:`corner_graph_key`: the first
    call of a key runs the loop eagerly (it loads the kernels and makes
    cuBLAS's handle; its result is the call's) and then captures it; every
    later call copies ``C`` and the panels into the graph's inputs, replays
    it and returns a copy of its output.  Elsewhere the loop runs eagerly."""
    if not _corner_on_graph(C, panels[0], impl):
        return body(C, *panels, impl)
    key = corner_graph_key(C, panels[0], backward)
    with torch.cuda.device(C.device):
        entry = corner_graphs.find(key)
        if entry is None:
            out = body(C, *panels, "cuda")
            corner_graphs.add(key, _capture_corner(body, C, panels))
            return out
        for static, x in zip(entry.inputs, (C,) + tuple(panels)):
            static.copy_(x)
        corner_graphs.replay(entry)
        return entry.out.clone()


def _forward_impl(Dr, R, C, bd, ba, grid, impl=None, start_tile: int = 0):
    """Solve ``L Y = B`` for an RHS panel: bd (ndt, t, k), ba (nat, t, k).

    The band part is one :func:`repro_torch.kernels.ops.band_forward_sweep`
    (the arrow-RHS sums ride it); the corner is a block forward
    substitution with one ``solve_panel`` per corner tile (:func:`_corner`).
    ``start_tile`` exploits RHS sparsity: when the panel is zero above band
    tile ``start_tile``, Y is zero there too and the sweep starts at it."""
    t, ndt, nat = grid.t, grid.n_diag_tiles, grid.n_arrow_tiles
    lead, k = tuple(bd.shape[:-3]), bd.shape[-1]
    if ndt:
        yd, acc_a = ops.band_forward_sweep(Dr, R, bd, start_tile=start_tile, impl=impl)
    else:
        yd, acc_a = bd.new_zeros(lead + (0, t, k)), bd.new_zeros(lead + (nat, t, k))
    if not nat:
        return yd, ba
    return yd, _corner(_forward_corner, False, C, (ba, acc_a), impl)


def _backward_impl(Dr, R, C, yd, ya, grid, impl=None, start_tile: int = 0):
    """Solve ``L^T X = Y`` for an RHS panel: yd (ndt, t, k), ya (nat, t, k).

    Corner first (the arrow panel seeds the band rows; :func:`_corner`),
    then the band part as one
    :func:`repro_torch.kernels.ops.band_backward_sweep`.  Rows below
    ``start_tile`` (an identity prefix with zero RHS) stay zero."""
    t, ndt, nat = grid.t, grid.n_diag_tiles, grid.n_arrow_tiles
    lead, k = tuple(yd.shape[:-3]), yd.shape[-1]
    xa = _corner(_backward_corner, True, C, (ya,), impl) if nat else ya
    if ndt:
        xd = ops.band_backward_sweep(Dr, R, yd, xa.contiguous(), start_tile=start_tile,
                                     impl=impl)
    else:
        xd = yd.new_zeros(lead + (0, t, k))
    return xd, xa


def _solve_panels(Dr, R, C, bd, ba, grid, impl=None, start_tile: int = 0):
    """Full ``A X = B`` on split panels: forward then backward sweep.  A
    leading batch axis on every input solves each element against its own
    factor, each sweep one launch for the batch."""
    yd, ya = _forward_impl(Dr, R, C, bd, ba, grid, impl, start_tile)
    return _backward_impl(Dr, R, C, yd, ya, grid, impl, start_tile)


def _sq_norms(xd: torch.Tensor, xa: torch.Tensor) -> torch.Tensor:
    """Squared 2-norm of each column of split panels ``(..., rows, t,
    k)``: ``(..., k)``."""
    return (xd * xd).sum(dim=(-3, -2)) + (xa * xa).sum(dim=(-3, -2))


def _refine_panels(fDr, fR, fC, mDr, mR, mC, bd, ba, xd, xa, grid, impl=None,
                   start_tile: int = 0):
    """One residual-checked iterative-refinement step for jitter-recovered
    factors: the perturbed factor L (of ``A + tau I``) acts as a
    preconditioner for the *original* A (``mDr``, ``mR``, ``mC``).  ``r =
    B - A X``; ``dX = (L L^T)^{-1} r``; the correction is taken per
    right-hand-side column only where it does not increase the residual's
    norm, so refinement can only help.  Leading batch axes are elements,
    each with its own factor, matrix and columns."""
    from .robustness import ctsf_matvec
    Axd, Axa = ctsf_matvec(mDr, mR, mC, xd, xa, grid)
    rd, ra = bd - Axd, ba - Axa
    n0 = _sq_norms(rd, ra)
    dd, da = _solve_panels(fDr, fR, fC, rd, ra, grid, impl, start_tile)
    xd1, xa1 = xd + dd, xa + da
    A1d, A1a = ctsf_matvec(mDr, mR, mC, xd1, xa1, grid)
    n1 = _sq_norms(bd - A1d, ba - A1a)
    take = (n1 <= n0)[..., None, None, :]
    return torch.where(take, xd1, xd), torch.where(take, xa1, xa)


def _refined_matrix(factor: CholeskyFactor, batch: Optional[int]):
    """The retained original matrix of a jitter-recovered factor when the
    refinement step applies, else None: ``factor.info`` with a matrix on
    the factor's grid and ``tau > 0`` (any element of a batch of
    ``batch``; an element whose ladder ended at a NaN shift has NaN, which
    is not > 0, and is not refined)."""
    info = factor.info
    if info is None or info.matrix is None or info.matrix.grid != factor.ctsf.grid:
        return None
    want = () if batch is None else (batch,)
    if tuple(info.tau.shape) != want or not bool((info.tau > 0).any()):
        return None
    return info.matrix


def _impl(options: Optional[SolverOptions]):
    return (options if options is not None else SolverOptions()).impl


def forward_solve_many(factor: CholeskyFactor, B: torch.Tensor, *, start_tile: int = 0,
                       options: Optional[SolverOptions] = None) -> torch.Tensor:
    """Solve ``L Y = B`` for a panel of right-hand sides in one blocked sweep.

    ``B`` is a ``(padded_n, k)`` float32 panel in the padded layout of
    ``factor.ctsf.grid`` (band rows, then padding, then arrow rows; see
    ``TileGrid.padded_index``), on the factor's device; rows in the padding
    region must be zero.  ``start_tile`` is the first band tile holding a
    nonzero: the caller guarantees the rows above ``start_tile * t`` are
    zero, and Y is zero there.  ``options.impl`` forces a backend.

    Returns the ``(padded_n, k)`` panel Y."""
    c = factor.ctsf
    bd, ba = _split_rhs(c.grid, B)
    yd, ya = _forward_impl(c.Dr, c.R, c.C, bd, ba, c.grid, _impl(options),
                           int(start_tile))
    return _merge_panels(yd, ya)


def backward_solve_many(factor: CholeskyFactor, Y: torch.Tensor, *,
                        options: Optional[SolverOptions] = None) -> torch.Tensor:
    """Solve ``L^T X = Y`` for a ``(padded_n, k)`` panel in one blocked sweep."""
    c = factor.ctsf
    yd, ya = _split_rhs(c.grid, Y)
    xd, xa = _backward_impl(c.Dr, c.R, c.C, yd, ya, c.grid, _impl(options))
    return _merge_panels(xd, xa)


def solve_many(factor: CholeskyFactor, B: torch.Tensor, *,
               options: Optional[SolverOptions] = None) -> torch.Tensor:
    """``A X = B`` for a ``(padded_n, k)`` panel of right-hand sides via
    ``L L^T``: one forward and one backward sweep for all k columns, each
    band step a ``(t, t) @ (t, k)`` product.  On the card that is one
    forward-sweep launch, one backward-sweep launch and ``2 nat``
    ``solve_panel`` launches, the corner's replayed from two CUDA graphs.

    A jitter-recovered factor (``factor.info`` with a retained original
    matrix on the same grid and ``tau > 0``, from ``regularize=``) gets
    one residual-checked refinement step against the original matrix
    (:func:`_refine_panels`: one more solve), correcting most of the
    ``O(tau)`` bias of the diagonal shift; clean factors skip it."""
    c = factor.ctsf
    impl = _impl(options)
    bd, ba = _split_rhs(c.grid, B)
    xd, xa = _solve_panels(c.Dr, c.R, c.C, bd, ba, c.grid, impl)
    m = _refined_matrix(factor, None)
    if m is not None:
        xd, xa = _refine_panels(c.Dr, c.R, c.C, m.Dr, m.R, m.C, bd, ba, xd, xa, c.grid, impl)
    return _merge_panels(xd, xa)


def solve_many_batched(factor: CholeskyFactor, B: torch.Tensor, *, bucket: bool = True,
                       options: Optional[SolverOptions] = None) -> torch.Tensor:
    """``A_i X_i = B_i`` for a batched factor (a leading batch axis on the
    CTSF arrays, as ``factorize_window_batched`` returns it) with each
    element's own ``(padded_n, k)`` panel: ``B (batch, padded_n, k)`` ->
    ``(batch, padded_n, k)``, each element in the padded layout of
    ``factor.ctsf.grid``.

    On the card that is the launches of one :func:`solve_many` for the
    whole batch: one forward-sweep and one backward-sweep launch, and
    ``2 nat`` ``solve_panel`` launches, each element against its own
    corner tile, the corner replayed from a CUDA graph of its batch
    shape.  A jitter-recovered batch (``factor.info`` with ``tau > 0`` on
    some element and the original matrices kept) gets one residual-checked
    refinement pass, one more solve of the batch, whose correction is
    taken only on the elements with ``tau > 0``: their clean siblings come
    back bit for bit as an unrefined call gives them.

    ``bucket`` is the reference's pow2 padding of the batch; PyTorch
    compiles nothing per batch size, so it is accepted and pads nothing,
    as in ``factorize_window_batched``."""
    c = factor.ctsf
    g = c.grid
    t, ndt, nat = g.t, g.n_diag_tiles, g.n_arrow_tiles
    if c.Dr.dim() != 5:
        raise ValueError("solve_many_batched needs a batched factor (leading batch axis), "
                         f"got Dr.ndim={c.Dr.dim()}")
    nb = c.Dr.shape[0]
    if B.dim() != 3 or B.shape[0] != nb or B.shape[1] != g.padded_n:
        raise ValueError(f"rhs panels must be (batch={nb}, padded_n={g.padded_n}, k), "
                         f"got {tuple(B.shape)}")
    impl = _impl(options)
    k = B.shape[2]
    bd = B[:, :ndt * t].reshape(nb, ndt, t, k).contiguous()
    ba = B[:, ndt * t:].reshape(nb, nat, t, k).contiguous()
    xd, xa = _solve_panels(c.Dr, c.R, c.C, bd, ba, g, impl)
    m = _refined_matrix(factor, nb)
    if m is not None:
        xd1, xa1 = _refine_panels(c.Dr, c.R, c.C, m.Dr, m.R, m.C, bd, ba, xd, xa, g, impl)
        use = (factor.info.tau > 0)[:, None, None, None]
        xd, xa = torch.where(use, xd1, xd), torch.where(use, xa1, xa)
    return torch.cat([xd.reshape(nb, ndt * t, k), xa.reshape(nb, nat * t, k)], dim=1)


def forward_solve(factor: CholeskyFactor, b: torch.Tensor, *,
                  options: Optional[SolverOptions] = None) -> torch.Tensor:
    """Solve ``L y = b`` (k = 1 case of the panel sweep)."""
    return forward_solve_many(factor, b.reshape(-1, 1), options=options)[:, 0]


def backward_solve(factor: CholeskyFactor, y: torch.Tensor, *,
                   options: Optional[SolverOptions] = None) -> torch.Tensor:
    """Solve ``L^T x = y`` (k = 1 case of the panel sweep)."""
    return backward_solve_many(factor, y.reshape(-1, 1), options=options)[:, 0]


def solve(factor: CholeskyFactor, b: torch.Tensor, *,
          options: Optional[SolverOptions] = None) -> torch.Tensor:
    """``A x = b`` via ``L L^T``."""
    return solve_many(factor, b.reshape(-1, 1), options=options)[:, 0]


def logdet(factor: CholeskyFactor) -> torch.Tensor:
    """log det A from its Cholesky factor."""
    return factor.logdet()


def _normal(factor: CholeskyFactor, shape, generator: Optional[torch.Generator]):
    return torch.randn(shape, generator=generator, dtype=torch.float32,
                       device=factor.ctsf.device)


def sample_gmrf(factor: CholeskyFactor, *, generator: Optional[torch.Generator] = None,
                z: Optional[torch.Tensor] = None,
                options: Optional[SolverOptions] = None) -> torch.Tensor:
    """Draw ``x ~ N(0, A^{-1})`` as ``x = L^{-T} z``, ``z`` standard normal
    of length ``padded_n``: drawn from ``generator`` (a ``torch.Generator``
    on the factor's device) unless given."""
    if z is None:
        z = _normal(factor, (factor.ctsf.grid.padded_n,), generator)
    return backward_solve(factor, z, options=options)


def sample_gmrf_many(factor: CholeskyFactor, *, num: int,
                     generator: Optional[torch.Generator] = None,
                     z: Optional[torch.Tensor] = None,
                     options: Optional[SolverOptions] = None) -> torch.Tensor:
    """Draw ``num`` samples ``x ~ N(0, A^{-1})`` as one ``(padded_n, num)``
    panel sharing a single backward sweep; ``z`` as in :func:`sample_gmrf`,
    ``(padded_n, num)``."""
    if z is None:
        z = _normal(factor, (factor.ctsf.grid.padded_n, num), generator)
    elif z.dim() != 2 or z.shape[1] != num:
        raise ValueError(f"sample_gmrf_many: z {tuple(z.shape)} is not (padded_n, {num})")
    return backward_solve_many(factor, z, options=options)


def _validate_indices(grid, indices) -> np.ndarray:
    """Validate selected indices against the original matrix dimension and
    map them into the padded layout (arrow indices shift past the band
    padding).  Out-of-range indices raise."""
    s = grid.structure
    idx = np.asarray(indices)
    if idx.ndim != 1:
        raise ValueError(f"indices must be 1-D, got shape {idx.shape}")
    if idx.size and (idx.min() < 0 or idx.max() >= s.n):
        bad = idx[(idx < 0) | (idx >= s.n)]
        raise ValueError(f"indices {bad.tolist()} out of range [0, {s.n})")
    return grid.padded_indices(idx)


def marginal_variances(factor: CholeskyFactor, indices, *,
                       options: Optional[SolverOptions] = None) -> torch.Tensor:
    """Selected diagonal of ``A^{-1}``, INLA's posterior marginal variances.

    ``options.method`` picks the path:

    * ``"selinv"`` (default, ``None``): the blocked Takahashi recurrence
      (:func:`repro_torch.core.selinv.selected_inverse`), one backward tile
      sweep for the whole band + arrow block of Σ, then a gather;
    * ``"panels"``: ``(A^{-1})_ii = ||L^{-1} e_i||^2`` with all k unit
      vectors in one forward sweep, started at the first nonzero tile.

    ``indices`` are element indices of the original matrix (a 1-D host
    array); out-of-range values raise.  Returns the ``(k,)`` variances in
    the order of ``indices``, on the factor's device."""
    opts = options if options is not None else SolverOptions()
    g = factor.ctsf.grid
    padded = _validate_indices(g, indices)
    dev = factor.ctsf.device
    if (opts.method or "selinv") == "selinv":
        from .selinv import selected_inverse
        sigma = selected_inverse(factor, options=opts)
        return sigma.diagonal(padded=True)[torch.as_tensor(padded, device=dev)]
    k = padded.shape[0]
    E = torch.zeros((g.padded_n, k), dtype=torch.float32, device=dev)
    E[torch.as_tensor(padded, device=dev), torch.arange(k, device=dev)] = 1.0
    # unit-vector panels are zero above the smallest selected row
    start = min(int(padded.min()) // g.t, g.n_diag_tiles) if k else 0
    Y = forward_solve_many(factor, E, start_tile=start, options=opts)
    return (Y * Y).sum(dim=0)
