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

Canonical-grid embedded factors (``factor.source_grid`` set by the
policy-aware factorizations, or ``SolverOptions(policy=)`` given with a
plain factor, which is then embedded on the fly) take and return panels in
the source grid's padded layout: the panels are lifted onto the canonical
grid, both sweeps skip the identity prefix through ``start_tile``, and
the results are restricted back (:func:`_embedded_panels`).

Port of the JAX package's ``core/solve.py``.
"""
from __future__ import annotations

import dataclasses
from collections import Counter
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.kernels import ops
from repro_torch.kernels.band_solve import card_solve_plan
from repro_torch.kernels.trsm import solve_panel_cuda
from repro_torch.runtime import telemetry
from .batching import LRUCache, bucketed_batched_call
from .cholesky import BATCHED_CACHE, BatchedEntry, CholeskyFactor, GraphCache, _plannable, capture
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


corner_graphs = GraphCache(CORNER_GRAPH_CACHE, name="corner_graphs")


def _corner_on_graph(C: torch.Tensor, panel: torch.Tensor, impl) -> bool:
    """Whether the corner runs from a CUDA graph: on the card with the CUDA
    kernels, outside a capture of the caller's own (whose capture takes the
    launches instead), with columns to solve."""
    return (C.device.type == "cuda" and ops.resolve_impl(impl, C) == "cuda"
            and panel.shape[-1] > 0 and not torch.cuda.is_current_stream_capturing())


def _capture_corner(body, C, panels) -> _CornerGraph:
    """Capture ``body`` on static copies of ``C`` and the panels into a CUDA
    graph whose output stays in the graph's pool (``cholesky.capture``: other
    threads may allocate meanwhile).  A failed capture raises."""
    inputs = tuple(x.clone() for x in (C,) + tuple(panels))
    graph = torch.cuda.CUDAGraph()
    before = solve_panel_cuda.launches
    with capture(graph):
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


def _resolve_embedding(factor: CholeskyFactor, policy=None):
    """The canonical-grid embedding of a factor for the solve-side entry
    points: ``(ctsf, source_grid, pad)``.  A plain factor without a policy
    is ``(factor.ctsf, None, 0)``; a factor already on a canonical grid
    (``source_grid`` set) is taken as it is; a plain factor with a
    ``policy`` is embedded now (the factor of ``blockdiag(I, A)`` is
    ``blockdiag(I, L)``, so padding a factor is exact), which pads fresh
    arrays every call: a loop reusing one factor should pass the policy to
    the factorization instead."""
    ctsf, src = factor.ctsf, factor.source_grid
    if src is None and policy is not None:
        from .gridpolicy import embed_ctsf
        src, ctsf = ctsf.grid, embed_ctsf(ctsf, policy.canonicalize(ctsf.grid))
    if src is None:
        return ctsf, None, 0
    return ctsf, src, ctsf.grid.n_diag_tiles - src.n_diag_tiles


def _embedded_panels(factor: CholeskyFactor, policy, B: torch.Tensor):
    """The front half of every policy-aware right-hand-side entry point:
    the factor's embedding, the panel ``(..., padded_n, k)`` lifted onto
    its canonical layout, and the restriction that maps a result home.
    Returns ``(ctsf, source_grid, grid, panel, start_tile, restrict)``; for
    a plain factor without a policy the panel passes through, ``start_tile``
    is 0 and ``restrict`` the identity."""
    ctsf, src, pad = _resolve_embedding(factor, policy)
    g = ctsf.grid
    if src is None:
        return ctsf, None, g, B, 0, lambda X: X
    from .gridpolicy import embed_rhs, restrict_rhs
    return ctsf, src, g, embed_rhs(B, src, g), pad, lambda X: restrict_rhs(X, src, g)


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


def _opts(options: Optional[SolverOptions]) -> SolverOptions:
    return options if options is not None else SolverOptions()


def forward_solve_many(factor: CholeskyFactor, B: torch.Tensor, *, start_tile: int = 0,
                       options: Optional[SolverOptions] = None) -> torch.Tensor:
    """Solve ``L Y = B`` for a panel of right-hand sides in one blocked sweep.

    ``B`` is a ``(padded_n, k)`` float32 panel in the padded layout of
    ``factor.ctsf.grid`` (band rows, then padding, then arrow rows; see
    ``TileGrid.padded_index``), on the factor's device; rows in the padding
    region must be zero.  ``start_tile`` is the first band tile holding a
    nonzero: the caller guarantees the rows above ``start_tile * t`` are
    zero, and Y is zero there.  ``options.impl`` forces a backend.

    An embedded factor (``factor.source_grid``, or ``options.policy``)
    takes and returns the source grid's layout, and ``start_tile`` keeps
    its source meaning: the sweep starts past the identity prefix and that
    many tiles more.

    Returns the ``(padded_n, k)`` panel Y."""
    opts = _opts(options)
    with telemetry.span("solve.forward_many", k=B.shape[-1]) as sp:
        ctsf, src, g, B, start, restrict = _embedded_panels(factor, opts.policy, B)
        sp.tag(grid=telemetry.rung_tag(g))
        if src is not None:
            start += min(int(start_tile), src.n_diag_tiles)
        else:
            start = int(start_tile)
        bd, ba = _split_rhs(g, B)
        yd, ya = _forward_impl(ctsf.Dr, ctsf.R, ctsf.C, bd, ba, g, opts.impl, start)
        return restrict(_merge_panels(yd, ya))


def backward_solve_many(factor: CholeskyFactor, Y: torch.Tensor, *,
                        options: Optional[SolverOptions] = None) -> torch.Tensor:
    """Solve ``L^T X = Y`` for a ``(padded_n, k)`` panel in one blocked
    sweep; an embedded factor takes and returns the source layout, as in
    :func:`forward_solve_many`."""
    opts = _opts(options)
    with telemetry.span("solve.backward_many", k=Y.shape[-1]) as sp:
        ctsf, _, g, Y, start, restrict = _embedded_panels(factor, opts.policy, Y)
        sp.tag(grid=telemetry.rung_tag(g))
        yd, ya = _split_rhs(g, Y)
        xd, xa = _backward_impl(ctsf.Dr, ctsf.R, ctsf.C, yd, ya, g, opts.impl, start)
        return restrict(_merge_panels(xd, xa))


def solve_many(factor: CholeskyFactor, B: torch.Tensor, *,
               options: Optional[SolverOptions] = None) -> torch.Tensor:
    """``A X = B`` for a ``(padded_n, k)`` panel of right-hand sides via
    ``L L^T``: one forward and one backward sweep for all k columns, each
    band step a ``(t, t) @ (t, k)`` product.  On the card that is one
    forward-sweep launch, one backward-sweep launch and ``2 nat``
    ``solve_panel`` launches, the corner's replayed from two CUDA graphs.

    An embedded factor (``factor.source_grid``, or ``options.policy``)
    takes and returns the source grid's layout; both sweeps skip the
    identity prefix, so it costs the launches of the source grid's solve.

    A jitter-recovered factor (``factor.info`` with a retained original
    matrix on the same grid and ``tau > 0``, from ``regularize=``) gets
    one residual-checked refinement step against the original matrix
    (:func:`_refine_panels`: one more solve), correcting most of the
    ``O(tau)`` bias of the diagonal shift; clean factors skip it."""
    opts = _opts(options)
    with telemetry.span("solve.solve_many", k=B.shape[-1]) as sp:
        ctsf, _, g, B, start, restrict = _embedded_panels(factor, opts.policy, B)
        sp.tag(grid=telemetry.rung_tag(g))
        bd, ba = _split_rhs(g, B)
        xd, xa = _solve_panels(ctsf.Dr, ctsf.R, ctsf.C, bd, ba, g, opts.impl, start)
        m = _refined_matrix(factor, None)
        if m is not None and m.grid == g:
            xd, xa = _refine_panels(ctsf.Dr, ctsf.R, ctsf.C, m.Dr, m.R, m.C, bd, ba, xd, xa,
                                    g, opts.impl, start)
        return restrict(_merge_panels(xd, xa))


# what the batched solve builds a key (core/batching.py): keyed on the
# grid, the options' compile key and whether a start is shared, not on the
# panel width or the batch, so a stream of shapes on one rung is one entry
_BATCHED_SOLVE_CACHE = LRUCache(maxsize=BATCHED_CACHE, name="batched_solve")


def _card_plans(plans: dict, Dr: torch.Tensor, nat: int, k: int, impl) -> None:
    """Keep the band sweeps' plan of a panel width and batch in ``plans``
    the first time the card runs them (``card_solve_plan``, what the
    wrappers launch)."""
    if Dr.device.type == "cuda" and ops.resolve_impl(impl, Dr) == "cuda" and k:
        t, bt, nb = Dr.shape[-1], Dr.shape[-3] - 1, Dr.shape[0]
        if (k, nb) not in plans:
            plans[(k, nb)] = card_solve_plan(t, bt, nat, k, device=Dr.device, batch=nb)


def _batched_solve_fn(grid, opts: SolverOptions, use_start: bool) -> BatchedEntry:
    """The batched solve's entry for ``grid`` under ``(grid,
    opts.compile_key(), use_start)`` in the cache ``batched_solve``: each
    element solves its own panel.  Its ``call`` takes ``(Dr, R, C, bd, ba,
    start_tile)``."""
    key = (grid, opts.compile_key(), use_start)

    def build() -> BatchedEntry:
        plans: dict = {}

        def call(dr, r, c, bd, ba, s):
            if _plannable(grid):
                _card_plans(plans, dr, grid.n_arrow_tiles, bd.shape[-1], opts.impl)
            return _solve_panels(dr, r, c, bd, ba, grid, opts.impl, s)

        return BatchedEntry(call=call, plans=plans)

    return _BATCHED_SOLVE_CACHE.get_or_create(key, build)


def _batched_refine_fn(grid, opts: SolverOptions, use_start: bool) -> BatchedEntry:
    """The refinement pass of a jitter-recovered batch, a separate entry
    (``use_start``, ``"refine"``) so clean batches never run it: each
    element refines against its own original matrix, and the correction is
    taken only where that element's ``tau > 0``, so a clean element inside
    a recovered batch is bit for bit an unrefined call's.  Its ``call``
    takes the factor, the matrix, the panels, the solution, ``tau`` and
    ``start_tile``."""
    key = (grid, opts.compile_key(), use_start, "refine")

    def build() -> BatchedEntry:
        def call(fdr, fr, fc, mdr, mr, mc, bd, ba, xd, xa, tau, s):
            xd1, xa1 = _refine_panels(fdr, fr, fc, mdr, mr, mc, bd, ba, xd, xa, grid,
                                      opts.impl, s)
            use = (tau > 0)[:, None, None, None]
            return torch.where(use, xd1, xd), torch.where(use, xa1, xa)

        return BatchedEntry(call=call, plans={})

    return _BATCHED_SOLVE_CACHE.get_or_create(key, build)


def solve_many_batched(factor: CholeskyFactor, B: torch.Tensor, *,
                       start_tile: Optional[int] = None, bucket: bool = True,
                       options: Optional[SolverOptions] = None) -> torch.Tensor:
    """``A_i X_i = B_i`` for a batched factor (a leading batch axis on the
    CTSF arrays, as ``factorize_window_batched`` returns it) with each
    element's own ``(padded_n, k)`` panel: ``B (batch, padded_n, k)`` ->
    ``(batch, padded_n, k)``.

    On the card that is the launches of one :func:`solve_many` for the
    whole batch: one forward-sweep and one backward-sweep launch, and
    ``2 nat`` ``solve_panel`` launches, each element against its own
    corner tile, the corner replayed from a CUDA graph of its batch
    shape.  ``bucket`` pads the batch to the next power of two (repeating
    its last element) and strips the padding's results: the corner's graph
    is then captured once for batches of 5 to 8.  What is built once a
    key is kept in the LRU cache ``batched_solve``.

    The panels are in the padded layout of ``factor.ctsf.grid``, except
    for an embedded factor (``factor.source_grid``, or ``options.policy``),
    which takes and returns the source grid's layout, as
    :func:`solve_many` does (the reference takes the canonical layout
    there and has no ``policy``).  ``start_tile`` is the shared
    identity-prefix depth of a batch the caller embedded itself
    (``gridpolicy.assemble_rung_batch``, ``factorize_window_batched(...,
    start_tile=)``), whose panels are in the canonical layout; it is
    refused with an embedded factor, which knows its own.

    A jitter-recovered batch (``factor.info`` with ``tau > 0`` on some
    element and the original matrices kept) gets one residual-checked
    refinement pass, one more solve of the batch, whose correction is
    taken only on the elements with ``tau > 0``: their clean siblings come
    back bit for bit as an unrefined call gives them."""
    opts = _opts(options)
    if factor.ctsf.Dr.dim() != 5:
        raise ValueError("solve_many_batched needs a batched factor (leading batch axis), "
                         f"got Dr.ndim={factor.ctsf.Dr.dim()}")
    nb = factor.ctsf.Dr.shape[0]
    rows = (factor.source_grid or factor.ctsf.grid).padded_n
    if B.dim() != 3 or B.shape[0] != nb or B.shape[1] != rows:
        raise ValueError(f"rhs panels must be (batch={nb}, padded_n={rows}, k), "
                         f"got {tuple(B.shape)}")
    if start_tile is not None and (factor.source_grid is not None or opts.policy is not None):
        raise ValueError("start_tile= is for a batch embedded by its caller; an "
                         "embedded factor skips its own identity prefix")
    k = B.shape[2]
    with telemetry.span("solve.solve_many_batched", b=nb, k=k,
                        grid=telemetry.rung_tag(factor.ctsf.grid)):
        ctsf, src, g, B, start, restrict = _embedded_panels(factor, opts.policy, B)
        if start_tile is not None:
            start = int(start_tile)
        use_start = src is not None or start_tile is not None
        t, ndt, nat = g.t, g.n_diag_tiles, g.n_arrow_tiles
        bd = B[:, :ndt * t].reshape(nb, ndt, t, k).contiguous()
        ba = B[:, ndt * t:].reshape(nb, nat, t, k).contiguous()
        entry = _batched_solve_fn(g, opts, use_start)
        xd, xa = bucketed_batched_call(
            lambda dr, r, c, pd, pa: entry.call(dr, r, c, pd, pa, start),
            (ctsf.Dr, ctsf.R, ctsf.C, bd, ba), bucket)
        m = _refined_matrix(factor, nb)
        if m is not None and m.grid == g:
            rentry = _batched_refine_fn(g, opts, use_start)
            xd, xa = bucketed_batched_call(
                lambda *a: rentry.call(*a, start),
                (ctsf.Dr, ctsf.R, ctsf.C, m.Dr, m.R, m.C, bd, ba, xd, xa, factor.info.tau),
                bucket)
        return restrict(torch.cat([xd.reshape(nb, ndt * t, k), xa.reshape(nb, nat * t, k)],
                                  dim=1))


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


def _rhs_grid(factor: CholeskyFactor):
    """The grid whose padded layout right-hand sides use: the source grid
    of an embedded factor, else the factor's own."""
    return factor.source_grid or factor.ctsf.grid


def _normal(factor: CholeskyFactor, shape, generator: Optional[torch.Generator]):
    return torch.randn(shape, generator=generator, dtype=torch.float32,
                       device=factor.ctsf.device)


def sample_gmrf(factor: CholeskyFactor, *, generator: Optional[torch.Generator] = None,
                z: Optional[torch.Tensor] = None,
                options: Optional[SolverOptions] = None) -> torch.Tensor:
    """Draw ``x ~ N(0, A^{-1})`` as ``x = L^{-T} z``, ``z`` standard normal
    of length ``padded_n``: drawn from ``generator`` (a ``torch.Generator``
    on the factor's device) unless given, in the source layout of an
    embedded factor."""
    if z is None:
        z = _normal(factor, (_rhs_grid(factor).padded_n,), generator)
    return backward_solve(factor, z, options=options)


def sample_gmrf_many(factor: CholeskyFactor, *, num: int,
                     generator: Optional[torch.Generator] = None,
                     z: Optional[torch.Tensor] = None,
                     options: Optional[SolverOptions] = None) -> torch.Tensor:
    """Draw ``num`` samples ``x ~ N(0, A^{-1})`` as one ``(padded_n, num)``
    panel sharing a single backward sweep; ``z`` as in :func:`sample_gmrf`,
    ``(padded_n, num)``.  For an embedded factor ``z`` is drawn in the
    source layout, so a bucketed factor gives the unbucketed draws for the
    same generator state."""
    with telemetry.span("solve.sample_gmrf_many", num=num):
        if z is None:
            z = _normal(factor, (_rhs_grid(factor).padded_n, num), generator)
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
    array), the source problem's for an embedded factor (or under
    ``options.policy``); out-of-range values raise.  Returns the ``(k,)``
    variances in the order of ``indices``, on the factor's device."""
    opts = _opts(options)
    g = _rhs_grid(factor)
    padded = _validate_indices(g, indices)
    dev = factor.ctsf.device
    mth = opts.method or "selinv"
    k = padded.shape[0]
    with telemetry.span("solve.marginal_variances", method=mth, k=k,
                        grid=telemetry.rung_tag(g)):
        if mth == "selinv":
            from .selinv import selected_inverse
            sigma = selected_inverse(factor, options=opts)
            return sigma.diagonal(padded=True)[torch.as_tensor(padded, device=dev)]
        E = torch.zeros((g.padded_n, k), dtype=torch.float32, device=dev)
        E[torch.as_tensor(padded, device=dev), torch.arange(k, device=dev)] = 1.0
        # unit-vector panels are zero above the smallest selected row
        start = min(int(padded.min()) // g.t, g.n_diag_tiles) if k else 0
        Y = forward_solve_many(factor, E, start_tile=start, options=opts)
        return (Y * Y).sum(dim=0)
