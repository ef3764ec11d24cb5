"""Concurrent factorizations and read-outs of a batch of matrices (paper
Appendix A).

INLA's central-difference gradient needs 2n independent factorizations of
same-structure matrices; the paper runs them concurrently with NUMA-aware
core binding.  On the card the batch rides one launch a sweep: the
matrices are stacked on a leading batch axis (:func:`stack_ctsf`, which
embeds unequal grids onto their shared canonical rung under a policy),
factorized by ``factorize_window_batched`` and read out by the batched
sweeps, each element on its own thread-block clusters.

With a ``mesh`` (a :class:`torch.distributed.device_mesh.DeviceMesh`,
``launch/mesh.py``) the batch is sharded over the mesh's ``axis``: each
rank is passed the whole batch, as the reference's caller passes one
global array, and factorizes its slice of it, one launch a sweep, so one
factorization never spans devices (App. A's within-NUMA binding).  The
small per-element outputs — the status words, ``FactorInfo``, the
log-determinants — are all-gathered along the axis, so every rank holds
the whole batch's, as the reference replicates its status words; the
jitter ladder decides on the gathered statuses, so every rank runs the
same attempts.

Port of the JAX package's ``core/concurrent.py``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.sharding.collectives import all_gather
from .cholesky import (CholeskyFactor, _embed_matrix, _factorize, _shift_plan, _window_call,
                       factorize_window_batched)
from .ctsf import BandedCTSF
from .distributed import mesh_axis
from .options import SolverOptions
from .robustness import FactorInfo
from .selinv import SelectedInverse, _selinv_impl, selinv_batched

__all__ = ["stack_ctsf", "concurrent_factorize", "concurrent_logdet",
           "concurrent_quadratic_forms", "concurrent_selinv", "concurrent_solve"]


def _shard(mesh, axis: str, b: int):
    """``(group, lo, hi)``: mesh dimension ``axis``'s group and this rank's
    elements ``[lo, hi)`` of a batch of ``b``."""
    group, me, size = mesh_axis(mesh, axis)
    if b % size:
        raise ValueError(f"a batch of {b} does not split over mesh axis {axis}={size}")
    per = b // size
    return group, me * per, (me + 1) * per


def _local(m: BandedCTSF, lo: int, hi: int) -> BandedCTSF:
    return BandedCTSF(m.grid, *(x[lo:hi] for x in m.arrays()))


def stack_ctsf(mats: list, policy=None) -> BandedCTSF:
    """Stack :class:`BandedCTSF` matrices on a leading batch axis.

    Without a policy every matrix must be on one grid (unequal grids raise
    ``ValueError``).  With a :class:`~repro_torch.core.gridpolicy.
    GridBucketPolicy` the matrices are first embedded onto their shared
    canonical rung (``policy.join``) with identity-diagonal padding, so a
    mixed-size batch rides one batched factorization.  The result is a
    plain batch on the canonical grid: its factor's solves take that
    grid's layout, not each matrix's source layout."""
    if not mats:
        raise ValueError("stack_ctsf needs at least one matrix")
    if policy is not None:
        from .gridpolicy import embed_ctsf
        cgrid = policy.join([m.grid for m in mats])
        mats = [embed_ctsf(m, cgrid) for m in mats]
    grid = mats[0].grid
    if any(m.grid != grid for m in mats):
        raise ValueError(
            "concurrent factorization needs equal structure: got grids with (ndt, bt, nat) = "
            f"{sorted({(x.grid.n_diag_tiles, x.grid.band_tiles, x.grid.n_arrow_tiles) for x in mats})}"
            "; pass a GridBucketPolicy (policy=) to embed them onto a shared canonical rung")
    return BandedCTSF(grid, *(torch.stack([getattr(m, x) for m in mats])
                              for x in ("Dr", "R", "C")))


def concurrent_factorize(batch: BandedCTSF, *, mesh=None, axis: str = "data",
                         tree_chunks: int = 8,
                         options: Optional[SolverOptions] = None) -> CholeskyFactor:
    """Factorize a batch of matrices concurrently.

    Without ``mesh``: the batched factorization (``factorize_window_batched``
    with ``bucket=False``, as the reference delegates), one sweep launch for
    the batch.  With ``mesh``: this rank's slice of the batch along
    ``axis`` (which must divide the batch), one sweep launch for the slice;
    the factor holds the slice (``mesh``, ``axis`` and ``offset`` set) and
    the whole batch's status words, the same on every rank.

    ``options.policy`` embeds the batch on its canonical grid and the
    factor carries ``source_grid``; ``options.regularize`` flags each
    element OK / RECOVERED / FAILED instead of one bad candidate failing the
    batch (on a mesh, ``factor.info`` is the whole batch's, equal to the
    unsharded call's on every rank)."""
    if mesh is None:
        return factorize_window_batched(batch, tree_chunks=tree_chunks, bucket=False,
                                        options=options)
    opts = options if options is not None else SolverOptions()
    group, lo, hi = _shard(mesh, axis, batch.Dr.shape[0])
    gather = lambda x: all_gather(x, group)
    local, source, start = _local(batch, lo, hi), None, 0
    if opts.policy is not None:
        local, source, start = _embed_matrix(local, opts.policy)
        opts = _shift_plan(opts, start)
    f = _factorize(*local.arrays(), local.grid,
                   _window_call(local.grid, opts, tree_chunks, start), opts.regularize,
                   gather=gather)
    info = f.info
    if info is not None:
        info = FactorInfo(*(gather(x) for x in (info.status, info.attempts, info.tau,
                                                info.min_pivot, info.first_bad_tile)),
                          matrix=info.matrix)
    return CholeskyFactor(f.ctsf, gather(f.status), info, source_grid=source, mesh=mesh,
                          axis=axis, offset=lo)


def concurrent_solve(factor: CholeskyFactor, B: torch.Tensor, *,
                     options: Optional[SolverOptions] = None) -> torch.Tensor:
    """Solve ``A_i X_i = B`` for every factor of a batch with one ``B`` for
    all: ``(padded_n,)`` or ``(padded_n, k)`` in the padded layout (the
    source layout for an embedded factor) -> ``(batch, padded_n)`` or
    ``(batch, padded_n, k)``.  Each sweep is one launch for the batch, the
    corner one ``solve_panel`` a tile for the batch."""
    from .solve import _embedded_panels, _solve_panels, _split_rhs
    opts = options if options is not None else SolverOptions()
    panel = B[:, None] if B.dim() == 1 else B
    ctsf, _, g, panel, start, restrict = _embedded_panels(factor, opts.policy, panel)
    nb = ctsf.Dr.shape[0]
    bd, ba = (x.expand((nb,) + tuple(x.shape)).contiguous() for x in _split_rhs(g, panel))
    xd, xa = _solve_panels(ctsf.Dr, ctsf.R, ctsf.C, bd, ba, g, opts.impl, start)
    k = panel.shape[-1]
    out = restrict(torch.cat([xd.reshape(nb, -1, k), xa.reshape(nb, -1, k)], dim=1))
    return out[..., 0] if B.dim() == 1 else out


def concurrent_selinv(factor: CholeskyFactor, *, mesh=None, axis: str = "data",
                      options: Optional[SolverOptions] = None) -> SelectedInverse:
    """Selected inversion of a batch of factors concurrently.

    Without ``mesh``: the batched recurrence (``selinv_batched`` with
    ``bucket=False``), two launches for the batch.  With ``mesh``: the
    recurrence on this rank's elements only (a factor from
    ``concurrent_factorize(mesh=)`` on the same mesh and axis as it is, a
    whole batched factor sliced as ``concurrent_factorize`` slices a
    batch), two launches for them, so a θ-sweep's factors and their
    marginals stay on the rank end to end; the result holds those
    elements.  An embedded factor is restricted back to its source grid."""
    if mesh is None:
        return selinv_batched(factor, bucket=False, options=options)
    opts = options if options is not None else SolverOptions()
    if factor.mesh is None:
        _, lo, hi = _shard(mesh, axis, factor.ctsf.Dr.shape[0])
        factor = dataclasses.replace(factor, ctsf=_local(factor.ctsf, lo, hi))
    elif factor.mesh is not mesh or factor.axis != axis:
        raise ValueError(f"the factor is sharded over axis {factor.axis!r} of its own mesh; "
                         "pass mesh=factor.mesh, axis=factor.axis")
    from .solve import _resolve_embedding
    c, src, pad = _resolve_embedding(factor, opts.policy)
    out = SelectedInverse(c.grid, *_selinv_impl(c.Dr, c.R, c.C, c.grid, opts.impl, pad))
    if src is None:
        return out
    from .gridpolicy import restrict_selinv
    return restrict_selinv(out, src)


def concurrent_quadratic_forms(factor: CholeskyFactor, y: torch.Tensor, *,
                               options: Optional[SolverOptions] = None) -> torch.Tensor:
    """``y^T A_i^{-1} y`` for each factor of the batch, as ``||L_i^{-1}
    y||^2``: the forward sweep only (one launch for the batch), half a
    solve, the quadratic-form term of INLA's objective a θ candidate.  An
    embedded factor takes ``y`` in the source layout; the prefix rows of
    its sweep are zero, so the norm needs no restriction."""
    from .solve import _embedded_panels, _forward_impl, _split_rhs
    opts = options if options is not None else SolverOptions()
    ctsf, _, g, panel, start, _ = _embedded_panels(factor, opts.policy, y.reshape(-1, 1))
    nb = ctsf.Dr.shape[0]
    bd, ba = (x.expand((nb,) + tuple(x.shape)).contiguous() for x in _split_rhs(g, panel))
    yd, ya = _forward_impl(ctsf.Dr, ctsf.R, ctsf.C, bd, ba, g, opts.impl, start)
    return (yd * yd).sum(dim=(1, 2, 3)) + (ya * ya).sum(dim=(1, 2, 3))


def concurrent_logdet(factor: CholeskyFactor) -> torch.Tensor:
    """The ``(batch,)`` log-determinants of a batched factor, INLA's
    quantity an evaluation (the identity prefix of an embedded factor adds
    nothing); a rank's share of a sharded factor gathers the whole batch's
    along its mesh axis, the same on every rank."""
    if factor.mesh is None:
        return factor.logdet()
    group, _, _ = mesh_axis(factor.mesh, factor.axis)
    return all_gather(factor.logdet(), group)
