"""Concurrent factorizations and read-outs of a batch of matrices (paper
Appendix A).

INLA's central-difference gradient needs 2n independent factorizations of
same-structure matrices; the paper runs them concurrently with NUMA-aware
core binding.  On the card the batch rides one launch a sweep: the
matrices are stacked on a leading batch axis (:func:`stack_ctsf`, which
embeds unequal grids onto their shared canonical rung under a policy),
factorized by ``factorize_window_batched`` and read out by the batched
sweeps, each element on its own thread-block clusters.

Port of the mesh-less half of the JAX package's ``core/concurrent.py``.
The reference's ``mesh=`` shards the batch over devices; that path comes
with the distributed slice (ROADMAP A4), and a ``mesh`` other than None
raises ``NotImplementedError``.
"""
from __future__ import annotations

from typing import Optional

import torch

from .cholesky import CholeskyFactor, factorize_window_batched
from .ctsf import BandedCTSF
from .options import SolverOptions
from .selinv import SelectedInverse, selinv_batched

__all__ = ["stack_ctsf", "concurrent_factorize", "concurrent_logdet",
           "concurrent_quadratic_forms", "concurrent_selinv", "concurrent_solve"]


def _no_mesh(mesh, where: str) -> None:
    if mesh is not None:
        raise NotImplementedError(
            f"{where}: mesh= (the batch sharded over devices) is not ported yet; it comes "
            "with the distributed slice (ROADMAP A4)")


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


def concurrent_factorize(batch: BandedCTSF, *, mesh=None, tree_chunks: int = 8,
                         options: Optional[SolverOptions] = None) -> CholeskyFactor:
    """Factorize a batch of matrices concurrently: the batched
    factorization (``factorize_window_batched`` with ``bucket=False``, as
    the reference delegates), one sweep launch for the batch.  With
    ``options.policy`` the batch is embedded on its canonical grid and the
    factor carries ``source_grid``; ``options.regularize`` flags each
    element OK / RECOVERED / FAILED instead of one bad candidate failing
    the batch."""
    _no_mesh(mesh, "concurrent_factorize")
    return factorize_window_batched(batch, tree_chunks=tree_chunks, bucket=False,
                                    options=options)


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


def concurrent_selinv(factor: CholeskyFactor, *, mesh=None,
                      options: Optional[SolverOptions] = None) -> SelectedInverse:
    """Selected inversion of a batch of factors concurrently: the batched
    recurrence (``selinv_batched`` with ``bucket=False``), two launches for
    the batch; an embedded factor is restricted back to its source grid."""
    _no_mesh(mesh, "concurrent_selinv")
    return selinv_batched(factor, bucket=False, options=options)


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
    nothing)."""
    return factor.logdet()
