"""Synthetic matrix generators, copies of the JAX package's
``data/synthetic.py``: ``block_separable_arrowhead`` and the three
pathological generators of the breakdown-recovery tests (the token
streams come with the slices that use them).  numpy and scipy only, with
the reference's seeding, so both packages corrupt the same entries.

* :func:`indefinite_arrowhead` — SPD arrowhead with a known negative shift
  applied to part of the diagonal (Cholesky breaks down at a predictable
  pivot);
* :func:`near_singular_arrowhead` — SPD with smallest eigenvalue driven to
  a requested tiny value (factorizable in exact arithmetic, pivots at the
  float32 cliff);
* :func:`nan_contaminated_arrowhead` — SPD with seeded NaN entries
  (symmetrically placed), the "silent NaN downstream" case detection must
  flag.
"""
from __future__ import annotations

import numpy as np
import scipy.sparse as sp

__all__ = ["indefinite_arrowhead", "near_singular_arrowhead", "nan_contaminated_arrowhead",
           "block_separable_arrowhead"]


def _base_arrowhead(n, bandwidth, arrow, rho, seed):
    from .gmrf import make_arrowhead
    return make_arrowhead(n, bandwidth, arrow, rho=rho, seed=seed)


def indefinite_arrowhead(n: int, bandwidth: int, arrow: int,
                         rho: float = 0.7, seed: int = 0,
                         shift: float = 10.0, frac: float = 0.1):
    """SPD arrowhead made indefinite by subtracting ``shift * mean_diag``
    from a seeded random ``frac`` of the diagonal.  The negative Cholesky
    pivot lands near the first corrupted index, so tests can assert the
    detector's ``first_bad`` tile.  Returns ``(csc_matrix, structure)``."""
    A, st = _base_arrowhead(n, bandwidth, arrow, rho, seed)
    rng = np.random.default_rng(np.random.SeedSequence([seed, 1]))
    k = max(1, int(frac * n))
    idx = np.sort(rng.choice(n, size=k, replace=False))
    A = sp.lil_matrix(A)
    d = A.diagonal()
    drop = shift * float(d.mean())
    for i in idx:
        A[i, i] = d[i] - drop
    return sp.csc_matrix(A), st


def near_singular_arrowhead(n: int, bandwidth: int, arrow: int,
                            rho: float = 0.7, seed: int = 0,
                            eig_min: float = 1e-6):
    """SPD arrowhead whose smallest eigenvalue is shifted down to
    ``eig_min`` (exact arithmetic keeps it factorizable; float32 pivots sit
    at the breakdown threshold — the case ``pivot_rtol`` exists for).
    Returns ``(csc_matrix, structure)``."""
    A, st = _base_arrowhead(n, bandwidth, arrow, rho, seed)
    lam_min = float(np.linalg.eigvalsh(A.toarray()).min())
    return sp.csc_matrix(A - sp.eye(n, format="csc") * (lam_min - eig_min)), st


def nan_contaminated_arrowhead(n: int, bandwidth: int, arrow: int,
                               rho: float = 0.7, seed: int = 0,
                               count: int = 1):
    """SPD arrowhead with ``count`` seeded NaN entries placed symmetrically
    on existing structural nonzeros — the silent-corruption case the
    sweep's ``nonfinite`` flag must catch.  Returns ``(csc_matrix,
    structure)``."""
    A, st = _base_arrowhead(n, bandwidth, arrow, rho, seed)
    rng = np.random.default_rng(np.random.SeedSequence([seed, 2]))
    A = sp.lil_matrix(A)
    rows, cols = A.nonzero()
    for pick in rng.choice(len(rows), size=min(count, len(rows)), replace=False):
        i, j = int(rows[pick]), int(cols[pick])
        A[i, j] = np.nan
        A[j, i] = np.nan
    return sp.csc_matrix(A), st


def block_separable_arrowhead(n: int, bandwidth: int, arrow: int,
                              t: int, n_parts: int = 2,
                              rho: float = 0.7, seed: int = 0):
    """SPD arrowhead whose band splits into ``n_parts`` independent
    partitions at tile-aligned cuts — the post-adaptive-ND shape
    (paper §III-A, Fig. 4) the partitioned sweep exists for.

    Starts from :func:`~repro_torch.data.gmrf.make_arrowhead` and zeroes
    every band entry coupling elements on opposite sides of the cuts at
    tiles ``round(ndt * p / n_parts)`` (cuts on the *tile* grid of size
    ``t``, so :func:`~repro_torch.core.ordering.detect_partition_plan`
    certifies them exactly).  Zeroing off-diagonals only *increases*
    diagonal dominance, so the result stays SPD.  The dense arrow block —
    the moved separator — still couples all partitions.

    Returns ``(csc_matrix, structure, boundaries)`` with ``boundaries``
    the tile-boundary tuple a
    :class:`~repro_torch.core.ordering.PartitionPlan` takes.
    """
    if t <= 0 or n_parts < 1:
        raise ValueError(f"need t > 0 and n_parts >= 1, got {t}, {n_parts}")
    A, st = _base_arrowhead(n, bandwidth, arrow, rho, seed)
    nd = st.n_diag
    ndt = -(-nd // t)
    cuts = sorted({min(ndt, max(1, round(ndt * p / n_parts)))
                   for p in range(1, n_parts)} - {ndt})
    A = A.tolil()
    for c in cuts:
        ce = c * t                     # element index of the cut
        lo = max(0, ce - bandwidth)
        hi = min(nd, ce + bandwidth)
        A[ce:hi, lo:ce] = 0
        A[lo:ce, ce:hi] = 0
    return sp.csc_matrix(A), st, tuple([0] + cuts + [ndt])
