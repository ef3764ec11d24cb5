"""Synthetic matrix generators, copies of the JAX package's
``data/synthetic.py`` (``_base_arrowhead`` and
``block_separable_arrowhead``; the rest comes with the slices that use it).
numpy and scipy only."""
from __future__ import annotations

import scipy.sparse as sp

__all__ = ["block_separable_arrowhead"]


def _base_arrowhead(n, bandwidth, arrow, rho, seed):
    from .gmrf import make_arrowhead
    return make_arrowhead(n, bandwidth, arrow, rho=rho, seed=seed)


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
