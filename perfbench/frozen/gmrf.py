"""Table II matrices of the sTiles paper (arXiv 2501.02483), frozen from
``repro_torch/data/gmrf.py``: the spatio-temporal GMRF precision
``K = Q_t(rho) ⊗ I_ns + I_nt ⊗ Q_s`` bordered by ``arrow`` dense
fixed-effect rows, SPD by diagonal dominance of the Schur complement.
numpy and scipy only; the same seed gives the same matrix."""
from __future__ import annotations

import numpy as np
import scipy.sparse as sp

__all__ = ["TABLE2", "make_arrowhead", "table2_matrix"]

# Table II of the paper: id -> (size, bandwidth, arrow thickness).
TABLE2 = {
    1: (10_010, 100, 10), 2: (10_010, 200, 10), 3: (10_010, 300, 10),
    4: (10_200, 100, 200), 5: (10_200, 200, 200), 6: (10_200, 300, 200),
    7: (100_010, 1000, 10), 8: (100_010, 2000, 10), 9: (100_010, 3000, 10),
    10: (100_200, 1000, 200), 11: (100_200, 2000, 200), 12: (100_200, 3000, 200),
    13: (500_010, 1000, 10), 14: (500_010, 2000, 10), 15: (500_010, 3000, 10),
    16: (500_200, 1000, 200), 17: (500_200, 2000, 200), 18: (500_200, 3000, 200),
    19: (50_010, 15_000, 10), 20: (1_000_010, 3000, 10),
}
# rho = 0 (a block-diagonal band) for the cases the paper calls out
BLOCK_DIAGONAL_IDS = {1, 4, 7, 10, 13, 16}


def ar1_precision(nt: int, rho: float = 0.7, tau: float = 1.0) -> sp.csc_matrix:
    """AR(1) precision: tridiagonal, SPD for |rho| < 1."""
    main = np.full(nt, 1.0 + rho * rho)
    if nt > 0:
        main[0] = main[-1] = 1.0
    off = np.full(max(nt - 1, 0), -rho)
    q = sp.diags([off, main, off], [-1, 0, 1], format="csc") * tau
    return q + sp.eye(nt, format="csc") * 1e-3


def lattice_precision(ns: int, coupling: float = 0.4, radius: int = 1,
                      tau: float = 1.0) -> sp.csc_matrix:
    """1-D lattice precision with coupling radius ``radius``, diagonally
    dominant by construction."""
    diags, offsets = [], []
    row_weight = np.zeros(ns)
    for r in range(1, radius + 1):
        w = coupling / r
        diags += [np.full(ns - r, -w)] * 2
        offsets += [-r, r]
        row_weight[:ns - r] += w
        row_weight[r:] += w
    return sp.diags([row_weight + tau] + diags, [0] + offsets, format="csc")


def kronecker_st_precision(nt: int, ns: int, rho: float = 0.7,
                           coupling: float = 0.4, radius: int = 1) -> sp.csc_matrix:
    """``Q_t ⊗ I + I ⊗ Q_s``: bandwidth ``ns`` when rho > 0."""
    qt = ar1_precision(nt, rho)
    qs = lattice_precision(ns, coupling, radius)
    return sp.csc_matrix(sp.kron(qt, sp.eye(ns), format="csc")
                         + sp.kron(sp.eye(nt), qs, format="csc"))


def make_arrowhead(n: int, bandwidth: int, arrow: int, rho: float = 0.7,
                   seed: int = 0) -> sp.csc_matrix:
    """The SPD block-arrowhead matrix of size ``n`` with a band of half-width
    ``bandwidth`` over its first ``n - arrow`` rows and ``arrow`` dense
    trailing rows; ``rho = 0`` makes the band block-diagonal."""
    rng = np.random.default_rng(seed)
    nd = n - arrow
    ns = max(1, bandwidth)
    nt = max(1, int(np.ceil(nd / ns)))
    k = sp.csc_matrix(kronecker_st_precision(nt, ns, rho=rho)[:nd, :nd])
    if arrow == 0:
        return k
    # dense coupling of the fixed effects; SPD by Schur diagonal dominance
    x = rng.standard_normal((nd, arrow)) * (0.5 / np.sqrt(nd))
    c = float((x ** 2).sum() / 1e-3 + 1.0)
    q = sp.bmat([[k, sp.csc_matrix(x)],
                 [sp.csc_matrix(x.T), sp.csc_matrix(np.eye(arrow) * c)]], format="csc")
    return sp.csc_matrix(q)


def table2_matrix(matrix_id: int, seed: int = 0) -> sp.csc_matrix:
    """Table II matrix ``matrix_id`` at its published size."""
    n, bw, arrow = TABLE2[matrix_id]
    rho = 0.0 if matrix_id in BLOCK_DIAGONAL_IDS else 0.7
    return make_arrowhead(n, bw, arrow, rho=rho, seed=seed)
