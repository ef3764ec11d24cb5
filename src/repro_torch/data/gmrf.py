"""Generators for the paper's Table II matrix suite (INLA/GMRF precision
matrices).

The matrices "are generated within the context of statistical modeling and
can arise from Kronecker products of an inverse covariance matrix
representing temporal and spatial components" (§V-B).  We build them exactly
that way:

    K  = Q_t(rho) ⊗ I_ns  +  I_nt ⊗ Q_s          (spatio-temporal GMRF)
    Q  = [[K,  X], [X^T, D]]                      (+ dense fixed-effect arrow)

* ``Q_t`` — AR(1) tridiagonal temporal precision (rho=0 makes K block
  diagonal, reproducing the paper's observation for bandwidth 100/1000:
  "the diagonal part ... exhibits a block diagonal structure").
* ``Q_s`` — 1-D/2-D lattice Laplacian + tau·I spatial precision with spatial
  coupling radius controlling the within-block band.
* ``X``  — dense coupling of ``arrow`` fixed effects to all latents.
* ``D``  — chosen so the Schur complement stays SPD (diagonal dominance
  certificate, see below).

Every Table II (size, bandwidth, thickness) triple is reproducible via
:func:`table2_matrix`; tests use scaled-down versions through
:func:`make_arrowhead`.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import scipy.sparse as sp

from repro_torch.core.structure import ArrowheadStructure

__all__ = ["ar1_precision", "lattice_precision", "kronecker_st_precision",
           "make_arrowhead", "table2_matrix", "TABLE2"]


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
    """1-D lattice (path graph) precision with given coupling radius.

    Diagonally dominant by construction => SPD with margin tau·1e-3.
    """
    diags, offsets = [], []
    row_weight = np.zeros(ns)
    for r in range(1, radius + 1):
        w = coupling / r
        diags += [np.full(ns - r, -w)] * 2
        offsets += [-r, r]
        row_weight[:ns - r] += w
        row_weight[r:] += w
    main = row_weight + tau
    q = sp.diags([main] + diags, [0] + offsets, format="csc")
    return q


def kronecker_st_precision(nt: int, ns: int, rho: float = 0.7,
                           coupling: float = 0.4, radius: int = 1) -> sp.csc_matrix:
    """Spatio-temporal precision K = Q_t ⊗ I + I ⊗ Q_s (bandwidth = ns·|rho>0| + radius)."""
    qt = ar1_precision(nt, rho)
    qs = lattice_precision(ns, coupling, radius)
    k = sp.kron(qt, sp.eye(ns), format="csc") + sp.kron(sp.eye(nt), qs, format="csc")
    return sp.csc_matrix(k)


def make_arrowhead(n: int, bandwidth: int, arrow: int, rho: float = 0.7,
                   seed: int = 0, density_in_band: float = 1.0,
                   ) -> Tuple[sp.csc_matrix, ArrowheadStructure]:
    """Build an SPD block-arrowhead matrix with the requested structure.

    ``n`` total size, ``bandwidth`` of the leading part, ``arrow`` dense
    trailing rows — mirroring Table II's (Size, Bandwidth, Arrowhead
    Thickness) columns.  ``rho=0`` gives independent diagonal blocks (the
    paper's bandwidth-100/1000 cases).
    """
    rng = np.random.default_rng(seed)
    nd = n - arrow
    ns = max(1, bandwidth)
    nt = max(1, int(np.ceil(nd / ns)))
    k = kronecker_st_precision(nt, ns, rho=rho)[:nd, :nd]
    k = sp.csc_matrix(k)

    if arrow > 0:
        # dense coupling of fixed effects; SPD via Schur diagonal dominance
        x = rng.standard_normal((nd, arrow)) * (0.5 / np.sqrt(nd))
        lam_min_lb = 1e-3  # diag-dominance slack of K by construction
        c = float((x ** 2).sum() / lam_min_lb + 1.0)
        d = np.eye(arrow) * c
        q = sp.bmat([[k, sp.csc_matrix(x)],
                     [sp.csc_matrix(x.T), sp.csc_matrix(d)]], format="csc")
    else:
        q = k
    struct = ArrowheadStructure(n=n, bandwidth=bandwidth, arrow=arrow)
    return sp.csc_matrix(q), struct


# Table II of the paper: (id, size, bandwidth, arrow thickness).
TABLE2 = {
    1: (10_010, 100, 10), 2: (10_010, 200, 10), 3: (10_010, 300, 10),
    4: (10_200, 100, 200), 5: (10_200, 200, 200), 6: (10_200, 300, 200),
    7: (100_010, 1000, 10), 8: (100_010, 2000, 10), 9: (100_010, 3000, 10),
    10: (100_200, 1000, 200), 11: (100_200, 2000, 200), 12: (100_200, 3000, 200),
    13: (500_010, 1000, 10), 14: (500_010, 2000, 10), 15: (500_010, 3000, 10),
    16: (500_200, 1000, 200), 17: (500_200, 2000, 200), 18: (500_200, 3000, 200),
    19: (50_010, 15_000, 10), 20: (1_000_010, 3000, 10),
}

# rho=0 for the block-diagonal cases the paper calls out (IDs 1,7,10,13,16)
_BLOCK_DIAGONAL_IDS = {1, 4, 7, 10, 13, 16}


def table2_matrix(matrix_id: int, scale: float = 1.0, seed: int = 0
                  ) -> Tuple[sp.csc_matrix, ArrowheadStructure]:
    """Instantiate a Table II matrix, optionally scaled down (``scale < 1``)
    for CPU-budget benchmarks — structure ratios are preserved."""
    n, bw, arrow = TABLE2[matrix_id]
    n = max(64, int(n * scale))
    bw = max(4, int(bw * scale)) if scale < 1.0 else bw
    arrow = max(2, int(arrow * scale)) if scale < 1.0 else arrow
    rho = 0.0 if matrix_id in _BLOCK_DIAGONAL_IDS else 0.7
    return make_arrowhead(n, bw, arrow, rho=rho, seed=seed)
