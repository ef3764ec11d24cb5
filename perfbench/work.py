"""Element-level work of the kernels and of a θ step, counted from the
configuration's ``n``, ``bandwidth`` and ``arrow``: a band of half-width
``bandwidth`` over the first ``n - arrow`` rows, full (the factor fills
it), and a dense arrow.  Tile and rung padding are not work, so a change
of tile size or of the kernels' schedule reads the same work.  Bytes count
each input element read once and each output element written once, float32.

Per column ``j`` with ``c_j`` structural nonzeros below the diagonal of
the factor:

* Cholesky: ``(c_j + 1)^2`` operations (a square root, ``c_j`` divisions,
  ``c_j (c_j + 1) / 2`` multiply-adds of the update);
* one triangular sweep of a ``k``-column panel: ``k (2 c_j + 1)``;
* selected inversion (Takahashi): ``2 c_j^2 + 3 c_j + 2``.

``tests/test_perfbench_work.py`` holds each sum to a brute-force count of
scalar algorithms on small dense arrowhead matrices.
"""
from __future__ import annotations

import json
from pathlib import Path

import numpy as np

__all__ = ["column_counts", "cholesky_flops", "sweep_flops", "selinv_flops",
           "band_entries", "sweep_bytes", "solve_bytes", "selinv_bytes", "step_flops",
           "peaks", "least_time"]

BYTES = 4
PEAKS_FILE = Path(__file__).resolve().parent / "peaks.json"


def column_counts(n: int, bandwidth: int, arrow: int) -> np.ndarray:
    """``c_j``: the factor's nonzeros below the diagonal in column ``j``."""
    nd = n - arrow
    j = np.arange(n, dtype=np.int64)
    return np.where(j < nd, np.minimum(bandwidth, nd - 1 - j) + arrow, n - 1 - j)


def _part(cfg, part: str) -> np.ndarray:
    c = column_counts(cfg["n"], cfg["bandwidth"], cfg["arrow"])
    nd = cfg["n"] - cfg["arrow"]
    return {"band": c[:nd], "corner": c[nd:], "all": c}[part]


def cholesky_flops(cfg, part: str = "all") -> float:
    """Operations of the Cholesky factorization over the columns of
    ``part``: ``"band"`` (the band sweep: the band columns with their arrow
    rows and their Schur sums into the corner), ``"corner"`` or ``"all"``."""
    c = _part(cfg, part).astype(np.float64)
    return float(((c + 1.0) ** 2).sum())


def sweep_flops(cfg, k: int, part: str = "all") -> float:
    """Operations of one triangular sweep (forward or backward) of a
    ``k``-column panel over the columns of ``part``."""
    c = _part(cfg, part).astype(np.float64)
    return float(k * (2.0 * c + 1.0).sum())


def selinv_flops(cfg, part: str = "all") -> float:
    """Operations of the selected inversion over the columns of ``part``."""
    c = _part(cfg, part).astype(np.float64)
    return float((2.0 * c * c + 3.0 * c + 2.0).sum())


def band_entries(cfg) -> int:
    """Stored entries of the band columns: the lower band and the arrow rows."""
    n, w, a = cfg["n"], cfg["bandwidth"], cfg["arrow"]
    nd = n - a
    j = np.arange(nd, dtype=np.int64)
    return int((np.minimum(w, nd - 1 - j) + 1).sum() + a * nd)


def sweep_bytes(cfg) -> float:
    """The band sweep: read the band columns, write their factor and the
    lower Schur sum of the corner."""
    a = cfg["arrow"]
    return float(BYTES * (2 * band_entries(cfg) + a * (a + 1) // 2))


def solve_bytes(cfg, k: int) -> float:
    """One band sweep of a ``k``-column panel: read the factor's band
    columns and the panel, write the result (forward: the band rows and
    the arrow sums; backward: read the arrow solution too)."""
    nd, a = cfg["n"] - cfg["arrow"], cfg["arrow"]
    return float(BYTES * (band_entries(cfg) + (2 * nd + a) * k))


def selinv_bytes(cfg) -> float:
    """Pre-pass and recurrence: read the factor's band columns and the
    corner's Σ, write Σ on the band columns."""
    a = cfg["arrow"]
    return float(BYTES * (2 * band_entries(cfg) + a * a))


def step_flops(cfg, readout: str, k: int = 1) -> float:
    """One candidate's θ step: the factorization, the log-determinant (one
    operation a diagonal entry) and the read-out, ``"solve"`` (a forward and
    a backward sweep of ``k`` columns over every column) or ``"selinv"``."""
    total = cholesky_flops(cfg) + cfg["n"]
    if readout == "solve":
        return total + 2.0 * sweep_flops(cfg, k)
    if readout == "selinv":
        return total + selinv_flops(cfg)
    raise ValueError(f"unknown read-out {readout!r}")


def peaks(device_name: str):
    """The data-sheet peaks of a card by its name, or None."""
    table = json.loads(PEAKS_FILE.read_text())
    return table.get(device_name)


def least_time(flops: float, nbytes: float, peak) -> tuple:
    """``(seconds, bound)``: the larger of the compute and memory bounds."""
    tc, tm = flops / peak["fp32_flops"], nbytes / peak["hbm_bytes_per_s"]
    return (tc, "compute") if tc >= tm else (tm, "memory")
