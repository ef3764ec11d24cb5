"""The element-level work counts against a brute-force count of scalar
algorithms on small dense arrowhead matrices (a full band and a dense
arrow), each operation counted where it touches a structural nonzero of
the factor; the scalar algorithms are checked against numpy first."""
import numpy as np
import pytest

from perfbench import work

CASES = [(40, 5, 6), (33, 4, 1), (48, 7, 0), (30, 29, 0), (25, 3, 25), (64, 10, 8)]


def arrowhead(n, w, a, seed=0):
    """A random SPD matrix with a full band of half-width ``w`` over its
    first ``n - a`` rows and ``a`` dense trailing rows."""
    rng = np.random.default_rng(seed)
    nd = n - a
    i, j = np.indices((n, n))
    mask = ((i < nd) & (j < nd) & (np.abs(i - j) <= w)) | (i >= nd) | (j >= nd)
    m = np.where(mask, rng.standard_normal((n, n)), 0.0)
    m = (m + m.T) / 2
    return m + np.diag(np.abs(m).sum(1) + 1.0), mask


def pattern(n, w, a):
    nd = n - a
    i, j = np.indices((n, n))
    return (i > j) & (((i < nd) & (i - j <= w)) | (i >= nd))


def brute_cholesky(m, pat):
    n = len(m)
    L, ops = np.tril(m).copy(), 0
    for k in range(n):
        L[k, k] = np.sqrt(L[k, k])
        ops += 1
        rows = [i for i in range(k + 1, n) if pat[i, k]]
        for i in rows:
            L[i, k] /= L[k, k]
            ops += 1
        for x, i in enumerate(rows):
            for j in rows[:x + 1]:
                L[i, j] -= L[i, k] * L[j, k]
                ops += 2
    return L, ops


def brute_sweep(L, pat, b):
    """Forward substitution ``L y = b`` column by column."""
    n, k = b.shape
    y, ops = b.copy(), 0
    for j in range(n):
        y[j] /= L[j, j]
        ops += k
        for i in range(j + 1, n):
            if pat[i, j]:
                y[i] -= L[i, j] * y[j]
                ops += 2 * k
    return y, ops


def brute_selinv(L, pat):
    """The Takahashi recurrence on the factor's pattern, last column first."""
    n = len(L)
    S, ops = np.zeros((n, n)), 0
    for j in range(n - 1, -1, -1):
        rows = [i for i in range(j + 1, n) if pat[i, j]]
        g = {}
        for k in rows:
            g[k] = L[k, j] / L[j, j]
            ops += 1
        for i in rows:
            acc = 0.0
            for k in rows:
                acc += (S[i, k] if i >= k else S[k, i]) * g[k]
                ops += 2
            S[i, j] = -acc
        d = 1.0 / (L[j, j] * L[j, j])
        ops += 2
        for k in rows:
            d -= S[k, j] * g[k]
            ops += 2
        S[j, j] = d
    return S, ops


@pytest.mark.parametrize("n,w,a", CASES)
def test_counts_match_brute_force(n, w, a):
    m, _ = arrowhead(n, w, a)
    pat = pattern(n, w, a)
    cfg = {"n": n, "bandwidth": w, "arrow": a}
    L, chol_ops = brute_cholesky(m, pat)
    np.testing.assert_allclose(np.tril(L), np.linalg.cholesky(m), rtol=1e-10, atol=1e-10)
    assert chol_ops == work.cholesky_flops(cfg)
    assert work.cholesky_flops(cfg, "band") + work.cholesky_flops(cfg, "corner") == chol_ops
    b = np.random.default_rng(1).standard_normal((n, 3))
    y, sweep_ops = brute_sweep(np.tril(L), pat, b)
    np.testing.assert_allclose(y, np.linalg.solve(np.tril(L), b), rtol=1e-9, atol=1e-9)
    assert sweep_ops == work.sweep_flops(cfg, 3)
    S, sel_ops = brute_selinv(np.tril(L), pat)
    inv = np.linalg.inv(m)
    keep = pat | np.eye(n, dtype=bool)
    np.testing.assert_allclose(S[keep], inv[keep], rtol=1e-9, atol=1e-9)
    assert sel_ops == work.selinv_flops(cfg)


@pytest.mark.parametrize("n,w,a", CASES)
def test_entries_are_the_band_columns_pattern(n, w, a):
    nd = n - a
    pat = pattern(n, w, a) | np.eye(n, dtype=bool)
    cfg = {"n": n, "bandwidth": w, "arrow": a}
    assert work.band_entries(cfg) == int(pat[:, :nd].sum())
    assert work.sweep_bytes(cfg) == 4 * (2 * pat[:, :nd].sum() + a * (a + 1) // 2)


def test_step_flops_add_up():
    cfg = {"n": 10200, "bandwidth": 200, "arrow": 200}
    assert work.step_flops(cfg, "solve", 1) == (work.cholesky_flops(cfg) + 10200
                                               + 2 * work.sweep_flops(cfg, 1))
    assert work.step_flops(cfg, "selinv") == (work.cholesky_flops(cfg) + 10200
                                             + work.selinv_flops(cfg))
    with pytest.raises(ValueError):
        work.step_flops(cfg, "other")


def test_least_time_names_its_bound():
    peak = work.peaks("NVIDIA H100 80GB HBM3")
    assert work.least_time(67e12, 1.0, peak) == (1.0, "compute")
    assert work.least_time(1.0, 3.35e12, peak) == (1.0, "memory")
    assert work.peaks("cpu") is None
