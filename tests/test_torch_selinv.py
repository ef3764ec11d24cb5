"""The port's selected inversion against the JAX package, on the CPU.

``selected_inverse`` of the reference factor carried in with
``CholeskyFactor.from_arrays`` is held to ``repro``'s at rtol = atol =
2e-4 (float32 on both sides, different summation orders), its accessors
included.  The chain from each package's own factorization is held to
``numpy.linalg.inv`` of the dense matrix on every stored band + arrow
entry at the reference's bound (5e-6 of max(1, max|inv|),
test_selinv.py)."""
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

import repro.core as J
from repro.data import make_arrowhead as jmake_arrowhead
from repro_torch.core import (BandedCTSF, CholeskyFactor, SelectedInverse, SolverOptions,
                              TileGrid, factorize_window, selected_inverse)
from repro_torch.data import make_arrowhead
from repro_torch.kernels import ref
from repro_torch.kernels.selinv import (MAX_SELINV_CLUSTER, SELINV_CLUSTER, selinv_plan,
                                        selinv_sweep_cuda)

TOL = dict(rtol=2e-4, atol=2e-4)
JREF = J.SolverOptions(impl="ref")
GRIDS = [(16, 4, 0, 16), (30, 6, 14, 16), (160, 8, 0, 16), (130, 40, 30, 16),
         (96, 40, 16, 8), (200, 40, 40, 32), (300, 70, 70, 64)]
QUICKSTART = (2048, 48, 32, 32)


def _chip_smoke():
    """chip_smoke.py as a module (its input makers need no card)."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _factors(n, bw, ar, t, seed=0):
    A, st = jmake_arrowhead(n, bw, ar, rho=0.6, seed=seed)
    grid = J.TileGrid(st, t=t)
    jf = J.factorize_window(J.BandedCTSF.from_sparse(A, grid), options=JREF)
    s = grid.structure
    tf = CholeskyFactor.from_arrays((s.n, s.bandwidth, s.arrow, t),
                                    *(np.asarray(x) for x in jf.ctsf.arrays()), device="cpu")
    return jf, tf, grid


def _pattern(grid):
    """Dense mask of the stored band + arrow pattern (where Σ is kept)."""
    ones = BandedCTSF.eye(grid, device="cpu")
    full = BandedCTSF(grid, torch.ones_like(ones.Dr), torch.ones_like(ones.R),
                      torch.ones_like(ones.C))
    return full.to_dense(lower_only=False) > 0


@pytest.mark.parametrize("n,bw,ar,t", GRIDS)
def test_selected_inverse_matches_reference(n, bw, ar, t):
    jf, tf, grid = _factors(n, bw, ar, t)
    got = selected_inverse(tf)
    want = J.selected_inverse(jf, options=JREF)
    for name in ("Dr", "R", "C"):
        np.testing.assert_allclose(getattr(got, name).numpy(), np.asarray(getattr(want, name)),
                                   err_msg=name, **TOL)
    np.testing.assert_allclose(got.diagonal().numpy(), np.asarray(want.diagonal()), **TOL)
    np.testing.assert_allclose(got.diagonal(padded=True).numpy(),
                               np.asarray(want.diagonal(padded=True)), **TOL)
    pairs = [(0, 0), (1, 0), (n - 1, n - 1), (n // 2, n // 2 - 1)] + ([(n - 1, 0)] if ar else [])
    for i, j in pairs:
        np.testing.assert_allclose(float(got.covariance(i, j)),
                                   float(want.covariance(i, j)), **TOL)
    np.testing.assert_allclose(got.to_dense_band(), want.to_dense_band(), **TOL)
    assert got.nbytes() == want.nbytes()


@pytest.mark.parametrize("n,bw,ar,t", GRIDS + [QUICKSTART])
def test_selected_inverse_chain_matches_dense_inverse(n, bw, ar, t):
    """from_sparse -> factorize_window -> selected_inverse in the port
    reproduces every stored entry of numpy.linalg.inv(A)."""
    A, st = make_arrowhead(n, bw, ar, rho=0.6, seed=1)
    m = BandedCTSF.from_sparse(A, TileGrid(st, t=t), device="cpu")
    sigma = selected_inverse(factorize_window(m))
    inv = np.linalg.inv(m.to_dense(lower_only=False).astype(np.float64))
    err = np.abs(np.where(_pattern(m.grid), sigma.to_dense_band() - inv, 0.0)).max()
    assert err < 5e-6 * max(1.0, np.abs(inv).max())


def test_accessors_and_from_arrays():
    jf, tf, grid = _factors(160, 16, 16, 16)
    want = J.selected_inverse(jf, options=JREF)
    s = grid.structure
    carried = SelectedInverse.from_arrays((s.n, s.bandwidth, s.arrow, grid.t),
                                          *(np.asarray(x) for x in want.arrays()), device="cpu")
    got = selected_inverse(tf)
    for a, b in zip(carried.arrays(), got.arrays()):
        torch.testing.assert_close(a, b, **TOL)
    assert got.diagonal().shape == (s.n,)
    with pytest.raises(ValueError, match="outside the stored band"):
        got.covariance(0, 120)
    with pytest.raises(ValueError, match="out of range"):
        got.covariance(0, 200)
    np.testing.assert_allclose(float(got.covariance(3, 159)), float(got.covariance(159, 3)))


def test_selected_inverse_dispatch_on_the_cpu():
    """CPU tensors take the plain sweep and launch nothing; impl="cuda"
    on them raises."""
    _, tf, _ = _factors(130, 40, 30, 16)
    before = selinv_sweep_cuda.launches
    a = selected_inverse(tf)
    b = selected_inverse(tf, options=SolverOptions(impl="ref"))
    for x, y in zip(a.arrays(), b.arrays()):
        torch.testing.assert_close(x, y, rtol=0, atol=0)
    assert selinv_sweep_cuda.launches == before
    with pytest.raises(ValueError, match="CUDA"):
        selected_inverse(tf, options=SolverOptions(impl="cuda"))


# (t, bt, nat, ndt) of the recurrence's plan checks: chip_smoke.py's grid
# of the sweep (t in {16, 64}, bt and nat in {0, 1, 4}), a single column,
# and fewer columns than band tiles; t = 8 and 32 at one shape each
PLAN_CASES = ([(t, bt, nat, 6) for t in (16, 64) for bt in (0, 1, 4) for nat in (0, 1, 4)]
              + [(64, 4, 4, 1), (16, 4, 1, 3), (8, 2, 2, 5), (32, 3, 2, 5)])


def _lower_subtile(s):
    """Row-major index of a lower sub-tile -> (row, column)."""
    r = 0
    while (r + 1) * (r + 2) // 2 <= s:
        r += 1
    return r, s - r * (r + 1) // 2


@pytest.mark.parametrize("t,bt,nat,ndt", PLAN_CASES)
@pytest.mark.parametrize("max_cluster", [1, 4, 8, 16])
def test_selinv_plan_covers_every_pair_once(t, bt, nat, ndt, max_cluster):
    """Every (column, target, sub-tile, pair) of the recurrence is summed
    exactly once, each target sub-tile whole on one rank with its pairs in
    order; every pair of every lower diagonal sub-tile exactly once, in
    contiguous runs in rank order that start at the sub-tile's owner."""
    plan = selinv_plan(t, bt, nat, max_cluster)
    ns = plan.ns
    assert plan.sub == min(t, 32) and plan.diag_subtiles == ns * (ns + 1) // 2
    assert plan.diag_subtiles <= plan.cluster <= MAX_SELINV_CLUSTER
    assert plan.cluster <= max(plan.diag_subtiles, min(max_cluster, plan.units))
    assert plan.diag_split == plan.cluster // plan.diag_subtiles
    for j in range(ndt):
        dmax = min(bt, ndt - 1 - j)
        seen = []
        for rank in range(plan.cluster):
            for u in plan.target_units(rank):
                target, sub = divmod(u, ns * ns)
                pairs = list(plan.target_pairs(dmax, target))
                assert pairs == sorted(pairs)
                seen += [(target, sub, p) for p in pairs]
        want = [(k, s, p) for k in range(bt + nat) for s in range(ns * ns)
                for p in (range(dmax + nat) if k < bt and k + 1 <= dmax
                          else range(dmax) if k >= bt else range(0))]
        assert sorted(seen) == sorted(want) and len(seen) == len(set(seen))
        runs = {}
        for rank in range(plan.cluster):
            s, run = plan.diag_share(rank, dmax)
            if s is not None:
                runs.setdefault(s, []).append((rank, list(run)))
        assert sorted(runs) == list(range(plan.diag_subtiles))
        for s, shares in runs.items():
            assert shares[0][0] == s * plan.diag_split       # the owner comes first
            assert [r for r, _ in shares] == list(range(shares[0][0], shares[0][0] + len(shares)))
            assert sum((run for _, run in shares), []) == list(range(dmax + nat))


def _planned_sweep(lcol, R, sc, start, plan):
    """The recurrence as ``csrc/selinv.cu`` runs it on ``plan``, in plain
    PyTorch: the pre-pass (``ref.selinv_prepass_ref``), then per column each
    rank's target sub-tiles over their pairs in order, then the lower
    diagonal sub-tiles from the ranks' runs added in rank order, the
    diagonal ones symmetrized and the others mirrored."""
    ndt, b1, t, _ = lcol.shape
    bt, nat, S, ns = b1 - 1, R.shape[1], plan.sub, plan.ns
    work = ref.selinv_prepass_ref(lcol, R, sc, start)
    panels = torch.full_like(lcol, float("nan"))
    acols = torch.full_like(R, float("nan"))
    op = lambda x, ta: x.mT if ta else x
    for j in range(ndt - 1, -1, -1):
        dmax = min(bt, ndt - 1 - j)
        for rank in range(plan.cluster):
            for u in plan.target_units(rank):
                k, sub = divmod(u, ns * ns)
                r0, c0 = sub // ns * S, sub % ns * S
                acc = torch.zeros((S, S))
                for p in plan.target_pairs(dmax, k):
                    if k < bt:
                        e = k + 1
                        if p < dmax:
                            d = p + 1
                            a = (panels[j + d, e - d], False) if e >= d else \
                                (panels[j + e, d - e], True)
                            b = work[j, p]
                        else:
                            a, b = (acols[j + e, p - dmax], True), work[j, bt + p - dmax]
                    else:
                        a, b = (acols[j + p + 1, k - bt], False), work[j, p]
                    acc = acc + op(*a)[r0:r0 + S] @ b[:, c0:c0 + S]
                if k < bt:
                    panels[j, k + 1, r0:r0 + S, c0:c0 + S] = -acc
                else:
                    init = work[j, bt + nat + k - bt, r0:r0 + S, c0:c0 + S]
                    acols[j, k - bt, r0:r0 + S, c0:c0 + S] = -(init + acc)
        sums = {}
        for rank in range(plan.cluster):
            s, run = plan.diag_share(rank, dmax)
            if s is None:
                continue
            r0, c0 = (x * S for x in _lower_subtile(s))
            acc = torch.zeros((S, S))
            for q in run:
                a, b = ((panels[j, q + 1], work[j, q]) if q < dmax
                        else (acols[j, q - dmax], work[j, bt + q - dmax]))
                acc = acc + a.mT[r0:r0 + S] @ b[:, c0:c0 + S]
            sums[s] = acc if s not in sums else sums[s] + acc
        for s, acc in sums.items():
            r0, c0 = (x * S for x in _lower_subtile(s))
            v = work[j, bt + 2 * nat, r0:r0 + S, c0:c0 + S] - acc
            if r0 == c0:
                panels[j, 0, r0:r0 + S, c0:c0 + S] = 0.5 * (v + v.mT)
            else:
                panels[j, 0, r0:r0 + S, c0:c0 + S] = v
                panels[j, 0, c0:c0 + S, r0:r0 + S] = v.mT
    return panels, acols


@pytest.mark.parametrize("t,bt,nat,ndt", PLAN_CASES)
@pytest.mark.parametrize("start", [0, 2])
def test_selinv_planned_recurrence_matches_sweep_ref(t, bt, nat, ndt, start):
    """The pre-pass and the recurrence's plan (clusters of 4 and 16)
    reproduce ``ref.selinv_sweep_ref`` on a real factor, the identity
    prefix included: the decomposition the CUDA sweep computes, checked
    where there is no card."""
    lcol, R, sc = _chip_smoke().selinv_inputs(torch, ndt, bt, nat, t, 1000 + 10 * bt + nat,
                                              "cpu")
    want = ref.selinv_sweep_ref(lcol, R, sc, start)
    for max_cluster in (4, 16):
        got = _planned_sweep(lcol, R, sc, start, selinv_plan(t, bt, nat, max_cluster))
        for g, w, part in zip(got, want, ("panels", "acols")):
            torch.testing.assert_close(g, w, msg=f"{part}, clusters of {max_cluster}", **TOL)


def test_selinv_prepass_ref():
    """The pre-pass's tiles: W L_jj = I, G and Ga the factor column times
    W, W^T W, the corner parts, and the identity prefix."""
    lcol, R, sc = _chip_smoke().selinv_inputs(torch, 5, 2, 2, 16, 3, "cpu")
    work = ref.selinv_prepass_ref(lcol, R, sc, start_tile=1)
    eye = torch.eye(16)
    assert work.shape == (5, 2 + 2 * 2 + 2, 16, 16)
    torch.testing.assert_close(work[0, -2:], eye.expand(2, 16, 16), rtol=0, atol=0)
    assert not work[0, :-2].any()
    for j in range(1, 5):
        w = work[j, -1]
        torch.testing.assert_close(w @ lcol[j, 0], eye, **TOL)
        torch.testing.assert_close(work[j, :2], lcol[j, 1:] @ w, **TOL)
        torch.testing.assert_close(work[j, 2:4], R[j] @ w, **TOL)
        torch.testing.assert_close(work[j, 4:6], torch.einsum("iqab,qbc->iac", sc, work[j, 2:4]),
                                   **TOL)
        torch.testing.assert_close(work[j, -2], w.mT @ w, **TOL)


def test_selinv_plan_refusals():
    """A cluster the card does not allow is refused when the plan is made."""
    for bad in (0, MAX_SELINV_CLUSTER + 1):
        with pytest.raises(ValueError, match="max_cluster"):
            selinv_plan(64, 4, 4, bad)
    assert selinv_plan(64, 0, 0, 16).cluster == 3      # the diagonal's lower sub-tiles
    assert selinv_plan(16, 0, 0, 16).cluster == 1
    assert selinv_plan(64, 4, 4).cluster == SELINV_CLUSTER
