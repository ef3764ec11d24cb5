"""The CUDA band-Cholesky sweep's plan, on the CPU.

``kernels/band_cholesky.py::sweep_plan`` says which rank of the sweep's
thread-block cluster computes which target sub-tile and Schur product of a
column, and which rows it substitutes.  Here it is checked to cover every
product of a column exactly once, in order, and a plain PyTorch emulation
of the planned sweep (each rank's units, the Schur products one column
late, the substitution rank by rank, the status folded from the ranks'
flags) is held to the references on the same numpy inputs at rtol = atol =
2e-4: ``repro``'s Pallas sweep in interpret mode and both packages' plain
sweeps, and for the partitioned sweep ``repro``'s plain version (its Pallas
partitioned sweep does not run on the installed jax).  The emulation is
for these tests only; the kernel's plain version stays
``ref.band_cholesky_sweep_ref``."""
import importlib.util
import inspect
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.band_cholesky import band_cholesky_sweep_pallas
from repro_torch.kernels import ref
from repro_torch.kernels.band_cholesky import (MAX_PLAN_TILES, MAX_SWEEP_CLUSTER,
                                               SWEEP_CLUSTER, SweepUnit, sweep_plan)
from repro_torch.kernels.ring import chunk_layout

TOL = dict(rtol=2e-4, atol=2e-4)
CLUSTERS = [1, 2, 4, 8, 16]


def _chip_smoke():
    """chip_smoke.py as a module (its input makers need no card)."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _inputs(ndt, bt, nat, t, seed, bounds=None, bad_tile=None):
    return _chip_smoke().random_band_arrow(torch, ndt, bt, nat, t, seed, "cpu",
                                           bad_tile=bad_tile, bounds=bounds)


def _decode(plan):
    """The plan's table read back as the kernel reads it: per rank its
    target units, its Schur units and its rows."""
    tab, cl, ns = plan.table(), plan.cluster, plan.ns
    kinds = {0: "band", 1: "arrow", 2: "schur"}
    unit = lambda c: SweepUnit(kinds[c & 0xff], (c >> 8) & 0xff, (c >> 16) & 0xff,
                               (c >> 24) // ns, (c >> 24) % ns)
    lists = lambda off: tuple(tuple(unit(c) for c in tab[tab[off + r]:tab[off + r + 1]])
                              for r in range(cl))
    rows = tuple((tab[2 * cl + 2 + r], tab[2 * cl + 3 + r]) for r in range(cl))
    return lists(0), lists(cl + 1), rows


@pytest.mark.parametrize("t", [8, 16, 32, 64])
@pytest.mark.parametrize("bt", [0, 1, 2, 4])
@pytest.mark.parametrize("nat", [0, 1, 4])
@pytest.mark.parametrize("max_cluster", CLUSTERS)
def test_sweep_plan_covers_every_product_once(t, bt, nat, max_cluster):
    """Every (target sub-tile, pair) of a column and every Schur sub-tile is
    computed exactly once, each unit whole on one rank with its pairs in
    order; the diagonal update and the diagonal Schur tiles by their lower
    sub-tiles, the diagonal update's first on each rank; the substitution's
    rows cut into contiguous runs in rank order; and the table holds
    exactly this plan."""
    plan = sweep_plan(t, bt, nat, max_cluster)
    sub, ns = min(t, 32), t // min(t, 32)
    assert plan.sub == sub and plan.ns == ns
    every = [(r, c) for r in range(ns) for c in range(ns)]
    lower = [(r, c) for r, c in every if c <= r]
    n_targets = len(lower) + (bt + nat) * ns * ns
    assert plan.cluster == min(max_cluster, n_targets) <= MAX_SWEEP_CLUSTER
    assert len(plan.targets) == len(plan.schur) == len(plan.rows) == plan.cluster
    for kl in range(bt + 2):
        seen = []
        for units in plan.targets:
            for u in units:
                pairs = list(plan.pairs(u, kl))
                assert pairs == list(range(len(pairs)))
                seen += [(u.kind, u.a, u.row, u.col, q) for q in pairs]
        want = ([("band", 0, r, c, q) for r, c in lower for q in range(min(bt, kl))]
                + [("band", e, r, c, q) for e in range(1, bt + 1) for r, c in every
                   for q in range(min(bt - e, kl))]
                + [("arrow", i, r, c, q) for i in range(nat) for r, c in every
                   for q in range(min(bt, kl))])
        assert sorted(seen) == sorted(want) and len(seen) == len(set(seen))
    units = [(u.kind, u.a, u.row, u.col) for us in plan.targets for u in us]
    assert len(units) == len(set(units)) == n_targets
    schur = [(u.a, u.b, u.row, u.col) for us in plan.schur for u in us]
    want = [(i, j, r, c) for i in range(nat) for j in range(i + 1)
            for r, c in (every if j < i else lower)]
    assert sorted(schur) == sorted(want) and len(schur) == len(set(schur))
    for units in plan.targets:
        kinds = [u.kind == "band" and u.a == 0 for u in units]
        assert kinds == sorted(kinds, reverse=True)
    nrows = (bt + nat) * t
    assert plan.rows[0][0] == 0 and plan.rows[-1][1] == nrows
    assert all(a[1] == b[0] for a, b in zip(plan.rows, plan.rows[1:]))
    assert max(hi - lo for lo, hi in plan.rows) == -(-nrows // plan.cluster)
    assert _decode(plan) == (plan.targets, plan.schur, plan.rows)


def test_sweep_plan_depends_on_tile_shape_and_cluster_only():
    """The plan is a function of (t, bt, nat, max_cluster) alone, so a
    batch element or a partition runs exactly an unbatched sweep's plan;
    the plan of the default cluster is the 16-block one."""
    assert list(inspect.signature(sweep_plan).parameters) == ["t", "bt", "nat", "max_cluster"]
    assert sweep_plan(64, 4, 4) == sweep_plan(64, 4, 4, SWEEP_CLUSTER)
    assert sweep_plan(64, 4, 4).cluster == SWEEP_CLUSTER == 16
    # at Table II #5's shape rank 0, which factors L_kk, has the fewest units
    plan = sweep_plan(64, 4, 4)
    units = [len(a) + len(b) for a, b in zip(plan.targets, plan.schur)]
    assert units[0] < min(units[1:])
    assert sweep_plan(64, 1, 4, 16).cluster == 16       # Table II #4's shape
    assert sweep_plan(64, 0, 0, 16).cluster == 3        # the diagonal's lower sub-tiles
    assert sweep_plan(16, 0, 0, 16).cluster == 1


def test_sweep_plan_refusals():
    """A cluster the card does not allow, a tile size without a kernel and
    a band or arrow wider than the table's byte are refused when the plan
    is made."""
    for bad in (0, MAX_SWEEP_CLUSTER + 1):
        with pytest.raises(ValueError, match="max_cluster"):
            sweep_plan(64, 4, 4, bad)
    for t, bt, nat in ((48, 4, 4), (64, -1, 4), (64, 4, -1), (64, MAX_PLAN_TILES + 1, 0),
                       (16, 0, MAX_PLAN_TILES + 1)):
        with pytest.raises(ValueError, match="sweep_plan"):
            sweep_plan(t, bt, nat)


def planned_sweep(Ac, R, plan, nchunks=1, start_tile=0, boundaries=None):
    """The sweep as ``csrc/band_cholesky.cu`` runs it on ``plan``, in plain
    PyTorch: per partition (one cluster) and column, each rank's sub-tiles
    of the diagonal update (its pairs q >= 1, then q = 0, the pair with the
    column just solved), ``L_kk`` from their lower triangle with the
    pivots folded into the status, each rank's other target sub-tiles
    (input minus the sum of its pairs in order) and the column before's
    Schur sub-tiles (stored when that column opens its chunk, added
    otherwise, mirrored), each rank's rows solved against ``L_kk``; the last
    column's Schur sub-tiles after the loop, and the ranks' first
    non-finite columns folded into the status word."""
    ndt, b1, t, _ = Ac.shape
    bt, nat, S = b1 - 1, R.shape[1], plan.sub
    partitioned = boundaries is not None
    bounds = tuple(boundaries) if partitioned else (0, ndt)
    csz, nch = chunk_layout(ndt, nchunks)
    if partitioned:
        csz, nch = ndt, len(bounds) - 1
    nan = float("nan")
    panels, R_out = torch.full_like(Ac, nan), torch.full_like(R, nan)
    schur = torch.full((nch, nat, nat, t, t), nan)
    sl = lambda u: (slice(u.row * S, (u.row + 1) * S), slice(u.col * S, (u.col + 1) * S))
    words = []
    for p, (s0, s1) in enumerate(zip(bounds, bounds[1:])):
        min_piv, nonfinite, first_bad = float("inf"), 0.0, -1.0
        first_nf = [-1] * plan.cluster

        def schur_units(kk, zero):
            c, first = p + (kk - s0) // csz, (kk - s0) % csz == 0
            for units in plan.schur:
                for u in units:
                    r, cc = sl(u)
                    acc = (torch.zeros((S, S)) if zero
                           else R_out[kk, u.a][r] @ R_out[kk, u.b][cc].mT)
                    old = 0.0 if first else schur[c, u.a, u.b][r, cc]
                    schur[c, u.a, u.b][r, cc] = old + acc
                    if u.a != u.b or u.row != u.col:
                        old = 0.0 if first else schur[c, u.b, u.a][cc, r]
                        schur[c, u.b, u.a][cc, r] = old + acc.mT

        for k in range(s0, s1):
            kl = k - s0
            if k < start_tile:
                panels[k] = 0.0
                panels[k, 0] = torch.eye(t)
                R_out[k] = 0.0
                if kl % csz == 0:
                    schur_units(k, True)
                min_piv = min(min_piv, 1.0)
                continue
            def targets(diagonal):
                for units in plan.targets:
                    for u in units:
                        if (u.kind == "band" and u.a == 0) != diagonal:
                            continue
                        r, c = sl(u)
                        acc = torch.zeros((S, S))
                        pairs = list(plan.pairs(u, kl))
                        for q in (pairs[1:] + pairs[:1]) if diagonal else pairs:
                            a = R_out[k - 1 - q, u.a] if u.kind == "arrow" else \
                                panels[k - 1 - q, u.a + q + 1]
                            acc = acc + a[r] @ panels[k - 1 - q, q + 1][c].mT
                        src, dst = ((R[k, u.a], R_out[k, u.a]) if u.kind == "arrow"
                                    else (Ac[k, u.a], panels[k, u.a]))
                        dst[r, c] = src[r, c] - acc

            targets(True)
            a = panels[k, 0]
            lkk = ref.potrf_ref(torch.tril(a) + torch.tril(a, -1).mT)
            panels[k, 0] = lkk
            col_bad = not bool(torch.isfinite(lkk).all())
            d = torch.diagonal(lkk)
            piv = float((d * d).min()) if bool(torch.isfinite(d).all()) else float("inf")
            min_piv = min(min_piv, piv)
            if col_bad:
                nonfinite = 1.0
            if first_bad < 0 and (col_bad or piv <= 0):
                first_bad = float(k)
            targets(False)
            if kl > 0 and k - 1 >= start_tile:
                schur_units(k - 1, False)
            rows = torch.cat([panels[k, 1:].reshape(-1, t), R_out[k].reshape(-1, t)])
            for rank, (lo, hi) in enumerate(plan.rows):
                x = torch.linalg.solve_triangular(lkk, rows[lo:hi].mT, upper=False).mT
                rows[lo:hi] = x
                if not bool(torch.isfinite(x).all()) and first_nf[rank] < 0:
                    first_nf[rank] = k
            panels[k, 1:] = rows[:bt * t].reshape(bt, t, t)
            R_out[k] = rows[bt * t:].reshape(nat, t, t)
        if s1 - 1 >= start_tile:
            schur_units(s1 - 1, False)
        for f in first_nf:
            if f >= 0:
                nonfinite = 1.0
                first_bad = float(f) if first_bad < 0 or f < first_bad else first_bad
        words.append([min_piv, nonfinite, first_bad])
    words = torch.tensor(words, dtype=torch.float32)
    status = ref.combine_sweep_status(words) if partitioned else words[0]
    return panels, R_out, schur, status


def _assert_status(got, want):
    g, w = got.tolist(), np.asarray(want).tolist()
    assert g[1:] == w[1:]
    assert g[0] == pytest.approx(w[0], rel=2e-4)


# (t, ndt, bt, nat) of the fused checks: every tile size, bt and nat 0 and
# above, fewer columns than band tiles
FUSED = [(8, 6, 2, 2), (16, 7, 3, 1), (32, 5, 1, 0), (8, 6, 0, 3), (16, 3, 4, 2), (64, 4, 2, 1)]


@pytest.mark.parametrize("t,ndt,bt,nat", FUSED)
@pytest.mark.parametrize("start_tile", [0, 2])
def test_planned_sweep_matches_references(t, ndt, bt, nat, start_tile):
    """The emulated planned sweep at clusters of 1, 4 and 16 against
    ``repro``'s Pallas sweep in interpret mode and both packages' plain
    sweeps, the identity prefix included; the cluster size changes no
    bit."""
    Ac, R = _inputs(ndt, bt, nat, t, seed=10 * t + ndt + bt + nat)
    nch = 3
    want = ref.band_cholesky_sweep_ref(Ac, R, nchunks=nch, start_tile=start_tile)
    jAc, jR = jnp.asarray(Ac.numpy()), jnp.asarray(R.numpy())
    pallas = band_cholesky_sweep_pallas(jAc, jR, nchunks=nch, start_tile=start_tile,
                                        interpret=True)
    jwant = jref.band_cholesky_sweep_ref(jAc, jR, nchunks=nch, start_tile=start_tile)
    first = None
    for max_cluster in (1, 4, 16):
        got = planned_sweep(Ac, R, sweep_plan(t, bt, nat, max_cluster), nchunks=nch,
                            start_tile=start_tile)
        for g, w, p, j, part in zip(got[:3], want[:3], pallas[:3], jwant[:3],
                                    ("panels", "R_out", "schur")):
            torch.testing.assert_close(g, w, msg=part, **TOL)
            np.testing.assert_allclose(g.numpy(), np.asarray(p), err_msg=part, **TOL)
            np.testing.assert_allclose(g.numpy(), np.asarray(j), err_msg=part, **TOL)
        for w in (want[3], pallas[3], jwant[3]):
            _assert_status(got[3], w)
        if first is None:
            first = got
        else:
            assert all(torch.equal(g, f) for g, f in zip(got, first))


# (t, ndt, bt, nat, boundaries): one partition, bt = 0, nat = 0, a ragged
# last partition, seven partitions
PARTITIONED = [(8, 6, 2, 1, (0, 6)), (16, 8, 0, 2, (0, 4, 8)), (8, 9, 2, 0, (0, 3, 5, 7, 9)),
               (16, 10, 1, 3, (0, 3, 6, 9, 10)), (8, 15, 3, 2, (0, 2, 4, 6, 8, 10, 12, 15))]


@pytest.mark.parametrize("t,ndt,bt,nat,bounds", PARTITIONED)
@pytest.mark.parametrize("start_tile", [0, 3])
def test_planned_partitioned_sweep_matches_references(t, ndt, bt, nat, bounds, start_tile):
    """The emulated partitioned sweep against ``repro``'s and the port's
    plain partitioned sweeps, and bit for bit against the emulated fused
    sweep in panels, arrow rows and status at every cluster size: the
    fused sweep's extra pairs across a cut add exact zeros."""
    Ac, R = _inputs(ndt, bt, nat, t, seed=7 * ndt + t, bounds=bounds)
    want = ref.band_cholesky_partitioned_sweep_ref(Ac, R, bounds, start_tile=start_tile)
    jwant = jref.band_cholesky_partitioned_sweep_ref(jnp.asarray(Ac.numpy()),
                                                     jnp.asarray(R.numpy()), bounds,
                                                     start_tile=start_tile)
    for max_cluster in CLUSTERS:
        plan = sweep_plan(t, bt, nat, max_cluster)
        got = planned_sweep(Ac, R, plan, start_tile=start_tile, boundaries=bounds)
        for g, w, j, part in zip(got[:3], want[:3], jwant[:3], ("panels", "R_out", "schur")):
            torch.testing.assert_close(g, w, msg=part, **TOL)
            np.testing.assert_allclose(g.numpy(), np.asarray(j), err_msg=part, **TOL)
        _assert_status(got[3], want[3])
        _assert_status(got[3], jwant[3])
        fused = planned_sweep(Ac, R, plan, nchunks=1, start_tile=start_tile)
        assert torch.equal(got[0], fused[0]) and torch.equal(got[1], fused[1])
        assert got[3].tolist() == fused[3].tolist()
        torch.testing.assert_close(got[2].sum(0), fused[2][0], **TOL)


@pytest.mark.parametrize("t", [8, 16])
@pytest.mark.parametrize("max_cluster", [1, 4, 16])
def test_planned_sweep_breakdown_status(t, max_cluster):
    """An indefinite diagonal tile: the emulated kernel's status fold (rank
    0's pivots, the ranks' first non-finite columns) gives the plain
    version's and ``repro``'s status word, and the columns before the bad
    one as theirs."""
    Ac, R = _inputs(5, 1, 1, t, seed=7, bad_tile=2)
    got = planned_sweep(Ac, R, sweep_plan(t, 1, 1, max_cluster), nchunks=3)
    want = ref.band_cholesky_sweep_ref(Ac, R, nchunks=3)
    jwant = jref.band_cholesky_sweep_ref(jnp.asarray(Ac.numpy()), jnp.asarray(R.numpy()),
                                         nchunks=3)
    assert want[3][1:].tolist() == [1.0, 2.0]
    _assert_status(got[3], want[3])
    _assert_status(got[3], jwant[3])
    torch.testing.assert_close(got[0][:2], want[0][:2], **TOL)
