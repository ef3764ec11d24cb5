"""The CUDA band-solve sweeps' plan, on the CPU.

``kernels/band_solve.py::solve_plan`` says how wide a chunk of
right-hand-side columns each thread-block cluster takes, how many blocks a
cluster has and which rank computes which product (unit), and rank 0 adds
a row's terms in a fixed order.  Which row a unit reads and writes in each
phase is worked out by the kernel, ``csrc/band_solve.cu``'s ``job``,
``has_chain`` and ``has_partial``; :func:`schedule` below is a model of
that rule, and the card tests (``test_torch_gpu.py``) are the check on the
kernel itself.  Here the plan and the model are checked to cover every
product of every row exactly once, on one rank, with the chain's product
on rank 0; no product reads a row before the phase after the one that
publishes it, and no partial sum is read before its last term is in.  A
plain PyTorch emulation of the planned sweeps (the phases in order, each
job's product added to its partial sum as the model says, rank 0's rows as
``(B - partial) - chain``) is held to the references on the same numpy
inputs at rtol = atol = 2e-4: ``repro``'s Pallas sweeps in interpret mode
and both packages' plain sweeps.  The emulation is for these tests only;
the kernels' plain versions stay ``ref.band_forward_sweep_ref`` and
``ref.band_backward_sweep_ref``."""
import dataclasses
import functools
import importlib.util
import inspect
from dataclasses import dataclass
from pathlib import Path
from typing import Optional, Tuple

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.band_solve import band_backward_sweep_pallas, band_forward_sweep_pallas
from repro_torch.kernels import ref
from repro_torch.kernels.band_solve import (MAX_SOLVE_CLUSTER, SOLVE_CLUSTER, SolveUnit,
                                            solve_plan)

TOL = dict(rtol=2e-4, atol=2e-4)
CLUSTERS = [1, 2, 4, 8, 16]
KS = [1, 7, 33]
# clusters the card holds at once: widths 1, 2 and 8 (5 chunks, more than
# fit) at k = 1, 7 and 33
AT_ONCE = 4


@dataclass(frozen=True)
class SolveJob:
    """One unit's work in one phase: ``rank`` computes ``unit`` with the
    panel of row ``source`` (None: the backward arrow term's own ``Xa_i``)
    into ``target`` (a row's partial sum, or the forward arrow tile
    ``acc_a[target]``); ``first`` means it writes the target, else adds to
    it."""
    rank: int
    unit: SolveUnit
    source: Optional[int]
    target: int
    first: bool


@dataclass(frozen=True)
class SolvePhase:
    """One phase of a sweep, a cluster barrier after it.  ``row`` is the
    row rank 0 solves (None: a phase of units only), as ``(B_row - partial)
    - chain``, where ``partial`` (if ``partial``) is the sum the jobs of
    earlier phases left for the row in rank 0's shared memory and ``chain``
    (if ``chain``) its product with the row solved in the phase before."""
    row: Optional[int]
    chain: bool
    partial: bool
    jobs: Tuple[SolveJob, ...]


def rank_of(plan, unit):
    return next(r for r, units in enumerate(plan.units) if unit in units)


def schedule(plan, ndt, start, backward):
    """The phases of a sweep over ``ndt`` band rows from ``start_tile =
    start``, in the kernel's order, each unit's job in it where it has one.
    Forward: the phase of row p also holds the products with row p - 1,
    and one phase after the last row holds its arrow products.  Backward:
    rows in reverse, the phase of row p holds the products with row p + 1,
    and ``lead`` phases before the last row hold the arrow terms of the
    rows below it."""
    bt, nat = plan.bt, plan.nat
    if start >= ndt:
        return ()
    lead = plan.lead(backward)
    rows = range(ndt - 1 + lead, start - 1, -1) if backward else range(start, ndt + 1)
    phases = []
    for p in rows:
        row = p if start <= p < ndt else None
        if backward:
            chain = row is not None and bt >= 1 and row + 1 < ndt
            partial = row is not None and (nat > 0 or min(bt, ndt - 1 - row) >= 2)
        else:
            chain = row is not None and bt >= 1 and row - 1 >= start
            partial = row is not None and min(bt, row - start) >= 2
        jobs = tuple(job for rank, units in enumerate(plan.units) for u in units
                     for job in [_job(plan, rank, u, p, ndt, start, backward)]
                     if job is not None)
        phases.append(SolvePhase(row, chain, partial, jobs))
    return tuple(phases)


def _job(plan, rank, u, p, ndt, start, backward):
    """csrc/band_solve.cu's ``job``: unit ``u``'s work in the phase of row
    ``p``, or None."""
    bt, nat, idx = plan.bt, plan.nat, u.index
    if not backward:
        s = p - 1
        if not start <= s < ndt:
            return None
        if u.kind == "arrow":
            return SolveJob(rank, u, s, idx, s == start)
        if s + idx >= ndt:
            return None
        return SolveJob(rank, u, s, s + idx, idx == bt or s == start)
    if u.kind == "arrow":
        m = p - (max(bt, 1) + nat - 1 - idx)
        if not start <= m < ndt:
            return None
        return SolveJob(rank, u, None, m, idx == 0)
    s = p + 1
    if s >= ndt or s - idx < start:
        return None
    return SolveJob(rank, u, s, s - idx, nat == 0 and (idx == bt or s == ndt - 1))


def _chip_smoke():
    """chip_smoke.py as a module (its input makers need no card)."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


_CHIP_SMOKE = _chip_smoke()
# (ndt, bt, nat): chip_smoke.py's sweep checks, then bt = 0 with an arrow
# and nat = 0 with a wide band
GRIDS = list(_CHIP_SMOKE.SOLVE_SWEEPS) + [(5, 0, 2), (7, 3, 0)]


def _decode(plan):
    """The plan's table read back as the kernel reads it: each rank's units."""
    tab, cl = plan.table(), plan.cluster
    kinds = {0: "band", 1: "arrow"}
    return tuple(tuple(SolveUnit(kinds[c & 0xff], c >> 8) for c in tab[tab[r]:tab[r + 1]])
                 for r in range(cl))


def _needed(ndt, bt, nat, start, backward):
    """Every off-chain product of the sweep, as (kind, index, source,
    target): what the plan must cover exactly once."""
    out = []
    for m in range(start, ndt):
        if backward:
            out += [("arrow", i, None, m) for i in range(nat)]
            out += [("band", j, m + j, m) for j in range(2, min(bt, ndt - 1 - m) + 1)]
        else:
            out += [("arrow", i, m, i) for i in range(nat)]
            out += [("band", j, m - j, m) for j in range(2, min(bt, m - start) + 1)]
    return out


@pytest.mark.parametrize("t", [8, 64])
@pytest.mark.parametrize("ndt,bt,nat", GRIDS + [(12, 6, 5)])
@pytest.mark.parametrize("start", [0, 2])
@pytest.mark.parametrize("max_cluster", CLUSTERS)
def test_solve_plan_covers_every_product_once(t, ndt, bt, nat, start, max_cluster):
    """Both sweeps' schedules compute every product a row needs exactly
    once, each on the one rank the plan gives its unit (never rank 0 unless
    the cluster is one block), the chain's product on rank 0 for every row
    after the first; a partial sum's first term writes it and comes first
    in phase order, the backward arrow terms in ascending i before the band
    products in descending j; the table holds exactly this plan."""
    start = min(start, ndt - 1)
    plan = solve_plan(t, bt, nat, 5, max_cluster, at_once=AT_ONCE)
    n_units = max(bt - 1, 0) + nat
    assert plan.cluster == min(max_cluster, 1 + n_units) <= MAX_SOLVE_CLUSTER
    assert sorted((u.kind, u.index) for us in plan.units for u in us) == sorted(
        [("band", j) for j in range(2, bt + 1)] + [("arrow", i) for i in range(nat)])
    if plan.cluster > 1:
        assert plan.units[0] == ()
        assert max(len(us) for us in plan.units) == -(-n_units // (plan.cluster - 1))
    assert _decode(plan) == plan.units
    for backward in (False, True):
        phases = schedule(plan, ndt, start, backward)
        rows = [ph.row for ph in phases if ph.row is not None]
        assert rows == (list(range(ndt - 1, start - 1, -1)) if backward
                        else list(range(start, ndt)))
        seen, order = [], {}
        for ph in phases:
            if ph.row is not None:
                m = ph.row
                assert ph.chain == (bt >= 1 and (m + 1 < ndt if backward else m > start))
            for job in ph.jobs:
                assert job.rank == rank_of(plan, job.unit)
                assert job.rank != 0 or plan.cluster == 1
                seen.append((job.unit.kind, job.unit.index, job.source, job.target))
                kind = "arrow" if not backward and job.unit.kind == "arrow" else "row"
                terms = order.setdefault((kind, job.target), [])
                assert job.first == (not terms)
                terms.append((job.unit.kind, job.unit.index))
        assert sorted(seen, key=str) == sorted(_needed(ndt, bt, nat, start, backward), key=str)
        assert len(seen) == len(set(seen))
        for (kind, target), terms in order.items():
            if kind == "row" and backward:
                want = ([("arrow", i) for i in range(nat)]
                        + [("band", j) for j in range(min(bt, ndt - 1 - target), 1, -1)])
                assert terms == want
            elif kind == "row":
                assert terms == [("band", j) for j in range(min(bt, target - start), 1, -1)]
        partials = {ph.row for ph in phases if ph.partial}
        assert partials == {target for kind, target in order if kind == "row"}


@pytest.mark.parametrize("ndt,bt,nat", GRIDS + [(12, 6, 5), (3, 8, 2)])
@pytest.mark.parametrize("start", [0, 1, 3])
@pytest.mark.parametrize("backward", [False, True])
def test_solve_schedule_respects_the_barriers(ndt, bt, nat, start, backward):
    """No job reads a row before the phase after the one in which rank 0
    solves it; no partial sum gets a term in or after the phase that reads
    it; the partial sums open at once fit rank 0's ring of ``lead + 1``
    slots (no two share a slot); the chain's row is the one solved just
    before."""
    plan = solve_plan(16, bt, nat, 3, at_once=AT_ONCE)
    if start >= ndt:
        assert schedule(plan, ndt, start, backward) == ()
        return
    phases = schedule(plan, ndt, start, backward)
    lead = plan.lead(backward)
    solved = {ph.row: n for n, ph in enumerate(phases) if ph.row is not None}
    written = {}
    for n, ph in enumerate(phases):
        if ph.row is not None and ph.chain:
            assert solved[ph.row + (1 if backward else -1)] == n - 1
        for job in ph.jobs:
            if job.source is not None:
                assert solved[job.source] < n
            if backward or job.unit.kind == "band":
                written.setdefault(job.target, []).append(n)
    for target, ns in written.items():
        assert max(ns) < solved[target]
        assert solved[target] - min(ns) <= lead
    for n in range(len(phases)):
        live = [m for m, ns in written.items() if min(ns) <= n <= solved[m]]
        assert len({m % (lead + 1) for m in live}) == len(live)


def test_solve_plan_depends_on_its_arguments_only():
    """The plan is a function of (t, bt, nat, k, max_cluster, at_once,
    batch) alone; the default cap is 16; Table II #5's shape takes 8
    blocks (7 units), #2's 5.  The chunk width is the narrowest whose
    chunks number at most ``at_once`` (8 if none), never a function of the
    cap."""
    assert list(inspect.signature(solve_plan).parameters) == ["t", "bt", "nat", "k",
                                                              "max_cluster", "at_once",
                                                              "batch"]
    assert solve_plan(64, 4, 4, 32, at_once=14) == solve_plan(64, 4, 4, 32, SOLVE_CLUSTER,
                                                                at_once=14)
    assert SOLVE_CLUSTER == 16
    assert solve_plan(64, 4, 4, 32, at_once=14).cluster == 8
    assert solve_plan(64, 4, 1, 32, at_once=14).cluster == 5
    for bt, nat, at_once, table in (
            (4, 4, 14, ((1, 1, 1), (7, 1, 7), (14, 1, 14), (15, 2, 8), (32, 4, 8), (33, 4, 9),
                        (64, 8, 8), (200, 8, 25))),
            (4, 1, 22, ((1, 1, 1), (22, 1, 22), (32, 2, 16), (33, 2, 17), (64, 4, 16))),
            (0, 0, 132, ((32, 1, 32), (132, 1, 132), (133, 2, 67))),
            (4, 4, 1, ((1, 1, 1), (2, 2, 1), (9, 8, 2)))):
        for k, width, chunks in table:
            for cap in CLUSTERS:
                plan = solve_plan(64, bt, nat, k, cap, at_once=at_once)
                assert (plan.width, plan.chunks) == (width, chunks)
                assert plan.chunks <= at_once or width == 8


@pytest.mark.parametrize("batch", [1, 8])
def test_solve_plan_width_counts_the_batch(batch):
    """With a batch, the width is the narrowest whose ``batch x chunks``
    clusters all run at once, else 8: at Table II #5's shape (the card
    holds 14 clusters of 8) a batch of 8 at k = 32 takes chunks of 8 (32
    clusters, more than fit) and at k = 1 one column (8 clusters).  The
    batch changes the width alone, and a batch of 1 is the unbatched plan
    at every k, cap and at_once."""
    for k, width in ((1, 1), (2, 1 if batch == 1 else 2), (32, 4 if batch == 1 else 8),
                     (33, 4 if batch == 1 else 8), (200, 8)):
        plan = solve_plan(64, 4, 4, k, at_once=14, batch=batch)
        assert plan.width == width and plan.chunks == -(-k // width)
        assert batch * plan.chunks <= 14 or width == 8
        assert plan == dataclasses.replace(solve_plan(64, 4, 4, k, at_once=14),
                                           width=width, chunks=-(-k // width))
    for k in KS + [32, 64]:
        for cap in CLUSTERS:
            for at_once in (1, 4, 14, 132):
                assert solve_plan(64, 4, 1, k, cap, at_once=at_once, batch=1) == solve_plan(
                    64, 4, 1, k, cap, at_once=at_once)
    with pytest.raises(ValueError, match="batch"):
        solve_plan(64, 4, 4, 32, at_once=14, batch=0)


def test_solve_plan_refusals():
    """A cluster cap outside 1..16, a tile size without a kernel, a
    negative band or arrow, no right-hand side, no cluster the card holds,
    and a band whose partial sums do not fit the block's shared memory are
    refused when the plan is made."""
    for bad in (0, MAX_SOLVE_CLUSTER + 1, -1):
        with pytest.raises(ValueError, match="max_cluster"):
            solve_plan(64, 4, 4, 32, bad, at_once=AT_ONCE)
    for t, bt, nat, k, at_once in ((48, 4, 4, 1, 4), (64, -1, 4, 1, 4), (64, 4, -1, 1, 4),
                                   (64, 4, 4, 0, 4), (64, 4, 4, 1, 0), (64, 200, 0, 64, 4)):
        with pytest.raises(ValueError, match="solve_plan"):
            solve_plan(t, bt, nat, k, at_once=at_once)


def planned_sweep(plan, Dr, R, rhs, xa=None, start=0, backward=False):
    """The sweep as ``csrc/band_solve.cu`` runs it on ``plan``, in plain
    PyTorch: per chunk of ``plan.width`` columns, the phases in order; in
    each, rank 0's row as ``(B - partial) - chain`` solved against
    ``L_mm``, then every job's product added to its target (a row's
    partial sum, or the forward arrow tile) or written there if it is the
    first; a row is published at the end of its phase."""
    ndt, _, t, _ = Dr.shape
    k, nat = rhs.shape[-1], R.shape[1]
    nan = float("nan")
    out = torch.full_like(rhs, nan)
    out[:min(start, ndt)] = 0.0
    acca = torch.zeros((nat, t, k)) if start >= ndt else torch.full((nat, t, k), nan)
    phases = schedule(plan, ndt, start, backward)
    for ch in range(plan.chunks):
        cols = slice(ch * plan.width, min(k, (ch + 1) * plan.width))
        panels, slots = {}, {}
        for ph in phases:
            m = ph.row
            if m is not None:
                v = rhs[m][:, cols]
                if ph.partial:
                    v = v - slots.pop(m)
                if ph.chain:
                    v = v - (Dr[m + 1, 1].mT @ panels[m + 1] if backward
                             else Dr[m, 1] @ panels[m - 1])
                y = (torch.linalg.solve_triangular(Dr[m, 0].mT, v, upper=True) if backward
                     else torch.linalg.solve_triangular(Dr[m, 0], v, upper=False))
                out[m][:, cols] = y
            for job in ph.jobs:
                u, s, tg = job.unit, job.source, job.target
                if backward:
                    prod = (R[tg, u.index].mT @ xa[u.index][:, cols] if u.kind == "arrow"
                            else Dr[s, u.index].mT @ panels[s])
                else:
                    prod = (R[s, u.index] @ panels[s] if u.kind == "arrow"
                            else Dr[tg, u.index] @ panels[s])
                if not backward and u.kind == "arrow":
                    acca[tg][:, cols] = prod if job.first else acca[tg][:, cols] + prod
                else:
                    slots[tg] = prod if job.first else slots[tg] + prod
            if m is not None:
                panels[m] = y
        assert not slots
    return (out, acca) if not backward else out


def _inputs(t, ndt, bt, nat, seed):
    """The factor (as chip_smoke.py makes it) and 41 right-hand-side
    columns, the k = 1, 7 and 33 checks' side by side, rows and arrow
    panels from numpy."""
    Dr, R = _CHIP_SMOKE.random_band_factor(torch, ndt, bt, nat, t, seed, "cpu")
    rng = np.random.default_rng(seed + 1)
    bd = torch.from_numpy(rng.standard_normal((ndt, t, sum(KS))).astype(np.float32))
    xa = torch.from_numpy(rng.standard_normal((nat, t, sum(KS))).astype(np.float32))
    return Dr, R, bd, xa


@functools.lru_cache(maxsize=None)
def _references(t, ndt, bt, nat, start):
    """``repro``'s Pallas sweeps in interpret mode and its plain sweeps on
    all 41 columns at once (the columns are independent): one compile per
    shape, the start tile traced."""
    Dr, R, bd, xa = _inputs(t, ndt, bt, nat, seed=10 * t + ndt + bt + nat)
    bd[:start] = 0.0
    j = lambda x: jnp.asarray(x.numpy())
    pallas = (band_forward_sweep_pallas(j(Dr), j(R), j(bd), start, interpret=True),
              band_backward_sweep_pallas(j(Dr), j(R), j(bd), j(xa), start, interpret=True))
    plain = (jref.band_forward_sweep_ref(j(Dr), j(R), j(bd), start_tile=start),
             jref.band_backward_sweep_ref(j(Dr), j(R), j(bd), j(xa), start_tile=start))
    as_np = lambda f, b: tuple(np.asarray(a) for a in f) + (np.asarray(b),)
    return (Dr, R, bd, xa), as_np(*pallas), as_np(*plain)


@pytest.mark.parametrize("t", [8, 16, 64])
@pytest.mark.parametrize("ndt,bt,nat", GRIDS)
@pytest.mark.parametrize("k", KS)
@pytest.mark.parametrize("start", [0, 2])
def test_planned_sweeps_match_references(t, ndt, bt, nat, k, start):
    """The emulated planned sweeps at every cluster cap against ``repro``'s
    Pallas sweeps in interpret mode and both packages' plain sweeps, the
    zero prefix included; the cap changes no bit."""
    start = min(start, ndt - 1)
    (Dr, R, bd, xa), pallas, plain = _references(t, ndt, bt, nat, start)
    c0 = KS.index(k)
    cols = slice(sum(KS[:c0]), sum(KS[:c0 + 1]))
    bd, xa = bd[..., cols].contiguous(), xa[..., cols].contiguous()
    want_f = ref.band_forward_sweep_ref(Dr, R, bd, start)
    want_b = ref.band_backward_sweep_ref(Dr, R, bd, xa, start)
    first = None
    for cap in CLUSTERS:
        plan = solve_plan(t, bt, nat, k, cap, at_once=AT_ONCE)
        got = planned_sweep(plan, Dr, R, bd, start=start) + (
            planned_sweep(plan, Dr, R, bd, xa, start=start, backward=True),)
        for g, w, p, j, part in zip(got, want_f + (want_b,), pallas, plain,
                                    ("yd", "acc_a", "xd")):
            torch.testing.assert_close(g, w, msg=part, **TOL)
            np.testing.assert_allclose(g.numpy(), p[..., cols], err_msg=part, **TOL)
            np.testing.assert_allclose(g.numpy(), j[..., cols], err_msg=part, **TOL)
        if first is None:
            first = got
        else:
            assert all(torch.equal(g, f) for g, f in zip(got, first))
