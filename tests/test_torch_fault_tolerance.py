"""The port's ``runtime/fault_tolerance.py`` against the JAX package's, on
the CPU: the injectors' records, the corrupted batches (every entry the
same, the indefinite shift's drop within the float32 bound of the sum its
mean adds: the band's diagonal is summed in XLA's order there and in
PyTorch's here), the seeded dispatch decisions and straggler flags equal to the
reference's; and the corrupted batch through ``regularize=True``: the same
per-element statuses as the reference's on its own corrupted batch."""
import functools

import numpy as np
import pytest
import torch

import repro.core as J
from repro.core.concurrent import stack_ctsf as jstack_ctsf
from repro.runtime import fault_tolerance as jft
from repro_torch.core import (STATUS_FAILED, STATUS_OK, STATUS_RECOVERED, BandedCTSF,
                              SolverOptions, TileGrid, factorize_window_batched)
from repro_torch.core.concurrent import stack_ctsf
from repro_torch.data import make_arrowhead
from repro_torch.runtime.fault_tolerance import (DispatchFaultInjector, FailureInjector,
                                                 InjectedDispatchError, NumericalFaultInjector,
                                                 StragglerMonitor)

# (n, bandwidth, arrow, t): a thin band, a deep one, wide tiles
GRIDS = [(96, 16, 8, 8), (1000, 40, 30, 16), (3000, 100, 64, 64)]


@functools.lru_cache(maxsize=None)
def _batches(n, bw, ar, t, nb=4):
    """A batch of ``nb`` matrices of one grid in both packages (the
    injectors leave their input as it is, so one build serves every
    case)."""
    mats, jmats = [], []
    for s in range(nb):
        A, st = make_arrowhead(n, bw, ar, rho=0.6, seed=s)
        mats.append(BandedCTSF.from_sparse(A, TileGrid(st, t), device="cpu"))
        jgrid = J.TileGrid(J.ArrowheadStructure(n=st.n, bandwidth=st.bandwidth,
                                                arrow=st.arrow), t)
        jmats.append(J.BandedCTSF.from_sparse(A, jgrid))
    return stack_ctsf(mats), jstack_ctsf(jmats)


def _same_corruption(got, want, shifted):
    """Every entry equal (NaN where NaN) except the shifted tiles'
    diagonals, which agree within the float32 bound of a sum of the
    ``ndt * t`` diagonal entries the drop's mean adds, ``ndt * t * 2**-24``
    relative, whatever the order."""
    g, w = got.Dr.numpy(), np.asarray(want.Dr)
    np.testing.assert_array_equal(np.isnan(g), np.isnan(w))
    mask = np.ones(g.shape, bool)
    ndt, t = g.shape[1], g.shape[-1]
    for idx, tile in shifted:
        mask[idx, tile, 0, np.arange(t), np.arange(t)] = False
        np.testing.assert_allclose(g[idx, tile, 0].diagonal(), w[idx, tile, 0].diagonal(),
                                   rtol=ndt * t * 2.0 ** -24)
    np.testing.assert_array_equal(np.where(mask, g, 0), np.where(mask, w, 0))
    for a, b in ((got.R, want.R), (got.C, want.C)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("n,bw,ar,t", GRIDS)
@pytest.mark.parametrize("seed", [0, 1, 5])
def test_numerical_fault_injector_matches_reference(n, bw, ar, t, seed):
    batch, jbatch = _batches(n, bw, ar, t)
    modes = {3: "nan", 0: "indefinite", 1: "indefinite"}
    inj, jinj = NumericalFaultInjector(seed=seed), jft.NumericalFaultInjector(seed=seed)
    got, want = inj.corrupt(batch, modes), jinj.corrupt(jbatch, modes)
    assert inj.injected == jinj.injected
    assert [(i, m) for i, m, _ in inj.injected] == [(0, "indefinite"), (1, "indefinite"),
                                                    (3, "nan")]
    _same_corruption(got, want, [(i, tile) for i, m, tile in inj.injected if m == "indefinite"])
    assert not torch.isnan(batch.Dr).any()            # the input is left as it was


@pytest.mark.parametrize("mode", ["indefinite", "nan"])
def test_corrupt_one_matches_reference(mode):
    batch, jbatch = _batches(*GRIDS[0], nb=1)
    m = BandedCTSF(batch.grid, batch.Dr[0], batch.R[0], batch.C[0])
    jm = J.BandedCTSF(jbatch.grid, jbatch.Dr[0], jbatch.R[0], jbatch.C[0])
    inj, jinj = NumericalFaultInjector(seed=2), jft.NumericalFaultInjector(seed=2)
    got, want = inj.corrupt_one(m, mode), jinj.corrupt_one(jm, mode)
    assert inj.injected == jinj.injected
    one = lambda x: BandedCTSF(x.grid, x.Dr[None], x.R[None], x.C[None])
    jone = lambda x: J.BandedCTSF(x.grid, x.Dr[None], x.R[None], x.C[None])
    _same_corruption(one(got), jone(want),
                     [(0, inj.injected[0][2])] if mode == "indefinite" else [])


def test_unknown_corruption_mode_is_refused_as_in_the_reference():
    batch, jbatch = _batches(*GRIDS[0], nb=2)
    for inj, b in ((NumericalFaultInjector(), batch), (jft.NumericalFaultInjector(), jbatch)):
        with pytest.raises(ValueError, match="unknown corruption mode 'zero' for element 1"):
            inj.corrupt(b, {1: "zero"})


def test_corrupted_batch_through_the_ladder_matches_reference():
    batch, jbatch = _batches(*GRIDS[0])
    modes = {1: "indefinite", 2: "nan"}
    bad = NumericalFaultInjector(seed=0).corrupt(batch, modes)
    jbad = jft.NumericalFaultInjector(seed=0).corrupt(jbatch, modes)
    f = factorize_window_batched(bad, bucket=False, options=SolverOptions(regularize=True))
    jf = J.factorize_window_batched(jbad, bucket=False, options=J.SolverOptions(
        impl="ref", regularize=True))
    assert f.info.status.tolist() == [STATUS_OK, STATUS_RECOVERED, STATUS_FAILED, STATUS_OK]
    np.testing.assert_array_equal(f.info.status.numpy(), np.asarray(jf.info.status))
    np.testing.assert_array_equal(f.info.attempts.numpy(), np.asarray(jf.info.attempts))
    np.testing.assert_array_equal(f.info.first_bad_tile.numpy(),
                                  np.asarray(jf.info.first_bad_tile))


def _dispatch_outcomes(inj, schedule):
    out = []
    for tag, rids, attempt in schedule:
        try:
            inj.before_dispatch(tag, rids, attempt=attempt)
            out.append((tag, rids, attempt, None))
        except (InjectedDispatchError, jft.InjectedDispatchError) as e:
            out.append((tag, rids, attempt, e.kind, e.tag, e.rids, e.attempt, str(e)))
        out.append(inj.straggler_extra_for(tag, rids))
    return out


@pytest.mark.parametrize("kw", [
    dict(seed=3, transient_rate=0.5),
    dict(seed=0, transient_rate=1.0, transient_attempts=1, poison_rids=(7,)),
    dict(seed=11, transient_rate=0.4, transient_attempts=2, poison_rids=(3,),
         poison_rungs=("ndt12.bt1.nat1.t8",), straggler_rate=0.3, straggler_extra=2e-3)])
def test_dispatch_fault_injector_matches_reference(kw):
    rng = np.random.default_rng(0)
    tags = ["ndt6.bt1.nat1.t8", "ndt12.bt1.nat1.t8", "ndt256.bt4.nat4.t64"]
    schedule = [(tags[rng.integers(3)], tuple(int(r) for r in rng.choice(10, rng.integers(1, 4),
                                                                         replace=False)),
                 int(rng.integers(3))) for _ in range(40)]
    inj, jinj = DispatchFaultInjector(**kw), jft.DispatchFaultInjector(**kw)
    assert _dispatch_outcomes(inj, schedule) == _dispatch_outcomes(jinj, schedule)
    assert inj.injected == jinj.injected
    # decisions hash the composition, not the call order
    again = DispatchFaultInjector(**kw)
    assert sorted(map(str, _dispatch_outcomes(again, schedule[::-1]))) == sorted(
        map(str, _dispatch_outcomes(DispatchFaultInjector(**kw), schedule)))


def test_dispatch_fault_injector_refuses_bad_rates():
    for cls in (DispatchFaultInjector, jft.DispatchFaultInjector):
        with pytest.raises(ValueError, match="transient_rate must be in"):
            cls(transient_rate=1.5)
        with pytest.raises(ValueError, match="straggler_rate must be in"):
            cls(straggler_rate=-0.1)


def test_straggler_monitor_matches_reference():
    durations = list(np.random.default_rng(4).lognormal(0.0, 0.6, 200))
    durations[50] = 30.0
    for kw in (dict(), dict(factor=2.0, window=8, min_history=3)):
        mon, jmon = StragglerMonitor(**kw), jft.StragglerMonitor(**kw)
        hits = [mon.record(i, d) for i, d in enumerate(durations)]
        jhits = [jmon.record(i, d) for i, d in enumerate(durations)]
        assert hits == jhits and mon.flagged == jmon.flagged and mon.flagged
        assert mon.median == jmon.median
    assert StragglerMonitor().median == 0.0


def test_failure_injector_matches_reference():
    def drive(inj):
        raised = []
        for step in range(8):
            for _ in range(3):
                try:
                    inj.maybe_fail(step)
                    break
                except RuntimeError as e:
                    raised.append(str(e))
        return raised, inj.injected
    assert drive(FailureInjector({4: 1, 6: 2})) == drive(jft.FailureInjector({4: 1, 6: 2}))
    assert drive(FailureInjector())[1] == []
