"""The port's window route against the JAX package, on the CPU: the plain
versions of ``band_update`` and ``selinv_step`` against ``repro``'s plain
versions and its Pallas kernels in interpret mode, at rtol = atol = 2e-4
(``tests/test_kernels.py``'s tolerance: float32 sums in another order);
``factorize_window(sweep="window")`` against the reference's window sweep
(``impl="ref"``) at the same tolerance, its status word exactly; and the
``SolverOptions(sweep=...)`` dispatch and refusals.  Inputs are made from
a seed with numpy."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core.cholesky as jcholesky
from repro.core import BandedCTSF as JBandedCTSF
from repro.core import SolverOptions as JSolverOptions
from repro.core import TileGrid as JTileGrid
from repro.core import factorize_window as jfactorize_window
from repro.core import logdet as jlogdet
from repro.kernels import ref as jref
from repro.kernels.band_update import band_update_pallas
from repro.kernels.selinv import selinv_step_pallas
from repro_torch.core import (BandedCTSF, PartitionPlan, SolverOptions, TileGrid,
                              detect_partition_plan, factorize_window, logdet)
from repro_torch.core import cholesky
from repro_torch.data import block_separable_arrowhead, make_arrowhead
from repro_torch.kernels import ops, ref
from repro_torch.kernels.band_update import band_update_cuda
from repro_torch.kernels.potrf import potrf_cuda
from repro_torch.kernels.selinv import selinv_step_cuda
from repro_torch.kernels.tile_sum import MAX_CLUSTER, tile_sum_plan
from repro_torch.kernels.trsm import trsm_cuda

TOL = dict(rtol=2e-4, atol=2e-4)
# (n, bandwidth, arrow, t): tests/test_extras.py's window-sweep matrix, and
# one with no arrow
CASES = [(320, 24, 16, 16), (160, 8, 0, 16)]


def _pair(n, bw, ar, t, seed=5):
    """The same matrix in both packages."""
    A, st = make_arrowhead(n, bw, ar, rho=0.7, seed=seed)
    return (BandedCTSF.from_sparse(A, TileGrid(st, t), device="cpu"),
            JBandedCTSF.from_sparse(A, JTileGrid(st, t)))


@pytest.mark.parametrize("b1", [2, 3, 5, 9])
@pytest.mark.parametrize("t", [8, 16, 32])
def test_band_update_plain_versions_match_reference(b1, t):
    w = np.random.default_rng(100 * b1 + t).standard_normal((b1, b1, t, t)).astype(np.float32)
    tw = torch.from_numpy(w)
    pallas = np.asarray(band_update_pallas(jnp.asarray(w)))
    for got, jfn in ((ref.band_update_ref(tw), jref.band_update_ref),
                     (ref.band_update_unrolled_ref(tw), jref.band_update_unrolled_ref)):
        np.testing.assert_allclose(got.numpy(), np.asarray(jfn(jnp.asarray(w))), **TOL)
        np.testing.assert_allclose(got.numpy(), pallas, **TOL)
    # ops takes the reference's plain dispatch: the unrolled sum up to b+1 = 6
    plain = ref.band_update_unrolled_ref(tw) if b1 <= 6 else ref.band_update_ref(tw)
    assert torch.equal(ops.band_update(tw), plain)
    # a leading batch axis: each element as alone
    tb = torch.stack([tw, 2.0 * tw])
    for fn in (ref.band_update_ref, ref.band_update_unrolled_ref):
        out = fn(tb)
        torch.testing.assert_close(out[0], fn(tw), rtol=1e-6, atol=1e-6)
        torch.testing.assert_close(out[1], fn(2.0 * tw), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("e_n,j_n", [(1, 1), (3, 5), (4, 9), (2, 17), (0, 3), (2, 0)])
@pytest.mark.parametrize("t", [8, 16])
def test_selinv_step_plain_matches_pallas(e_n, j_n, t):
    """``ops.selinv_step`` on the CPU against ``selinv_step_pallas`` in
    interpret mode, the reference's empty cases included: no rows gives
    ``(0, t, t)``, an empty sum zeros."""
    rng = np.random.default_rng(10 * e_n + j_n + t)
    s = rng.standard_normal((e_n, j_n, t, t)).astype(np.float32)
    g = rng.standard_normal((j_n, t, t)).astype(np.float32)
    got = ops.selinv_step(torch.from_numpy(s), torch.from_numpy(g))
    want = np.asarray(selinv_step_pallas(jnp.asarray(s), jnp.asarray(g)))
    assert tuple(got.shape) == want.shape == (e_n, t, t)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    np.testing.assert_allclose(got.numpy(), np.asarray(jref.selinv_step_ref(s, g)), **TOL)


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("tree_chunks", [1, 8])
def test_window_route_matches_reference(case, tree_chunks):
    """``factorize_window(sweep="window")`` against the reference's window
    sweep: ``Dr``, ``R``, ``C`` to fp32 tolerance, the status word's flags
    exactly and its pivot to 1e-5; the logdet to 1e-5 relative, and the
    dense float64 Cholesky of the matrix."""
    m, jm = _pair(*case)
    f = factorize_window(m, tree_chunks=tree_chunks, options=SolverOptions(sweep="window"))
    jf = jfactorize_window(jm, tree_chunks=tree_chunks,
                           options=JSolverOptions(sweep="window", impl="ref"))
    for name in ("Dr", "R", "C"):
        np.testing.assert_allclose(getattr(f.ctsf, name).numpy(),
                                   np.asarray(getattr(jf.ctsf, name)), err_msg=name, **TOL)
    *_, jstatus = jcholesky._factorize_window_impl(jm.Dr, jm.R, jm.C, jm.grid, "ref",
                                                   tree_chunks, "window")
    jstatus = np.asarray(jstatus)
    assert f.status[1:].tolist() == jstatus[1:].tolist() == [0.0, -1.0]
    np.testing.assert_allclose(f.status[0].item(), jstatus[0], rtol=1e-5)
    want = float(jlogdet(jf))
    assert abs(float(logdet(f)) - want) <= 1e-5 * abs(want)
    L = np.linalg.cholesky(m.to_dense(lower_only=False).astype(np.float64))
    np.testing.assert_allclose(f.ctsf.to_dense(), L, **TOL)


def test_window_sweep_keeps_start_tile():
    """``_band_arrow_sweep`` leaves the rows below ``start_tile`` as they are
    and factors the rest, as the reference's does."""
    m, jm = _pair(*CASES[0])
    Dr, R = cholesky._band_arrow_sweep(m.Dr, m.R, m.grid, None, start_tile=3)
    jDr, jR = jcholesky._band_arrow_sweep(jm.Dr, jm.R, jm.grid, "ref", start_tile=3)
    np.testing.assert_allclose(Dr.numpy(), np.asarray(jDr), **TOL)
    np.testing.assert_allclose(R.numpy(), np.asarray(jR), **TOL)
    assert torch.equal(Dr[:3], m.Dr[:3]) and torch.equal(R[:3], m.R[:3])


def test_window_route_breakdown_status_matches_reference():
    """A negative pivot in band column 5: the status folded from the
    window sweep's factor is the reference's."""
    m, jm = _pair(*CASES[0])
    Dr = m.Dr.clone()
    Dr[5, 0] -= 1e3 * torch.eye(m.grid.t)
    f = factorize_window(BandedCTSF(m.grid, Dr, m.R, m.C), options=SolverOptions(sweep="window"))
    *_, jstatus = jcholesky._factorize_window_impl(jnp.asarray(Dr.numpy()), jm.R, jm.C, jm.grid,
                                                   "ref", 8, "window")
    assert f.status[1:].tolist() == np.asarray(jstatus)[1:].tolist() == [1.0, 5.0]


def test_sweep_refusals_match_reference():
    """An unknown sweep, ``"ring"`` with the kernels, ``"fused"`` with the
    plain versions and ``"partitioned"`` without a plan are refused, as the
    reference's ``_factorize_window_impl`` refuses them (``"pallas"`` there
    where the port says ``"cuda"``); so are a plan for another grid and the
    fused kernel on CPU tensors."""
    m, jm = _pair(*CASES[0])
    for sweep, impl, jimpl, match in (("diagonal", None, None, "unknown sweep"),
                                      ("ring", "cuda", "pallas", "contradicts"),
                                      ("fused", "ref", "ref", "contradicts"),
                                      ("partitioned", None, None, "partition plan")):
        with pytest.raises(ValueError, match=match):
            SolverOptions(sweep=sweep, impl=impl)
        with pytest.raises(ValueError):
            jcholesky._factorize_window_impl(jm.Dr, jm.R, jm.C, jm.grid, jimpl, 8, sweep)
    ndt = m.grid.n_diag_tiles
    with pytest.raises(ValueError, match="diagonal tiles"):
        factorize_window(m, options=SolverOptions(sweep="window",
                                                  partition_plan=PartitionPlan((0, ndt + 1))))
    with pytest.raises(ValueError, match="CUDA"):
        factorize_window(m, options=SolverOptions(sweep="fused"))
    assert SolverOptions().sweep == JSolverOptions().sweep == "auto"


def test_auto_sweep_keeps_the_dispatch():
    """``"auto"`` on the CPU is the ring sweep, bit for bit, and with a plan
    of more than one partition the partitioned sweep; a forced
    ``"partitioned"`` with a trivial plan gives the same factor as the
    plan-less call up to the Schur sum's order."""
    m, _ = _pair(*CASES[0])
    for a, b in zip(factorize_window(m).ctsf.arrays(),
                    factorize_window(m, options=SolverOptions(sweep="ring")).ctsf.arrays()):
        assert torch.equal(a, b)
    A, st, bounds = block_separable_arrowhead(100, 5, 4, 8, n_parts=4, seed=0)
    mp = BandedCTSF.from_sparse(A, TileGrid(st, 8), device="cpu")
    plan = detect_partition_plan(A, mp.grid.structure, 8)
    auto = factorize_window(mp, options=SolverOptions(partition_plan=plan))
    forced = factorize_window(mp, options=SolverOptions(partition_plan=plan, sweep="partitioned"))
    for a, b in zip(auto.ctsf.arrays(), forced.ctsf.arrays()):
        assert torch.equal(a, b)
    trivial = factorize_window(mp, options=SolverOptions(
        partition_plan=PartitionPlan.trivial(mp.grid.n_diag_tiles), sweep="partitioned"))
    plain = factorize_window(mp)
    assert torch.equal(trivial.ctsf.Dr, plain.ctsf.Dr) and torch.equal(trivial.ctsf.R, plain.ctsf.R)
    torch.testing.assert_close(trivial.ctsf.C, plain.ctsf.C, rtol=1e-5, atol=1e-6)


def test_window_route_launches_nothing_on_the_cpu():
    """On CPU tensors the window route runs the plain versions and no kernel
    is launched; the kernels refuse CPU tensors rather than fall back."""
    m, _ = _pair(*CASES[0])
    before = (band_update_cuda.launches, potrf_cuda.launches, trsm_cuda.launches,
              selinv_step_cuda.launches)
    factorize_window(m, options=SolverOptions(sweep="window"))
    ops.selinv_step(torch.zeros(2, 3, 8, 8), torch.zeros(3, 8, 8))
    assert (band_update_cuda.launches, potrf_cuda.launches, trsm_cuda.launches,
            selinv_step_cuda.launches) == before
    with pytest.raises(ValueError, match="CUDA"):
        ops.band_update(torch.zeros(3, 3, 8, 8), impl="cuda")
    with pytest.raises(ValueError, match="CUDA"):
        ops.selinv_step(torch.zeros(2, 3, 8, 8), torch.zeros(3, 8, 8), impl="cuda")
    with pytest.raises(ValueError, match="CUDA"):
        factorize_window(m, options=SolverOptions(sweep="window", impl="cuda"))


def _chip_smoke():
    import importlib.util
    from pathlib import Path
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize("case", CASES + [(200, 10, 30, 16)])
def test_chip_smoke_counts_window_launches(monkeypatch, case):
    """The launch counts chip_smoke.py demands of the window route are the
    calls the route makes: one per band_update, potrf, trsm and geadd call
    through ``ops``, counted here on the CPU path."""
    m, _ = _pair(*case)
    calls = {}
    for name in ("band_update", "potrf", "trsm", "geadd"):
        fn = getattr(ops, name)
        monkeypatch.setattr(ops, name, lambda *a, _fn=fn, _name=name, **k: (
            calls.__setitem__(_name, calls.get(_name, 0) + 1), _fn(*a, **k))[1])
    factorize_window(m, options=SolverOptions(sweep="window"))
    want = {k: v for k, v in _chip_smoke().window_launches(m.grid).items() if v}
    assert calls == want


def test_chip_smoke_takahashi_column_is_the_sweeps_step():
    """chip_smoke.py's Takahashi operands of a column give, through
    ``ops.selinv_step``, that column's Σ tiles of the selected inverse."""
    from repro_torch.core import selected_inverse
    m, _ = _pair(*CASES[0])
    f = factorize_window(m)
    j = m.grid.n_diag_tiles // 2
    srow, gcat, want = _chip_smoke().takahashi_column(torch, f, selected_inverse(f), j)
    bt, nat = m.grid.band_tiles, m.grid.n_arrow_tiles
    assert srow.shape == (bt + nat, bt + nat, 16, 16) and gcat.shape == (bt + nat, 16, 16)
    torch.testing.assert_close(-ops.selinv_step(srow, gcat), want, rtol=1e-5, atol=1e-6)


def _band_pairs(b1):
    """band_update's pair count of each target of a (b+1)-tile window."""
    return [b1 - 1 - e for e in range(b1)]


# (t, pair counts of the targets, batch): selinv_step's (e_n, j_n) shapes
# of the card tests, band_update's b + 1 in {1, 2, 3, 5, 6, 9} on a batch
# of three, and the θ-batch's (8, 5, 5, 64, 64) windows
PLAN_CASES = ([(t, [j_n] * e_n, 0) for t in (16, 64)
               for e_n, j_n in ((1, 1), (1, 2), (4, 3), (3, 5), (8, 8), (2, 17), (1, 17))]
              + [(t, _band_pairs(b1), 3) for t in (8, 64) for b1 in (1, 2, 3, 5, 6, 9)]
              + [(64, _band_pairs(5), 8)])


@pytest.mark.parametrize("t,pairs,batch", PLAN_CASES)
def test_tile_sum_plan_covers_every_pair_once(t, pairs, batch):
    """The launch plan of the tile-sum kernels: its sub-tiles partition the
    target, and over the grid's (sub-tile, rank) blocks every (target,
    sub-tile, pair) is summed exactly once, each rank's run contiguous, in
    order, and starting where the rank before it stopped."""
    plan = tile_sum_plan(t, pairs, batch)
    assert plan.sub == min(t, 32) and 1 <= plan.cluster <= MAX_CLUSTER
    assert plan.cluster * plan.per_rank >= max(pairs)
    assert plan.grid == (plan.cluster * plan.subtiles, len(pairs)) + ((batch,) if batch else ())
    ns = t // plan.sub
    origins = {(s // ns * plan.sub, s % ns * plan.sub) for s in range(plan.subtiles)}
    assert origins == {(r, c) for r in range(0, t, plan.sub) for c in range(0, t, plan.sub)}
    seen = {}
    for x in range(plan.grid[0]):
        sub, rank = divmod(x, plan.cluster)
        for e, n in enumerate(pairs):
            run = plan.pairs(rank, n)
            assert run.step == 1 and 0 <= run.start and run.stop <= n
            assert run.start == (plan.pairs(rank - 1, n).stop if rank else 0)
            for q in run:
                seen[e, sub, q] = seen.get((e, sub, q), 0) + 1
    want = {(e, sub, q) for e, n in enumerate(pairs) for sub in range(plan.subtiles)
            for q in range(n)}
    assert set(seen) == want and set(seen.values()) <= {1}


def test_tile_sum_plan_at_table2_shapes():
    """The block counts the kernels' notes state for Table II #5: selinv_step
    at (8, 8, 64, 64) 128 blocks in clusters of 4, two pairs a rank;
    band_update at (5, 5, 64, 64) 80 blocks, 40 of them with one pair, and
    640 for the θ-batch's 8 windows; without the contraction split
    (max_cluster=1) 32 and 20 blocks over whole chains."""
    step = tile_sum_plan(64, [8] * 8)
    assert (step.blocks, step.cluster, step.per_rank, step.grid) == (128, 4, 2, (16, 8))
    upd = tile_sum_plan(64, _band_pairs(5), 1)
    assert (upd.blocks, upd.cluster, upd.per_rank, upd.grid) == (80, 4, 1, (16, 5, 1))
    with_pairs = upd.subtiles * sum(1 for n in _band_pairs(5) for r in range(upd.cluster)
                                    if upd.pairs(r, n))
    assert with_pairs == 40
    assert tile_sum_plan(64, _band_pairs(5), 8).blocks == 640
    assert tile_sum_plan(64, [8] * 8, max_cluster=1).blocks == 32
    assert tile_sum_plan(64, _band_pairs(5), 1, max_cluster=1).blocks == 20
    assert tile_sum_plan(16, _band_pairs(1), 1).grid == (1, 1, 1)
    with pytest.raises(ValueError):
        tile_sum_plan(64, [])


@pytest.mark.parametrize("b1", [1, 2, 5, 9])
def test_chip_smoke_band_update_yardstick_is_the_update(b1):
    """chip_smoke.py's library yardstick of band_update, one einsum over the
    operands gathered beforehand, computes the update, for one window and
    for a strided batch of windows."""
    rng = np.random.default_rng(40 + b1)
    rows = torch.from_numpy(rng.standard_normal((3, 4 + b1, b1, 8, 8)).astype(np.float32))
    smoke = _chip_smoke()
    for w in (rows[0, 2:2 + b1], rows[:, 2:2 + b1]):
        wsh, rhs = smoke.band_update_gathered(torch, w)
        torch.testing.assert_close(torch.einsum("...ejab,...jcb->...eac", wsh, rhs),
                                   ref.band_update_unrolled_ref(w), **TOL)
