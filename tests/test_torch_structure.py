"""The port's host-side modules (structure, symbolic, ordering, data) are
exact copies in behaviour: every result equals the JAX package's on the
cases of ``test_structure_ordering.py``."""
import numpy as np
import pytest
import scipy.sparse as sp

from repro.core import ordering as jordering
from repro.core import structure as jstructure
from repro.core import symbolic as jsymbolic
from repro.data import gmrf as jgmrf
from repro_torch.core import ordering as tordering
from repro_torch.core import structure as tstructure
from repro_torch.core import symbolic as tsymbolic
from repro_torch.data import gmrf as tgmrf

# (n, bandwidth, arrow, rho, seed, t): the matrices of test_structure_ordering.py
CASES = [(300, 20, 12, 0.7, 0, 16), (200, 24, 16, 0.7, 1, 16),
         (150, 16, 8, 0.7, 2, 16), (120, 12, 6, 0.7, 3, 8),
         (272, 16, 16, 0.0, 4, 16), (200, 24, 8, 0.7, 5, 16),
         (240, 12, 0, 0.7, 6, 16)]


def _same_sparse(a, b):
    assert a.shape == b.shape and a.dtype == b.dtype
    assert (sp.csr_matrix(a) != sp.csr_matrix(b)).nnz == 0


def _struct(s):
    return (s.n, s.bandwidth, s.arrow)


def _grid(g):
    return (_struct(g.structure), g.t, g.n_diag_tiles, g.n_arrow_tiles,
            g.n_tiles, g.band_tiles, g.padded_n)


def _pair(case):
    n, bw, ar, rho, seed, _ = case
    return (jgmrf.make_arrowhead(n, bw, ar, rho=rho, seed=seed),
            tgmrf.make_arrowhead(n, bw, ar, rho=rho, seed=seed))


@pytest.mark.parametrize("case", CASES)
def test_make_arrowhead_and_measure(case):
    (ja, js), (ta, ts) = _pair(case)
    _same_sparse(ja, ta)
    assert _struct(js) == _struct(ts)
    for hint in (case[2], None):
        assert _struct(jstructure.measure_arrowhead(ja, arrow_hint=hint)) == \
            _struct(tstructure.measure_arrowhead(ta, arrow_hint=hint))
    assert js.density() == ts.density()


@pytest.mark.parametrize("case", CASES)
def test_tile_grid_and_patterns(case):
    (ja, js), (ta, ts) = _pair(case)
    t = case[5]
    jg = jstructure.TileGrid(jstructure.measure_arrowhead(ja, arrow_hint=case[2]), t)
    tg = tstructure.TileGrid(tstructure.measure_arrowhead(ta, arrow_hint=case[2]), t)
    assert _grid(jg) == _grid(tg)
    assert [jg.padded_index(i) for i in range(case[0])] == \
        [tg.padded_index(i) for i in range(case[0])]
    np.testing.assert_array_equal(jstructure.tile_pattern_from_coo(ja, jg),
                                  tstructure.tile_pattern_from_coo(ta, tg))
    np.testing.assert_array_equal(jstructure.banded_arrowhead_tile_pattern(jg),
                                  tstructure.banded_arrowhead_tile_pattern(tg))


@pytest.mark.parametrize("case", CASES)
def test_symbolic_task_lists(case):
    (ja, _), (ta, _) = _pair(case)
    t = case[5]
    jg = jstructure.TileGrid(jstructure.measure_arrowhead(ja, arrow_hint=case[2]), t)
    tg = tstructure.TileGrid(tstructure.measure_arrowhead(ta, arrow_hint=case[2]), t)
    js = jsymbolic.symbolic_factorize(jstructure.tile_pattern_from_coo(ja, jg))
    ts = tsymbolic.symbolic_factorize(tstructure.tile_pattern_from_coo(ta, tg))
    assert [(int(x.type), x.k, x.m, x.n) for x in js.tasks] == \
        [(int(x.type), x.k, x.m, x.n) for x in ts.tasks]
    np.testing.assert_array_equal(js.l_pattern, ts.l_pattern)
    assert js.fill_tiles == ts.fill_tiles
    assert js.total_flops(t) == ts.total_flops(t)
    assert js.critical_path_length() == ts.critical_path_length()
    assert js.max_parallelism() == ts.max_parallelism()
    np.testing.assert_array_equal(js.accumulation_counts(), ts.accumulation_counts())


@pytest.mark.parametrize("case", CASES)
def test_orderings(case):
    (ja, js), (ta, ts) = _pair(case)
    t = case[5]
    jr = jordering.best_ordering(ja, js, t=t)
    tr = tordering.best_ordering(ta, ts, t=t)
    assert (jr.name, jr.fill_before, jr.fill_after, jr.accepted) == \
        (tr.name, tr.fill_before, tr.fill_after, tr.accepted)
    np.testing.assert_array_equal(jr.perm, tr.perm)
    for partial in (True, False):
        np.testing.assert_array_equal(jordering.rcm_ordering(ja, js, partial=partial),
                                      tordering.rcm_ordering(ta, ts, partial=partial))
    np.testing.assert_array_equal(jordering.amd_ordering(ja, js),
                                  tordering.amd_ordering(ta, ts))
    jn = jordering.adaptive_nd_ordering(ja, js, n_parts=2)
    tn = tordering.adaptive_nd_ordering(ta, ts, n_parts=2)
    assert jn.accepted == tn.accepted
    np.testing.assert_array_equal(jn.perm, tn.perm)
    if jn.partitions is not None:
        np.testing.assert_array_equal(jn.partitions, tn.partitions)
    assert jordering.tile_fill_in(ja, js, t) == tordering.tile_fill_in(ta, ts, t)
    jp = jordering.detect_partition_plan(ja, js, t)
    tp = tordering.detect_partition_plan(ta, ts, t)
    assert (jp.boundaries, jp.sep_tiles) == (tp.boundaries, tp.sep_tiles)


def test_scrambled_ordering():
    (ja, _), (ta, _) = _pair(CASES[-1])
    perm = np.random.default_rng(0).permutation(240)
    jsc, tsc = jordering.apply_permutation(ja, perm), tordering.apply_permutation(ta, perm)
    _same_sparse(jsc, tsc)
    jm = jstructure.measure_arrowhead(jsc, arrow_hint=0)
    tm = tstructure.measure_arrowhead(tsc, arrow_hint=0)
    assert _struct(jm) == _struct(tm)
    jr, tr = jordering.best_ordering(jsc, jm, t=16), tordering.best_ordering(tsc, tm, t=16)
    assert (jr.name, jr.fill_after) == (tr.name, tr.fill_after)
    np.testing.assert_array_equal(jr.perm, tr.perm)


@pytest.mark.parametrize("matrix_id", [1, 2, 4, 5, 6])
def test_table2_matrix_scaled(matrix_id):
    ja, js = jgmrf.table2_matrix(matrix_id, scale=0.02, seed=0)
    ta, ts = tgmrf.table2_matrix(matrix_id, scale=0.02, seed=0)
    _same_sparse(ja, ta)
    assert _struct(js) == _struct(ts)
    assert jgmrf.TABLE2 == tgmrf.TABLE2


def test_tile_counts_constructor():
    for counts in [(8, 5, 2, 1), (16, 1, 0, 0), (16, 4, 3, 0), (32, 6, 1, 3)]:
        assert _grid(jstructure.TileGrid.from_tile_counts(*counts)) == \
            _grid(tstructure.TileGrid.from_tile_counts(*counts))
    jp = jordering.PartitionPlan(boundaries=(0, 3, 7)).shifted(2)
    tp = tordering.PartitionPlan(boundaries=(0, 3, 7)).shifted(2)
    assert (jp.boundaries, jp.max_tiles, jp.n_partitions) == \
        (tp.boundaries, tp.max_tiles, tp.n_partitions)


@pytest.mark.parametrize("tiles", [(157, 4, 4), (157, 4, 1), (6, 2, 0), (1, 0, 2), (9, 3, 3)])
def test_chip_smoke_counts_needed_flops(tiles):
    """The operation count behind chip_smoke.py's bounds is the work the
    factorization needs: per band column a symmetric diagonal update (t^3
    per product), band and arrow updates (2 t^3), a potrf, one solve per
    existing tile below it and the corner-Schur update (t^3 per symmetric
    S[i, i], 2 t^3 per other tile); the corner is a dense Cholesky."""
    import importlib.util
    from pathlib import Path
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    ndt, bt, nat = tiles
    t = 16
    sweep, corner = chip_smoke.needed_flops(
        tstructure.TileGrid.from_tile_counts(t, ndt, bt, nat))
    want = 0.0
    for k in range(ndt):
        jmax, nb = min(bt, k), min(bt, ndt - 1 - k)
        want += jmax * t ** 3 + sum(min(bt - e, k) for e in range(1, nb + 1)) * 2 * t ** 3
        want += nat * jmax * 2 * t ** 3 + t ** 3 / 3 + (nb + nat) * t ** 3 + nat * nat * t ** 3
    assert sweep == pytest.approx(want, rel=1e-12)
    # corner column k: potrf, syrk over k columns, nat-1-k solves and gemms
    want_corner = sum(t ** 3 / 3 + k * t ** 3 + (nat - 1 - k) * (1 + 2 * k) * t ** 3
                      for k in range(nat))
    assert corner == pytest.approx(want_corner, rel=1e-12)


@pytest.mark.parametrize("ndt,bt,nat", [(6, 2, 1), (9, 4, 4), (5, 1, 0)])
def test_chip_smoke_counts_solve_work(ndt, bt, nat):
    """The work behind chip_smoke.py's bounds of the solve kernels, counted
    a row and a column at a time from the tiles the grid has: a forward
    row reads min(bt, m) band tiles, its diagonal tile and nat arrow tiles;
    a selinv column j, d = min(bt, ndt - 1 - j), makes (d + nat)^2 general
    tile products (2 t^3), d + nat by the triangular L_jj^{-1} (t^3), d +
    nat summed into the symmetric diagonal (t^3), one W^T W and one
    triangular inverse (t^3 / 3 each)."""
    import importlib.util
    from pathlib import Path
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    t, k = 16, 3
    work = chip_smoke.solve_work(tstructure.TileGrid.from_tile_counts(t, ndt, bt, nat), k)
    rows = [min(bt, m) for m in range(ndt)]
    ops = sum(2 * t * t * k * (r + nat) + t * t * k for r in rows)
    tiles = sum(r + 1 for r in rows) + ndt * nat
    assert work["band_forward_sweep"] == (ops, 4 * (tiles * t * t + 2 * ndt * t * k + nat * t * k))
    assert work["band_backward_sweep"] == work["band_forward_sweep"]
    assert work["solve_panel"] == (t * t * k, 4 * (t * t + 2 * t * k))
    cols = [min(bt, ndt - 1 - j) for j in range(ndt)]
    gemms = sum(d * (d + nat) + nat * (nat + d) for d in cols)
    trmms = syrks = sum(d + nat for d in cols)
    assert work["selinv_sweep"][0] == pytest.approx(
        t ** 3 * (2 * gemms + trmms + syrks + 2 * ndt / 3))
    assert work["selinv_sweep"][1] == 4 * t * t * (2 * tiles + nat * nat)
    # the pre-pass: W, W^T W, d + nat products by W, nat^2 corner products
    assert work["selinv_prepass"][0] == pytest.approx(
        t ** 3 * sum(2 / 3 + d + nat + 2 * nat * nat for d in cols))
    assert work["selinv_prepass"][1] == 4 * t * t * (tiles + nat * nat
                                                     + ndt * (bt + 2 * nat + 2))


@pytest.mark.parametrize("sizes,bt,nat", [((25, 25, 7), 1, 4), ((3, 3, 4), 2, 1), ((5, 5), 3, 0)])
def test_chip_smoke_counts_partitioned_flops(sizes, bt, nat):
    """With partition boundaries the band tiles across the cuts are zero:
    the sweep's work is the sum of the partitions' own sweeps, and the
    corner's is unchanged."""
    import importlib.util
    from pathlib import Path
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    t = 16
    bounds = tuple(np.concatenate([[0], np.cumsum(sizes)]).tolist())
    grid = tstructure.TileGrid.from_tile_counts(t, bounds[-1], bt, nat)
    sweep, corner = chip_smoke.needed_flops(grid, bounds)
    parts = [chip_smoke.needed_flops(tstructure.TileGrid.from_tile_counts(t, s, bt, nat))
             for s in sizes]
    assert sweep == pytest.approx(sum(p[0] for p in parts), rel=1e-12)
    assert corner == pytest.approx(chip_smoke.needed_flops(grid)[1], rel=1e-12)
    assert sweep < chip_smoke.needed_flops(grid)[0] or bt == 0 or len(sizes) == 1
