"""The port's partitioned route against the JAX package, on the CPU: the
partition-parallel sweep's plain version against ``repro``'s oracle, and
``factorize_window`` with a partition plan against ``repro``'s with
``impl="ref"`` (the reference's Pallas partitioned sweep does not run on
the installed jax), at 1, 2 and 4 partitions of
``block_separable_arrowhead``, at rtol = atol = 2e-4.  Within the port the
partitioned plain version is bit-identical to the fused one on
block-separable input, as the reference's is."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import BandedCTSF as JBandedCTSF
from repro.core import SolverOptions as JSolverOptions
from repro.core import TileGrid as JTileGrid
from repro.core import detect_partition_plan as jdetect_partition_plan
from repro.core import factorize_window as jfactorize_window
from repro.core import logdet as jlogdet
from repro.core.ordering import PartitionPlan as JPartitionPlan
from repro.data import block_separable_arrowhead as jblock_separable_arrowhead
from repro.kernels import ref as jref
from repro.kernels.ring import band_row_to_col as jband_row_to_col
from repro_torch.core import (BandedCTSF, PartitionPlan, SolverOptions, TileGrid,
                              detect_partition_plan, factorize_window, logdet)
from repro_torch.data import block_separable_arrowhead
from repro_torch.kernels import ops, ref
from repro_torch.kernels.band_cholesky import (band_cholesky_partitioned_sweep_cuda,
                                               band_cholesky_sweep_cuda)
from repro_torch.kernels.ring import band_col_to_row, band_row_to_col

TOL = dict(rtol=2e-4, atol=2e-4)
CASE = dict(n=100, bandwidth=5, arrow=4, t=8)


def _split(n_parts, seed=0, **case):
    """The same block-separable matrix in both packages."""
    case = {**CASE, **case}
    A, st, bounds = block_separable_arrowhead(n_parts=n_parts, seed=seed, **case)
    jA, jst, jbounds = jblock_separable_arrowhead(n_parts=n_parts, seed=seed, **case)
    assert bounds == jbounds and (A != jA).nnz == 0
    m = BandedCTSF.from_sparse(A, TileGrid(st, case["t"]), device="cpu")
    jm = JBandedCTSF.from_sparse(jA, JTileGrid(jst, case["t"]))
    return A, m, jm, bounds


@pytest.mark.parametrize("n_parts,start_tile", [(1, 0), (2, 3), (4, 0), (4, 3)])
def test_partitioned_sweep_ref_matches_reference(n_parts, start_tile):
    _, m, jm, bounds = _split(n_parts)
    got = ref.band_cholesky_partitioned_sweep_ref(band_row_to_col(m.Dr), m.R, bounds,
                                                  start_tile=start_tile)
    want = jref.band_cholesky_partitioned_sweep_ref(jband_row_to_col(jm.Dr), jm.R, bounds,
                                                    start_tile=start_tile)
    for g, w, name in zip(got, want, ("panels", "R_out", "schur", "status")):
        assert tuple(g.shape) == w.shape, name
        np.testing.assert_allclose(g.numpy(), np.asarray(w), err_msg=name, **TOL)
    for g, d in zip(got, ops.band_cholesky_partitioned_sweep(band_row_to_col(m.Dr), m.R, bounds,
                                                             start_tile=start_tile)):
        torch.testing.assert_close(g, d, rtol=0, atol=0)


@pytest.mark.parametrize("n_parts", [2, 4])
def test_partitioned_bit_identical_to_fused(n_parts):
    """The same tile math in the same order: panels, arrow rows and status
    equal the fused sweep's bit for bit; the Schur leaves sum to its chunk."""
    _, m, _, bounds = _split(n_parts)
    Ac = band_row_to_col(m.Dr)
    p_f, r_f, s_f, st_f = ref.band_cholesky_sweep_ref(Ac, m.R, nchunks=1)
    p_p, r_p, s_p, st_p = ref.band_cholesky_partitioned_sweep_ref(Ac, m.R, bounds)
    assert torch.equal(p_f, p_p) and torch.equal(r_f, r_p) and torch.equal(st_f, st_p)
    torch.testing.assert_close(s_p.sum(0), s_f[0], rtol=1e-5, atol=1e-6)


def test_combine_sweep_status_matches_reference():
    words = np.array([[2.0, 0.0, -1.0], [0.5, 1.0, 7.0], [1.5, 0.0, 3.0]], np.float32)
    for w in (words, words[:1], words[[0, 0]], words[:0]):
        np.testing.assert_array_equal(ref.combine_sweep_status(torch.from_numpy(w)).numpy(),
                                      np.asarray(jref.combine_sweep_status(jnp.asarray(w))))
    with pytest.raises(ValueError, match="strictly increasing"):
        ref.band_cholesky_partitioned_sweep_ref(torch.zeros(4, 2, 8, 8), torch.zeros(4, 1, 8, 8),
                                                (0, 2, 2, 4))


@pytest.mark.parametrize("n_parts", [1, 2, 4])
def test_partitioned_factorize_window_matches_reference(n_parts):
    A, m, jm, bounds = _split(n_parts)
    plan = detect_partition_plan(A, m.grid.structure, m.grid.t)
    jplan = jdetect_partition_plan(A, jm.grid.structure, jm.grid.t)
    assert plan.boundaries == jplan.boundaries == bounds
    f = factorize_window(m, options=SolverOptions(partition_plan=plan))
    jf = jfactorize_window(jm, options=JSolverOptions(partition_plan=jplan, impl="ref"))
    for name in ("Dr", "R", "C"):
        np.testing.assert_allclose(getattr(f.ctsf, name).numpy(),
                                   np.asarray(getattr(jf.ctsf, name)), err_msg=name, **TOL)
    want = float(jlogdet(jf))
    assert abs(float(logdet(f)) - want) <= 1e-5 * abs(want)
    L = np.linalg.cholesky(m.to_dense(lower_only=False).astype(np.float64))
    np.testing.assert_allclose(f.ctsf.to_dense(), L, **TOL)
    # the band of the fused route bit for bit, the corner to a sum reorder
    fused = factorize_window(m)
    assert torch.equal(f.ctsf.Dr, fused.ctsf.Dr) and torch.equal(f.ctsf.R, fused.ctsf.R)
    torch.testing.assert_close(f.ctsf.C, fused.ctsf.C, **TOL)
    assert f.status[1:].tolist() == [0.0, -1.0]


def test_trivial_plan_stays_on_the_fused_route():
    A, m, _, _ = _split(1)
    plan = PartitionPlan.trivial(m.grid.n_diag_tiles)
    f = factorize_window(m, options=SolverOptions(partition_plan=plan))
    f0 = factorize_window(m)
    for a, b in zip(f.ctsf.arrays(), f0.ctsf.arrays()):
        assert torch.equal(a, b)
    # the one-partition sweep gives the same band
    panels, R_out, _, _ = ops.band_cholesky_partitioned_sweep(
        band_row_to_col(m.Dr), m.R, plan.boundaries)
    assert torch.equal(band_col_to_row(panels), f0.ctsf.Dr) and torch.equal(R_out, f0.ctsf.R)


def test_sweep_options_refuse_what_the_reference_refuses():
    """A plan of the wrong type or for another grid is refused, as the
    reference refuses them, and so is the partitioned sweep without a
    plan."""
    _, m, _, bounds = _split(2)
    with pytest.raises(ValueError, match="partition plan"):
        SolverOptions(sweep="partitioned")
    with pytest.raises(TypeError):
        SolverOptions(partition_plan=bounds)
    with pytest.raises(ValueError, match="diagonal tiles"):
        factorize_window(m, options=SolverOptions(
            partition_plan=PartitionPlan(bounds[:-1] + (bounds[-1] + 1,))))
    with pytest.raises(ValueError, match="CUDA"):
        factorize_window(m, options=SolverOptions(impl="cuda", partition_plan=PartitionPlan(bounds)))
    # the plan is the JAX package's, field for field
    jplan = JPartitionPlan(bounds, sep_tiles=1)
    plan = PartitionPlan(bounds, sep_tiles=1)
    assert (plan.boundaries, plan.sep_tiles, plan.n_partitions, plan.max_tiles) == \
        (jplan.boundaries, jplan.sep_tiles, jplan.n_partitions, jplan.max_tiles)


def test_partitioned_wrapper_refuses_cpu_tensors():
    _, m, _, bounds = _split(2)
    Ac = band_row_to_col(m.Dr)
    before = (band_cholesky_partitioned_sweep_cuda.launches, band_cholesky_sweep_cuda.launches)
    with pytest.raises(ValueError, match="CUDA"):
        band_cholesky_partitioned_sweep_cuda(Ac, m.R, bounds)
    with pytest.raises(ValueError, match="CUDA"):
        ops.band_cholesky_partitioned_sweep(Ac, m.R, bounds, impl="cuda")
    ops.band_cholesky_partitioned_sweep(Ac, m.R, bounds)
    factorize_window(m, options=SolverOptions(partition_plan=PartitionPlan(bounds)))
    assert (band_cholesky_partitioned_sweep_cuda.launches,
            band_cholesky_sweep_cuda.launches) == before
