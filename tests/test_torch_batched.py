"""The port's batched window factorization against the JAX package, on the
CPU: ``factorize_window_batched`` on the ring, window and partitioned
routes (``impl="ref"`` on both sides; the reference's Pallas partitioned
sweep does not run on the installed jax) against ``repro``'s, for a list
and for a stacked input, at rtol = atol = 2e-4 (float32, sums in another
order) and the logdets to 1e-5 relative; each element against the
unbatched port call; the input errors; and the batched plain sweeps
against a loop of unbatched ones, bit for bit.

The batch is an INLA θ-sweep: ``A_θ = τ_θ A + δ_θ I`` for one sparsity
pattern, τ > 0 and δ >= 0 drawn from a seed with numpy, so every element
stays SPD."""
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from repro.core import BandedCTSF as JBandedCTSF
from repro.core import SolverOptions as JSolverOptions
from repro.core import TileGrid as JTileGrid
from repro.core import detect_partition_plan as jdetect_partition_plan
from repro.core import factorize_window_batched as jfactorize_window_batched
from repro.core import logdet as jlogdet
from repro_torch.core import (BandedCTSF, SolverOptions, TileGrid, detect_partition_plan,
                              factorize_window, factorize_window_batched, logdet)
from repro_torch.core.robustness import fold_corner_status
from repro_torch.data import block_separable_arrowhead, make_arrowhead
from repro_torch.kernels import ref
from repro_torch.kernels.ring import band_col_to_row, band_row_to_col

TOL = dict(rtol=2e-4, atol=2e-4)
B = 3
ROUTES = ["ring", "window", "partitioned"]


def _theta_batch(route, seed=0):
    """B θ-candidates of one matrix in both packages: ``(mats, jmats,
    options, joptions)``; the partitioned route's matrix is block-separable
    with the plan ``detect_partition_plan`` finds (3 partitions)."""
    if route == "partitioned":
        A, st, _ = block_separable_arrowhead(120, 6, 8, 8, n_parts=3, seed=seed)
        t = 8
    else:
        A, st = make_arrowhead(240, 24, 16, rho=0.7, seed=seed)
        t = 16
    rng = np.random.default_rng(seed)
    tau, delta = rng.uniform(0.5, 2.0, B), rng.uniform(0.0, 0.5, B)
    eye = sp.identity(A.shape[0], format="csr")
    As = [(tau[i] * A + delta[i] * eye).tocsr() for i in range(B)]
    mats = [BandedCTSF.from_sparse(a, TileGrid(st, t), device="cpu") for a in As]
    jmats = [JBandedCTSF.from_sparse(a, JTileGrid(st, t)) for a in As]
    if route == "partitioned":
        plan = detect_partition_plan(A, mats[0].grid.structure, t)
        jplan = jdetect_partition_plan(A, jmats[0].grid.structure, t)
        assert plan.n_partitions == 3 and plan.boundaries == jplan.boundaries
        return (mats, jmats, SolverOptions(partition_plan=plan),
                JSolverOptions(partition_plan=jplan, impl="ref"))
    return mats, jmats, SolverOptions(sweep=route), JSolverOptions(sweep=route, impl="ref")


def _stacked(mats, cls, stack):
    return cls(mats[0].grid, *(stack([getattr(m, x) for m in mats]) for x in ("Dr", "R", "C")))


@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("form", ["list", "stacked"])
def test_batched_matches_reference(route, form):
    mats, jmats, opts, jopts = _theta_batch(route)
    if form == "stacked":
        mats = _stacked(mats, BandedCTSF, torch.stack)
        jmats = _stacked(jmats, JBandedCTSF, jnp.stack)
    f = factorize_window_batched(mats, options=opts)
    jf = jfactorize_window_batched(jmats, options=jopts)
    for name in ("Dr", "R", "C"):
        got, want = getattr(f.ctsf, name).numpy(), np.asarray(getattr(jf.ctsf, name))
        assert got.shape == want.shape and got.shape[0] == B, name
        np.testing.assert_allclose(got, want, err_msg=name, **TOL)
    got, want = logdet(f).numpy(), np.asarray(jlogdet(jf))
    assert got.shape == (B,)
    np.testing.assert_allclose(got, want, rtol=1e-5)
    assert f.status.shape == (B, 3) and f.status[:, 1:].tolist() == [[0.0, -1.0]] * B


@pytest.mark.parametrize("route", ROUTES)
def test_batched_elements_match_unbatched(route):
    """Element i of the batch is the unbatched factorization of matrix i:
    the band and the status bit for bit on the ring and partitioned routes
    (their plain sweeps loop over the batch), the rest to 1e-6."""
    mats, _, opts, _ = _theta_batch(route, seed=1)
    f = factorize_window_batched(mats, options=opts, bucket=False)
    for i, m in enumerate(mats):
        one = factorize_window(m, options=opts)
        for name in ("Dr", "R", "C"):
            got, want = getattr(f.ctsf, name)[i], getattr(one.ctsf, name)
            if route != "window" and name != "C":
                assert torch.equal(got, want), (name, i)
            torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)
        torch.testing.assert_close(f.status[i], one.status, rtol=1e-6, atol=0)
        torch.testing.assert_close(logdet(f)[i], logdet(one), rtol=1e-6, atol=0)


def test_batched_input_errors():
    """Mixed grids and a stacked input without a batch axis are refused, as
    the reference refuses them; so is an empty list."""
    mats, jmats, _, _ = _theta_batch("ring")
    A, st = make_arrowhead(200, 24, 16, rho=0.7, seed=0)
    other = BandedCTSF.from_sparse(A, TileGrid(st, 16), device="cpu")
    jother = JBandedCTSF.from_sparse(A, JTileGrid(st, 16))
    with pytest.raises(ValueError, match="equal structure"):
        factorize_window_batched([mats[0], other])
    with pytest.raises(ValueError, match="equal structure"):
        jfactorize_window_batched([jmats[0], jother], options=JSolverOptions(impl="ref"))
    with pytest.raises(ValueError, match="leading batch axis"):
        factorize_window_batched(mats[0])
    with pytest.raises(ValueError, match="leading batch axis"):
        jfactorize_window_batched(jmats[0], options=JSolverOptions(impl="ref"))
    with pytest.raises(ValueError, match="at least one"):
        factorize_window_batched([])


def test_batched_plain_sweeps_match_a_loop():
    """The plain sweeps, the status folds and the band layout converters on
    a leading batch axis give each element's unbatched result bit for bit."""
    mats, _, _, _ = _theta_batch("partitioned", seed=2)
    Dr = torch.stack([m.Dr for m in mats])
    R = torch.stack([m.R for m in mats])
    C = torch.stack([m.C for m in mats])
    Ac = band_row_to_col(Dr)
    bounds = detect_partition_plan(*_plan_inputs()).boundaries
    fused = ref.band_cholesky_sweep_ref(Ac, R, nchunks=3, start_tile=2)
    part = ref.band_cholesky_partitioned_sweep_ref(Ac, R, bounds, start_tile=2)
    for i in range(B):
        assert torch.equal(Ac[i], band_row_to_col(Dr[i]))
        assert torch.equal(band_col_to_row(Ac)[i], band_col_to_row(Ac[i]))
        one = ref.band_cholesky_sweep_ref(Ac[i], R[i], nchunks=3, start_tile=2)
        assert all(torch.equal(a[i], b) for a, b in zip(fused, one))
        one = ref.band_cholesky_partitioned_sweep_ref(Ac[i], R[i], bounds, start_tile=2)
        assert all(torch.equal(a[i], b) for a, b in zip(part, one))
        assert torch.equal(ref.sweep_status(fused[0], fused[1])[i],
                           ref.sweep_status(fused[0][i], fused[1][i]))
        c_bad = C[i].clone()
        c_bad[0, 0] = float("nan")
        cs = torch.stack([C[j] if j != i else c_bad for j in range(B)])
        ndt, nat = Dr.shape[1], R.shape[2]
        assert torch.equal(fold_corner_status(fused[3], cs, ndt, nat)[i],
                           fold_corner_status(fused[3][i], c_bad, ndt, nat))
    words = torch.tensor([[[2.0, 0.0, -1.0], [0.5, 1.0, 7.0]], [[1.5, 0.0, 3.0], [3.0, 0.0, -1.0]]])
    folded = ref.combine_sweep_status(words)
    for i in range(2):
        assert torch.equal(folded[i], ref.combine_sweep_status(words[i]))


def _plan_inputs():
    A, st, _ = block_separable_arrowhead(120, 6, 8, 8, n_parts=3, seed=2)
    return A, st, 8
