"""The port's factorization slice against the JAX package, on the CPU:
``BandedCTSF.from_sparse`` -> ``factorize_window`` -> ``logdet``.

The factor is held to ``repro``'s ``factorize_window`` with
``impl="ref"`` at rtol = atol = 2e-4 and its log-determinant at a relative
1e-5 (float32 on both sides, different summation orders), and to
``numpy.linalg.cholesky`` of the dense matrix."""
import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import BandedCTSF as JBandedCTSF
from repro.core import SolverOptions as JSolverOptions
from repro.core import TileGrid as JTileGrid
from repro.core import factorize_window as jfactorize_window
from repro.core import logdet as jlogdet
from repro.core import measure_arrowhead as jmeasure_arrowhead
from repro.core.cholesky import CholeskyFactor as JCholeskyFactor
from repro.data import make_arrowhead as jmake_arrowhead
from repro_torch.core import (BandedCTSF, SolverOptions, TileGrid, factorize_window,
                              logdet, measure_arrowhead)
from repro_torch.data import make_arrowhead, table2_matrix
from repro_torch.kernels.band_cholesky import band_cholesky_sweep_cuda
from repro_torch.kernels.potrf import potrf_cuda
from repro_torch.kernels.trsm import trsm_cuda

TOL = dict(rtol=2e-4, atol=2e-4)
# (n, bandwidth, arrow, t): single tile, bt=0 with an arrow, nat=0, thick
# arrow and wide band, a deep band of small tiles, and t = 32 / 64
GRIDS = [(16, 4, 0, 16), (30, 6, 14, 16), (160, 8, 0, 16), (130, 40, 30, 16),
         (96, 40, 16, 8), (200, 40, 40, 32), (300, 70, 70, 64)]
SRC = Path(__file__).resolve().parents[1] / "src"


def _pair(n, bw, ar, t, seed=0):
    """The same matrix in both packages, from each one's own from_sparse."""
    ja, js = jmake_arrowhead(n, bw, ar, rho=0.6, seed=seed)
    ta, ts = make_arrowhead(n, bw, ar, rho=0.6, seed=seed)
    jm = JBandedCTSF.from_sparse(ja, JTileGrid(js, t=t))
    tm = BandedCTSF.from_sparse(ta, TileGrid(ts, t=t), device="cpu")
    return jm, tm


@pytest.mark.parametrize("n,bw,ar,t", GRIDS)
def test_from_sparse_tiles_bit_identical(n, bw, ar, t):
    """Filling tiles straight from the COO entries gives exactly the tiles
    the reference slices out of its dense padded matrix."""
    jm, tm = _pair(n, bw, ar, t)
    for name in ("Dr", "R", "C"):
        np.testing.assert_array_equal(getattr(tm, name).numpy(),
                                      np.asarray(getattr(jm, name)), err_msg=name)
    np.testing.assert_array_equal(tm.to_dense(lower_only=False),
                                  jm.to_dense(lower_only=False))
    # and the port's own dense-slicing constructor agrees with it
    dm = BandedCTSF.from_dense_padded(jm.to_dense(lower_only=False).astype(np.float64),
                                      tm.grid, device="cpu")
    for name in ("Dr", "R", "C"):
        torch.testing.assert_close(getattr(dm, name), getattr(tm, name), rtol=0, atol=0)


def test_from_sparse_table2_scaled():
    """A scaled Table II matrix with a measured (not requested) structure."""
    A, st = table2_matrix(5, scale=0.03, seed=0)
    grid = TileGrid(measure_arrowhead(A, arrow_hint=st.arrow), t=16)
    jm = JBandedCTSF.from_sparse(A, JTileGrid(jmeasure_arrowhead(A, arrow_hint=st.arrow), t=16))
    tm = BandedCTSF.from_sparse(A, grid, device="cpu")
    for name in ("Dr", "R", "C"):
        np.testing.assert_array_equal(getattr(tm, name).numpy(), np.asarray(getattr(jm, name)))


@pytest.mark.parametrize("n,bw,ar,t", GRIDS)
@pytest.mark.parametrize("tree_chunks", [1, 8])
def test_factorize_window_matches_reference(n, bw, ar, t, tree_chunks):
    jm, tm = _pair(n, bw, ar, t)
    jf = jfactorize_window(jm, tree_chunks=tree_chunks,
                           options=JSolverOptions(impl="ref")).ctsf
    tf = factorize_window(tm, tree_chunks=tree_chunks)
    for name in ("Dr", "R", "C"):
        np.testing.assert_allclose(getattr(tf.ctsf, name).numpy(),
                                   np.asarray(getattr(jf, name)), err_msg=name, **TOL)
    want = float(jlogdet(JCholeskyFactor(jf)))
    got = float(logdet(tf))
    assert abs(got - want) <= 1e-5 * abs(want)


@pytest.mark.parametrize("n,bw,ar,t", GRIDS)
def test_factorize_window_matches_dense_cholesky(n, bw, ar, t):
    _, tm = _pair(n, bw, ar, t, seed=1)
    dense = tm.to_dense(lower_only=False).astype(np.float64)
    L = np.linalg.cholesky(dense)
    f = factorize_window(tm)
    np.testing.assert_allclose(f.ctsf.to_dense(), L, rtol=2e-4, atol=2e-4)
    ld = float(f.logdet())
    want = 2.0 * np.log(np.diag(L)).sum()
    assert abs(ld - want) <= 1e-5 * abs(want)


def test_from_arrays_round_trip():
    """The reference's arrays carried over give the same matrix, the same
    grid and the same factor."""
    jm, tm = _pair(130, 40, 30, 16)
    s = jm.grid.structure
    for grid in ((s.n, s.bandwidth, s.arrow, jm.grid.t), tm.grid):
        cm = BandedCTSF.from_arrays(grid, np.asarray(jm.Dr), np.asarray(jm.R),
                                    np.asarray(jm.C), device="cpu")
        assert cm.grid == tm.grid
        np.testing.assert_array_equal(cm.to_dense(), jm.to_dense())
    f1, f2 = factorize_window(cm), factorize_window(tm)
    for a, b in zip(f1.ctsf.arrays(), f2.ctsf.arrays()):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    with pytest.raises(ValueError, match="shape"):
        BandedCTSF.from_arrays(tm.grid, np.asarray(jm.Dr)[1:], np.asarray(jm.R),
                               np.asarray(jm.C), device="cpu")


def test_eye_factorizes_to_itself():
    grid = TileGrid.from_tile_counts(8, 5, 2, 2)
    m = BandedCTSF.eye(grid, device="cpu")
    f = factorize_window(m)
    np.testing.assert_array_equal(f.ctsf.to_dense(), np.eye(grid.padded_n, dtype=np.float32))
    assert float(f.logdet()) == 0.0


def test_default_device_is_the_card():
    """Entry points run on the card unless asked for the CPU: without a
    device, from_sparse lands on cuda:0, or raises where there is none."""
    A, st = make_arrowhead(64, 8, 4, seed=0)
    grid = TileGrid(st, t=8)
    if torch.cuda.is_available():
        assert BandedCTSF.from_sparse(A, grid).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            BandedCTSF.from_sparse(A, grid)
        with pytest.raises(RuntimeError):
            BandedCTSF.eye(grid)
    assert BandedCTSF.from_sparse(A, grid, device="cpu").device.type == "cpu"


def test_options_dispatch_on_the_cpu():
    """On CPU tensors the plain versions run and no kernel is launched; the
    kernels are never reached by a fallback, only refused."""
    _, tm = _pair(130, 40, 30, 16)
    counts = (potrf_cuda.launches, trsm_cuda.launches, band_cholesky_sweep_cuda.launches)
    f_auto = factorize_window(tm)
    f_ref = factorize_window(tm, options=SolverOptions(impl="ref"))
    for a, b in zip(f_auto.ctsf.arrays(), f_ref.ctsf.arrays()):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    torch.testing.assert_close(f_auto.status, f_ref.status, rtol=0, atol=0)
    assert (potrf_cuda.launches, trsm_cuda.launches,
            band_cholesky_sweep_cuda.launches) == counts
    with pytest.raises(ValueError, match="CUDA"):
        factorize_window(tm, options=SolverOptions(impl="cuda"))
    with pytest.raises(ValueError, match="unknown"):
        SolverOptions(impl="pallas")
    # the fused sweep is the kernel: refused with the plain versions, and on
    # CPU tensors it raises rather than falling back
    with pytest.raises(ValueError, match="contradicts"):
        SolverOptions(sweep="fused", impl="ref")
    with pytest.raises(ValueError, match="CUDA"):
        factorize_window(tm, options=SolverOptions(sweep="fused"))


@pytest.mark.parametrize("where,first_bad", [("band", 3.0), ("corner", None)])
def test_breakdown_is_reported_not_raised(where, first_bad):
    """An indefinite matrix factorizes to a non-finite factor, as the
    reference does, and the factor's status word says where: the band
    column of the bad tile, or ``ndt`` for the corner.  The word matches
    the reference's ``[min_pivot, nonfinite, first_bad]`` fold."""
    from repro.core.cholesky import _factorize_window_impl as j_impl
    jm, tm = _pair(130, 40, 30, 16)
    ndt = tm.grid.n_diag_tiles
    Dr, C = tm.Dr.clone(), tm.C.clone()
    if where == "band":
        Dr[3, 0] -= 1e3 * torch.eye(16)
    else:
        C[1, 1] -= 1e3 * torch.eye(16)
        first_bad = float(ndt)
    bad = BandedCTSF(tm.grid, Dr, tm.R, C)
    f = factorize_window(bad)
    assert f.status.shape == (3,) and f.status.dtype == torch.float32
    assert f.status[1].item() == 1.0 and f.status[2].item() == first_bad
    assert not bool(torch.isfinite(f.ctsf.C).all())
    *_, jstatus = j_impl(jnp.asarray(Dr.numpy()), jm.R, jnp.asarray(C.numpy()), jm.grid,
                         "ref", 8)
    np.testing.assert_array_equal(f.status[1:].numpy(), np.asarray(jstatus)[1:])
    clean = factorize_window(tm).status
    assert clean[1].item() == 0.0 and clean[2].item() == -1.0 and clean[0].item() > 0


def test_port_never_loads_jax():
    """A fresh interpreter that imports the port, factorizes, solves and
    inverts on the CPU never imports jax (nor the JAX package)."""
    code = (
        "import sys\n"
        "from repro_torch.core import BandedCTSF, TileGrid, factorize_window, logdet\n"
        "from repro_torch.core import marginal_variances, selected_inverse, solve_many\n"
        "from repro_torch.data import make_arrowhead\n"
        "import repro_torch.kernels.ops, repro_torch.kernels._build\n"
        "import repro_torch.core.solve, repro_torch.core.selinv\n"
        "import repro_torch.kernels.band_solve, repro_torch.kernels.selinv\n"
        "import repro_torch.kernels.gemm, repro_torch.core.tree_reduction\n"
        "import repro_torch.kernels.band_update\n"
        "import repro_torch.data.synthetic, repro_torch.quickstart\n"
        "from repro_torch.core import (SolverOptions, TileMatrix, detect_partition_plan,\n"
        "                              factorize_tasklist)\n"
        "from repro_torch.data import block_separable_arrowhead\n"
        "import torch\n"
        "A, st = make_arrowhead(200, 24, 16, seed=0)\n"
        "f = factorize_window(BandedCTSF.from_sparse(A, TileGrid(st, t=16), device='cpu'))\n"
        "assert float(logdet(f)) > 0\n"
        "tm = TileMatrix.from_sparse(A, TileGrid(st, t=16), device='cpu')\n"
        "assert factorize_tasklist(tm, tree_reduction=True, tree_workers=4).shape[0] == tm.n_alloc\n"
        "B, bs, bounds = block_separable_arrowhead(100, 5, 4, 8, n_parts=4)\n"
        "plan = detect_partition_plan(B, bs, 8)\n"
        "assert plan.n_partitions == 4\n"
        "fp = factorize_window(BandedCTSF.from_sparse(B, TileGrid(bs, t=8), device='cpu'),\n"
        "                      options=SolverOptions(partition_plan=plan))\n"
        "assert float(logdet(fp)) > 0\n"
        "from repro_torch.core import factorize_window_batched\n"
        "m = BandedCTSF.from_sparse(A, TileGrid(st, t=16), device='cpu')\n"
        "fw = factorize_window(m, options=SolverOptions(sweep='window'))\n"
        "assert factorize_window_batched([m, m], options=SolverOptions(sweep='window'))"
        ".logdet().shape == (2,)\n"
        "x = solve_many(f, torch.ones(f.ctsf.grid.padded_n, 2))\n"
        "assert float(selected_inverse(f).diagonal().min()) > 0\n"
        "assert float(marginal_variances(f, [0, 199]).min()) > 0\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'repro.'))"
        " or m == 'repro']\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=dict(os.environ, PYTHONPATH=str(SRC)),
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
