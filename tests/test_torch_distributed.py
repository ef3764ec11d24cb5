"""The port's ``core/distributed.py`` against the JAX package's, on the
CPU: ``partition_banded`` exactly (its refusals with the reference's
messages), and ``distributed_factorize`` + ``assemble_factor`` on gloo
worlds of 1, 2 and 4 ranks (``launch/mesh.py::run_local``, the plain
versions) on ``make_arrowhead(16*16 + 16, 16, 16, rho=0.0, seed=3)`` at
t = 16 in 4 partitions: within 1e-5 relative of the reference's
``distributed_factorize`` on a one-device mesh in this process and within
1e-4 of dense numpy (the reference's gate); the panels and arrow rows bit
for bit the port's ``factorize_window`` of the whole matrix, the corner the
same bits on every rank; a rank's launches: one sweep for its partitions,
log2(world) geadd, the corner's potrf and trsm."""
import numpy as np
import pytest
import torch

import _torch_ranks
import repro.core as J
from repro.core import distributed as jdistributed
from repro_torch.core import BandedCTSF, SolverOptions, TileGrid, factorize_window
from repro_torch.core.distributed import distributed_factorize, partition_banded
from repro_torch.data import make_arrowhead
from repro_torch.launch.mesh import run_local

WORLDS = [1, 2, 4]
PARTS = 4
T = 16


def _pair(rho, seed):
    A, st = make_arrowhead(16 * 16 + 16, 16, 16, rho=rho, seed=seed)
    jgrid = J.TileGrid(J.ArrowheadStructure(n=st.n, bandwidth=st.bandwidth, arrow=st.arrow), T)
    return (BandedCTSF.from_sparse(A, TileGrid(st, T), device="cpu"),
            J.BandedCTSF.from_sparse(A, jgrid), A)


@pytest.fixture(scope="module")
def problem():
    return _pair(0.0, 3)


@pytest.fixture(scope="module")
def reference(problem):
    """The reference's factor on a one-device ``(1, 1)`` mesh, assembled."""
    import jax
    from jax.sharding import Mesh
    _, jm, _ = problem
    mesh = Mesh(np.array(jax.devices()[:1]).reshape(1, 1), ("data", "model"))
    out = jdistributed.distributed_factorize(jdistributed.partition_banded(jm, PARTS), mesh,
                                             axis="model")
    f = jdistributed.assemble_factor(out, jm.grid)
    return [np.asarray(x) for x in (f.ctsf.Dr, f.ctsf.R, f.ctsf.C)]


@pytest.fixture(scope="module")
def ranks(problem):
    """Each world's ranks' results on a ``(1, world)`` mesh's ``model``
    axis, one spawn a world."""
    m = problem[0]
    return {w: run_local(_torch_ranks.distributed, m, PARTS, (1, w), "model", world_size=w,
                         timeout=120) for w in WORLDS}


@pytest.mark.parametrize("n_parts", [1, 2, 4, 8])
def test_partition_banded_matches_reference(problem, n_parts):
    m, jm, _ = problem
    pm = partition_banded(m, n_parts)
    jpm = jdistributed.partition_banded(jm, n_parts)
    assert pm.n_parts == jpm.n_parts == n_parts
    assert (pm.grid.n_diag_tiles, pm.grid.band_tiles, pm.grid.n_arrow_tiles, pm.grid.t) == (
        jpm.grid.n_diag_tiles, jpm.grid.band_tiles, jpm.grid.n_arrow_tiles, jpm.grid.t)
    for a, b in zip((pm.Dr, pm.R, pm.C), (jpm.Dr, jpm.R, jpm.C)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_partition_banded_refuses_coupled_bands_and_uneven_splits():
    m, jm, _ = _pair(0.7, 0)                   # coupled across every boundary
    for part, mat in ((partition_banded, m), (jdistributed.partition_banded, jm)):
        with pytest.raises(ValueError, match="crosses partition boundary 8; reorder"):
            part(mat, 2)
        with pytest.raises(ValueError, match="n_diag_tiles=16 not divisible by 3"):
            part(mat, 3)


def test_distributed_factorize_refuses_what_it_cannot_honour(problem):
    pm = partition_banded(problem[0], PARTS)
    with pytest.raises(TypeError, match="DeviceMesh"):
        distributed_factorize(pm, "model")
    with pytest.raises(ValueError, match="options.impl only"):
        distributed_factorize(pm, None, options=SolverOptions(regularize=True))


@pytest.mark.parametrize("world", WORLDS)
def test_assembled_factor_matches_reference_and_dense(ranks, reference, problem, world):
    m, _, A = problem
    Lref = np.tril(np.linalg.cholesky(A.toarray().astype(np.float64)))
    for o in ranks[world]:
        for got, want in zip(o["full"], reference):
            scale = np.abs(want).max()
            np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5 * scale)
        f = BandedCTSF(m.grid, *o["full"])
        L = f.to_dense(lower_only=True)[:A.shape[0], :A.shape[0]]
        assert np.abs(L - Lref).max() < 1e-4


@pytest.mark.parametrize("world", WORLDS)
def test_panels_are_the_whole_matrix_factor_bit_for_bit(ranks, problem, world):
    """Block independence: every partition's panels and arrow rows are the
    fused factorization's of the whole matrix, whatever the world; the
    corner's Schur sum is added in another order."""
    f = factorize_window(problem[0])
    per = PARTS // world
    for r, o in enumerate(ranks[world]):
        assert o["first"] == r * per
        assert torch.equal(o["full"][0], f.ctsf.Dr) and torch.equal(o["full"][1], f.ctsf.R)
        lo, hi = r * per * 4, (r + 1) * per * 4      # 4 diagonal tiles a partition
        assert torch.equal(o["Dr"].reshape(-1, *o["Dr"].shape[2:]), f.ctsf.Dr[lo:hi])
        np.testing.assert_allclose(o["C"].numpy(), f.ctsf.C.numpy(), rtol=0,
                                   atol=1e-5 * float(f.ctsf.C.abs().max()))


@pytest.mark.parametrize("world", WORLDS)
def test_corner_is_the_same_bits_on_every_rank(ranks, world):
    outs = ranks[world]
    assert all(torch.equal(o["C"], outs[0]["C"]) for o in outs)
    assert all(torch.equal(o["full"][2], outs[0]["full"][2]) for o in outs)


@pytest.mark.parametrize("world", WORLDS)
def test_launches_of_a_rank(ranks, world):
    # one sweep for the rank's partitions, log2(world) geadd, the corner's
    # one tile: potrf and trsm once each
    want = {"band_cholesky_sweep": 1, "potrf": 1, "trsm": 1}
    if world > 1:
        want["geadd"] = world.bit_length() - 1
    for o in ranks[world]:
        assert o["launches"] == want


@pytest.mark.parametrize("world", [2, 4])
def test_refusals_on_a_rank(ranks, world):
    for o in ranks[world]:
        odd, not_a_mesh = o["errors"]
        assert odd == f"ValueError: n_parts={world + 1} not divisible by mesh axis model={world}"
        assert not_a_mesh.startswith("TypeError: mesh must be a torch.distributed")

