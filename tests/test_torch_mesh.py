"""The port's ``launch/mesh.py`` on the CPU: ``run_local`` returns each
rank's result on the CPU in rank order, and fails the launch with the
ranks' tracebacks when a rank raises or is stranded at a collective past
the process-group timeout (every rank stopped); ``make_local_mesh`` and
``make_production_mesh`` refuse a world of another size, and a mesh
without a process group."""
import time

import pytest
import torch

import _torch_ranks
from repro_torch.launch.mesh import make_local_mesh, run_local


@pytest.fixture(scope="module")
def world_of_two():
    return run_local(_torch_ranks.meshes, world_size=2, timeout=60)


def test_run_local_returns_each_ranks_result_in_rank_order(world_of_two):
    assert [o["rank"] for o in world_of_two] == [0, 1]
    assert [o["model"] for o in world_of_two] == [0, 1]
    for r, o in enumerate(world_of_two):
        assert o["tensor"].device.type == "cpu"
        assert torch.equal(o["tensor"], torch.full((2,), float(r)))


def test_meshes_refuse_a_world_of_another_size(world_of_two):
    for o in world_of_two:
        local, production = o["errors"]
        assert local == ("ValueError: a (2, 2) mesh ('data', 'model') needs a world of 4 "
                         "ranks, got 2")
        assert production.startswith("ValueError: a (16, 16) mesh ('data', 'model') needs a "
                                     "world of 256 ranks")


def test_a_mesh_needs_a_process_group():
    with pytest.raises(RuntimeError, match="initialized process group"):
        make_local_mesh(1, 1)
    with pytest.raises(ValueError, match="world_size must be >= 1"):
        run_local(_torch_ranks.fail_on, 0, world_size=0)


def test_a_rank_that_raises_fails_the_launch_with_its_traceback():
    t0 = time.monotonic()
    with pytest.raises(RuntimeError) as err:
        run_local(_torch_ranks.fail_on, 1, world_size=2, timeout=60)
    msg = str(err.value)
    assert "failed" in msg and "--- rank 1 ---" in msg and "rank 1 fails on purpose" in msg
    # the waiting peer was stopped, not left to its timeout
    assert time.monotonic() - t0 < 45


def test_a_rank_stranded_at_a_collective_fails_after_the_timeout():
    t0 = time.monotonic()
    with pytest.raises(RuntimeError) as err:
        run_local(_torch_ranks.strand_peers, world_size=2, timeout=5)
    assert "--- rank 0 ---" in str(err.value)
    assert time.monotonic() - t0 < 60
