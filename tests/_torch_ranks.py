"""Rank functions of the port's multi-rank tests.

``repro_torch.launch.mesh.run_local`` spawns the ranks, and each rank
imports this module by name to find its function, so it imports nothing
of jax or of the JAX package (a rank starts in a few seconds).  Each
function builds its mesh over the world ``run_local`` set up, runs the
calls under test on this rank's share and returns what the tests compare,
with the kernel launches it made (``runtime/telemetry.py::count_launches``:
on the CPU, the plain versions' calls).
"""
import dataclasses

import torch
import torch.distributed as dist

from repro_torch.core import BandedCTSF, SolverOptions
from repro_torch.core.concurrent import concurrent_factorize, concurrent_logdet, concurrent_selinv
from repro_torch.core.distributed import assemble_factor, distributed_factorize, partition_banded
from repro_torch.launch.mesh import make_local_mesh, make_production_mesh
from repro_torch.runtime.telemetry import count_launches
from repro_torch.sharding.collectives import (all_gather, quantized_allreduce, ring_allreduce,
                                              tree_allreduce)


def _errors(*calls):
    """The message of the exception each call raises (None if it does not)."""
    out = []
    for call in calls:
        try:
            call()
            out.append(None)
        except (ValueError, TypeError) as e:
            out.append(f"{type(e).__name__}: {e}")
    return out


def _on(m, device):
    return BandedCTSF(m.grid, *(x.to(device) for x in m.arrays()))


def collectives(data, qdata, device="cpu"):
    """The collectives on a ``(1, world)`` mesh's ``model`` group, this
    rank's row of ``data`` and ``qdata`` on ``device``; on a world of 4
    also the tree over each axis of a ``(2, 2)`` mesh."""
    rank, world = dist.get_rank(), dist.get_world_size()
    group = make_local_mesh(1, world).get_group("model")
    x = data[rank].to(device)
    out = {"ring": ring_allreduce(x, group),
           "quantized": quantized_allreduce(qdata[rank].to(device), group),
           "gather": all_gather(x[None], group),
           "gather_bool": all_gather((x > 0)[None], group)}
    if world & (world - 1):
        out["tree_error"] = _errors(lambda: tree_allreduce(x, group))[0]
    else:
        out["launches"] = count_launches(tree_allreduce, x, group)
        out["tree"] = tree_allreduce(x, group)
    if world == 4:
        mesh = make_local_mesh(2, 2)
        for axis in ("data", "model"):
            out[f"tree_{axis}"] = tree_allreduce(x, mesh.get_group(axis))
    return out


def distributed(m, n_parts, mesh_shape, axis, device="cpu"):
    """``partition_banded(m, n_parts)`` on ``device`` factorized over
    ``axis`` of a mesh of ``mesh_shape`` and assembled on every rank; the
    refusals of a partition count the axis does not divide and of a mesh
    that is not a ``DeviceMesh``."""
    mesh = make_local_mesh(*mesh_shape)
    pm = partition_banded(_on(m, device), n_parts)
    got = {}
    launches = count_launches(lambda: got.update(f=distributed_factorize(pm, mesh, axis)))
    f = got["f"]
    full = assemble_factor(f, m.grid)
    size = dist.get_world_size(mesh.get_group(axis))
    odd = dataclasses.replace(pm, n_parts=size + 1) if size > 1 else None
    return {"Dr": f.Dr, "R": f.R, "C": f.C, "first": f.first, "launches": launches,
            "full": full.ctsf.arrays(),
            "errors": _errors(
                lambda: distributed_factorize(odd, mesh, axis) if odd else None,
                lambda: distributed_factorize(pm, "model", axis))}


def concurrent(batch, faulted, mesh_shape, policies, device="cpu"):
    """The sharded concurrent calls on the ``data`` axis of a mesh of
    ``mesh_shape``, on ``device``, once a policy of ``policies`` (None
    among them for none): ``concurrent_factorize``, ``concurrent_logdet``,
    ``concurrent_selinv`` of the sharded factor and of the whole batched
    one; then ``regularize=True`` on ``faulted`` and the refusals of a
    batch the axis does not divide and of a factor of another axis."""
    mesh = make_local_mesh(*mesh_shape)
    batch, faulted = _on(batch, device), _on(faulted, device)
    out = {"runs": []}
    for policy in policies:
        opts = SolverOptions(policy=policy)
        got = {}
        launches = count_launches(
            lambda: got.update(f=concurrent_factorize(batch, mesh=mesh, options=opts)))
        f = got["f"]
        whole = concurrent_factorize(batch, options=opts)
        out["runs"].append({
            "offset": f.offset, "factor": f.ctsf.arrays(), "status": f.status,
            "source_grid": f.source_grid, "logdet": concurrent_logdet(f), "launches": launches,
            "sigma": concurrent_selinv(f, mesh=mesh, options=opts).arrays(),
            "sigma_whole": concurrent_selinv(whole, mesh=mesh, options=opts).arrays()})
    ff = concurrent_factorize(faulted, mesh=mesh, options=SolverOptions(regularize=True))
    i = ff.info
    out["faulted"] = {"offset": ff.offset, "status": ff.status, "factor": ff.ctsf.arrays(),
                      "info": (i.status, i.attempts, i.tau, i.min_pivot, i.first_bad_tile)}
    three = BandedCTSF(batch.grid, *(x[:3] for x in batch.arrays()))
    out["errors"] = _errors(lambda: concurrent_factorize(three, mesh=mesh),
                            lambda: concurrent_selinv(f, mesh=mesh, axis="model"))
    return out


def meshes():
    """This rank's place on a ``(1, world)`` mesh, a CPU tensor of its own,
    and the refusals of meshes of another size than the world."""
    world = dist.get_world_size()
    mesh = make_local_mesh(1, world)
    return {"rank": dist.get_rank(), "model": dist.get_rank(mesh.get_group("model")),
            "tensor": torch.full((2,), float(dist.get_rank())),
            "errors": _errors(lambda: make_local_mesh(world, 2),
                              lambda: make_production_mesh())}


def fail_on(rank):
    """Rank ``rank`` raises; the others wait at a barrier it never reaches."""
    if dist.get_rank() == rank:
        raise RuntimeError(f"rank {rank} fails on purpose")
    dist.barrier()


def strand_peers():
    """Rank 0 waits at an all-reduce that no other rank joins."""
    if dist.get_rank() == 0:
        dist.all_reduce(torch.ones(1))
