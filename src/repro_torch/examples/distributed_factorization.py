"""Distributed single-matrix factorization across the ranks of a mesh — the
paper's "future work" (App. A), built on adaptive-ND partitioning and the
GEADD-tree reduction of the corner's Schur sums.

The twin of the JAX package's ``examples/distributed_factorization.py`` on
``torch.distributed``: a block-independent banded matrix (rho = 0) with a
dense arrow is split into 4 partitions, each rank of the ``model`` axis
factorizes its partitions in one batched sweep, the GEADD butterfly sums
the Schur partials across ranks, every rank factors the corner.  The
factor is held against the dense Cholesky and against ``factorize_window``
on one device.

Where this process already belongs to a process group (one rank a card
under NCCL), it runs on that world; otherwise ``--world`` ranks are
spawned by ``launch/mesh.py::run_local`` (``gloo``; on the card every rank
shares card 0 over gloo, since NCCL takes one rank a card).  On the card
unless asked for the CPU:

    PYTHONPATH=src python -m repro_torch.examples.distributed_factorization \\
        [--world 2] [--device cpu]
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core import BandedCTSF, TileGrid, factorize_window
from repro_torch.core.distributed import (assemble_factor, distributed_factorize,
                                          partition_banded)
from repro_torch.data import make_arrowhead
from repro_torch.launch.mesh import make_local_mesh, run_local

T, PARTS = 16, 4


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def factorize_on_world(device_type: str, t: int = T, parts: int = PARTS) -> dict:
    """One rank's run (every rank of the initialized world calls it): the
    partitioned matrix factorized across a ``(1, world)`` mesh, assembled,
    and checked.  Returns what rank 0 prints."""
    dev = (torch.device("cuda", torch.cuda.current_device()) if device_type == "cuda"
           else torch.device("cpu"))
    world = dist.get_world_size()
    n = 64 * t + 2 * t
    A, struct = make_arrowhead(n, t, 2 * t, rho=0.0, seed=0)
    grid = TileGrid(struct, t=t)
    bm = BandedCTSF.from_sparse(A, grid, device=dev)
    pm = partition_banded(bm, parts)
    mesh = make_local_mesh(1, world, device_type="cuda" if dist.get_backend() == "nccl"
                           else "cpu")
    out = distributed_factorize(pm, mesh, axis="model")
    f = assemble_factor(out, grid)
    L = f.ctsf.to_dense()
    Lref = np.linalg.cholesky(bm.to_dense(lower_only=False).astype(np.float64))
    dense_err = float(np.abs(L - np.tril(Lref)).max())
    Lw = factorize_window(bm).ctsf.to_dense()
    window_rel = float(np.abs(L - Lw).max() / np.abs(Lw).max())
    # time the sharded step (a rank's sweep, the butterfly, the corner)
    distributed_factorize(pm, mesh, axis="model")
    _sync(dev)
    t0 = time.perf_counter()
    distributed_factorize(pm, mesh, axis="model")
    _sync(dev)
    return dict(world=world, backend=dist.get_backend(), n=n, t=t, partitions=parts,
                part_tiles=int(pm.Dr.shape[1]), arrow_tiles=grid.n_arrow_tiles,
                dense_max_err=dense_err, window_rel_err=window_rel,
                step_ms=(time.perf_counter() - t0) * 1e3)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--world", type=int, default=2,
                    help="ranks to spawn when this process is in no process group")
    ap.add_argument("--device", default=None,
                    help="cpu, or the card (default; ranks share card 0 over gloo)")
    args = ap.parse_args(argv)
    device_type = "cpu" if args.device == "cpu" else "cuda"
    if device_type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass --device cpu")
    if dist.is_initialized():
        res = factorize_on_world(device_type)
    else:
        res = run_local(factorize_on_world, device_type, world_size=args.world,
                        backend="gloo", device_type=device_type)[0]
    print(f"mesh: model axis of {res['world']} ranks ({res['backend']})")
    print(f"partitioned: {res['partitions']} independent diagonal blocks of "
          f"{res['part_tiles']} tiles + shared {res['arrow_tiles']}-tile corner")
    print(f"distributed factor matches dense Cholesky: max err {res['dense_max_err']:.2e}; "
          f"factorize_window: {res['window_rel_err']:.2e} relative")
    print(f"sharded factorization step: {res['step_ms']:.1f} ms "
          f"(partitions in one sweep a rank + the GEADD butterfly for the corner)")
    return res


if __name__ == "__main__":
    main()
