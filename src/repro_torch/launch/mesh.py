"""Device meshes over a ``torch.distributed`` world, and a local launcher
of ranks.

``make_production_mesh`` keeps the reference's shapes and axis names: one
pod of 16 x 16 = 256 devices (``data`` x ``model``), or 2 pods x 256 with
a leading ``pod`` axis.  ``make_local_mesh`` is a ``data`` x ``model``
mesh over the world this process belongs to (tests, examples, one host).
Both are :class:`torch.distributed.device_mesh.DeviceMesh` objects, the
counterpart of the reference's ``jax.sharding.Mesh``: an axis name gives
the process group of that dimension (``mesh.get_group("model")``), which
is what the collectives (``sharding/collectives.py``) take in place of an
axis name inside ``shard_map``.  Neither function touches any device
state when this module is imported.

:func:`run_local` runs a function on ``world_size`` ranks spawned on this
host, each in its own process of a fresh process group: the counterpart
of ``tests/_mdev.py``'s forced XLA device count for the reference.  Its
ranks meet through a ``FileStore`` in a new temporary directory, so no
port is chosen and two launches never meet; a rank that raises or hangs
fails the launch with its traceback.

:func:`local_world` makes this process a world of one when no process
group is initialized (``launch/train.py::train``), and :func:`fake_world`
a world of N ranks in this one process over the ``fake`` backend, whose
collectives move nothing (``sharding/collectives.py`` records them): the
dry run's stand-in for the reference's 512 forced host devices
(``launch/dryrun.py``).  A fake world is only ever this explicit one.

Port of the JAX package's ``launch/mesh.py`` (the launcher is the port's
own: a JAX process sees all its devices, a torch rank is a process).
"""
from __future__ import annotations

import contextlib
import datetime
import math
import multiprocessing
import os
import tempfile
import time
import traceback
from typing import Any, Callable, List, Optional, Sequence

import torch
import torch.distributed as dist

__all__ = ["PRODUCTION_SHAPES", "make_production_mesh", "make_local_mesh", "run_local",
           "local_world", "fake_world"]


def _device_type(device_type: Optional[str]) -> str:
    """``device_type``, or the world's: ``cuda`` on an NCCL world, else ``cpu``."""
    if device_type is not None:
        return device_type
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def _mesh(shape: Sequence[int], names: Sequence[str], device_type: Optional[str]):
    from torch.distributed.device_mesh import init_device_mesh
    if not dist.is_initialized():
        raise RuntimeError("a mesh needs an initialized process group "
                           "(torch.distributed.init_process_group, or run_local)")
    if dist.get_world_size() != math.prod(shape):
        raise ValueError(f"a {tuple(shape)} mesh {tuple(names)} needs a world of "
                         f"{math.prod(shape)} ranks, got {dist.get_world_size()}")
    return init_device_mesh(_device_type(device_type), tuple(shape),
                            mesh_dim_names=tuple(names))


# the production mesh's shape, single pod (False) and multi-pod (True)
PRODUCTION_SHAPES = {False: (16, 16), True: (2, 16, 16)}


def make_production_mesh(*, multi_pod: bool = False, device_type: Optional[str] = None):
    """The production mesh: ``(16, 16)`` over ``("data", "model")``, or
    ``(2, 16, 16)`` over ``("pod", "data", "model")``; raises unless the
    world has exactly that many ranks."""
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _mesh(PRODUCTION_SHAPES[multi_pod], axes, device_type)


def make_local_mesh(data: int = 1, model: int = 1, *, device_type: Optional[str] = None):
    """A ``(data, model)`` mesh over the initialized world, which must have
    ``data * model`` ranks.  ``device_type`` defaults to ``cuda`` on an
    NCCL world and ``cpu`` otherwise; a gloo world sharing one card keeps
    ``cpu``, and the collectives stage its CUDA tensors through host
    memory."""
    return _mesh((data, model), ("data", "model"), device_type)


@contextlib.contextmanager
def local_world():
    """This process's world: the initialized one, else, for the block, a
    gloo world of one rank (a ``FileStore`` in a new temporary directory),
    destroyed after it."""
    if dist.is_initialized():
        yield
        return
    with tempfile.TemporaryDirectory(prefix="repro_torch_world_") as tmp:
        dist.init_process_group("gloo", store=dist.FileStore(os.path.join(tmp, "store"), 1),
                                rank=0, world_size=1)
        try:
            yield
        finally:
            dist.destroy_process_group()


@contextlib.contextmanager
def fake_world(world_size: int, rank: int = 0):
    """For the block, a world of ``world_size`` ranks in this process over
    the ``fake`` backend (``torch.testing._internal.distributed.fake_pg``):
    this process is rank ``rank``, and every collective on it goes through
    the collectives' fake transport.  Raises if a group is already
    initialized."""
    if dist.is_initialized():
        raise RuntimeError("fake_world needs a process with no process group")
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=rank, world_size=world_size)
    try:
        yield
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# Local launcher
# ---------------------------------------------------------------------------

def _to_cpu(x: Any) -> Any:
    """``x`` with every tensor in it (through tuples, lists and dicts)
    moved to the CPU."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu()
    if isinstance(x, (list, tuple)):
        return type(x)(_to_cpu(v) for v in x)
    if isinstance(x, dict):
        return {k: _to_cpu(v) for k, v in x.items()}
    return x


def _rank_main(fn: Callable, args: tuple, rank: int, world_size: int, backend: str,
               device_type: str, timeout: float, tmp: str) -> None:
    """One rank of :func:`run_local`: join the group, run ``fn(*args)``,
    save its result (or the traceback) under ``tmp``."""
    torch.set_num_threads(1)
    try:
        if device_type == "cuda":
            torch.cuda.set_device(rank % torch.cuda.device_count())
        dist.init_process_group(
            backend, store=dist.FileStore(os.path.join(tmp, "store"), world_size),
            rank=rank, world_size=world_size,
            timeout=datetime.timedelta(seconds=timeout))
        try:
            out = fn(*args)
        finally:
            dist.destroy_process_group()
        torch.save(_to_cpu(out), os.path.join(tmp, f"result{rank}.pt"))
    except BaseException:
        with open(os.path.join(tmp, f"error{rank}.txt"), "w") as f:
            f.write(traceback.format_exc())
        raise


def run_local(fn: Callable, *args, world_size: int, backend: str = "gloo",
              device_type: str = "cpu", timeout: float = 120.0) -> List[Any]:
    """Run ``fn(*args)`` on ``world_size`` ranks, one spawned process each,
    in a process group of ``backend`` (``gloo`` or ``nccl``) with
    ``timeout`` seconds on every collective; returns each rank's result,
    in rank order, with every tensor in it moved to the CPU.

    ``fn`` and ``args`` are pickled to the ranks (``fn`` by its import
    path: a module-level function); a rank finds its rank and the group
    through ``torch.distributed``.  Each rank runs one CPU thread and, with
    ``device_type="cuda"``, on card ``rank % device_count`` (every rank on
    the one card of a one-card host: share it over ``gloo``; NCCL refuses
    two ranks on one device).  A rank that raises, or a launch that
    outlasts ``timeout`` plus a start-up allowance, stops every rank and
    raises ``RuntimeError`` with the ranks' tracebacks."""
    if world_size < 1:
        raise ValueError(f"world_size must be >= 1, got {world_size}")
    ctx = multiprocessing.get_context("spawn")
    with tempfile.TemporaryDirectory(prefix="repro_torch_ranks_") as tmp:
        procs = [ctx.Process(target=_rank_main, name=f"rank{r}",
                             args=(fn, args, r, world_size, backend, device_type, timeout, tmp))
                 for r in range(world_size)]
        for p in procs:
            p.start()
        # the processes' own start (an interpreter and torch each) is not
        # the collectives' time
        deadline = time.monotonic() + timeout + 60.0
        failed = hung = False
        try:
            while any(p.is_alive() for p in procs):
                if any(p.exitcode not in (None, 0) for p in procs):
                    failed = True
                    break
                if time.monotonic() > deadline:
                    hung = True
                    break
                time.sleep(0.02)
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
                p.join(10)
        failed = failed or any(p.exitcode != 0 for p in procs)
        if failed or hung:
            notes = []
            for r, p in enumerate(procs):
                err = os.path.join(tmp, f"error{r}.txt")
                what = open(err).read() if os.path.exists(err) else f"exit code {p.exitcode}"
                notes.append(f"--- rank {r} ---\n{what}")
            cause = f"outlasted {timeout} s" if hung else "failed"
            raise RuntimeError(f"run_local({getattr(fn, '__name__', fn)}, world_size="
                               f"{world_size}, backend={backend}) {cause}:\n" + "\n".join(notes))
        return [torch.load(os.path.join(tmp, f"result{r}.pt"), weights_only=False)
                for r in range(world_size)]
