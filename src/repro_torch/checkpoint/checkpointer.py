"""Checkpointing: atomic, keep-k, async.

Port of the JAX package's ``checkpoint/checkpointer.py`` with its on-disk
layout: ``<dir>/step_<N>/arrays.npz`` + ``meta.json``, written to a temp
dir and atomically renamed (a crashed save never corrupts the latest good
checkpoint).  The arrays are keyed by the reference's leaf paths
(:mod:`repro_torch.pytree`), so a params dict (or a ``TrainState``) that
either package saved restores into the other with the same arrays.  A save
copies every leaf to the host before it returns, so the caller may go on
updating its tensors in place while the writer thread runs.

A sharded state (``shardings=``, a tree of ``sharding/partition.py``'s
``NamedSharding`` shaped like the state) is gathered to full on every
rank (the gather is collective, so every rank calls ``save``) and written
once, by rank 0 of the world, in the writer thread as any other save (the
other ranks return at once), or before ``save`` returns where the save is
synchronous (``block``, or ``async_save=False``).  In a world of more than
one rank every rank meets rank 0 at a barrier after rank 0's write: at once
in a synchronous save, else in its next :meth:`Checkpointer.wait` (the
next save's, a restore's, ``latest_step``'s), so no rank reads a checkpoint
before it is whole and no two writes race at the rename.
``restore(shardings=)`` places this rank's blocks of each leaf by the
target shardings, which may be of another mesh than the save's: the
reference's elastic restore.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any, List, Optional

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import pytree
from repro_torch.sharding.partition import gather_tree, shard_tensor

__all__ = ["Checkpointer"]


def _host(leaf) -> np.ndarray:
    """A host copy of ``leaf`` that later in-place updates do not reach (a
    CPU tensor's ``numpy()`` is a view of it)."""
    if isinstance(leaf, torch.Tensor):
        arr = leaf.detach().cpu().numpy()
        return arr.copy() if leaf.device.type == "cpu" else arr
    return np.array(leaf)


class Checkpointer:
    def __init__(self, directory: str, keep: int = 3, async_save: bool = True):
        self.dir = directory
        self.keep = keep
        self.async_save = async_save
        self._thread: Optional[threading.Thread] = None
        self._barrier = False        # a sharded save's barrier, still to meet
        os.makedirs(directory, exist_ok=True)

    # ---- save ---------------------------------------------------------------

    def save(self, step: int, state: Any, meta: Optional[dict] = None,
             block: bool = False, shardings: Optional[Any] = None) -> None:
        """Write ``state`` as step ``step``; with ``shardings`` every rank
        of the world calls it (the gather is collective), rank 0 writes."""
        self.wait()
        sync = block or not self.async_save
        if shardings is not None:
            state = gather_tree(state, shardings)
            self._barrier = dist.get_world_size() > 1
            if dist.get_rank() != 0:
                if sync:
                    self.wait()
                return
        flat = {k: _host(v) for k, v in pytree.leaves_with_path(state)}

        def _write():
            tmp = os.path.join(self.dir, f".tmp_step_{step}")
            final = os.path.join(self.dir, f"step_{step}")
            if os.path.exists(tmp):
                shutil.rmtree(tmp)
            os.makedirs(tmp)
            np.savez(os.path.join(tmp, "arrays.npz"), **flat)
            with open(os.path.join(tmp, "meta.json"), "w") as f:
                json.dump({"step": step, **(meta or {})}, f)
            if os.path.exists(final):
                shutil.rmtree(final)
            os.rename(tmp, final)
            self._gc()

        if not sync:
            self._thread = threading.Thread(target=_write, daemon=True)
            self._thread.start()
        else:
            _write()
            self.wait()

    def wait(self):
        """Until this rank's save is written, and, after a sharded save in
        a world of more than one rank, until every rank has come here."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._barrier:
            self._barrier = False
            dist.barrier()

    def _gc(self):
        steps = self.all_steps()
        for s in steps[: -self.keep] if self.keep else []:
            shutil.rmtree(os.path.join(self.dir, f"step_{s}"), ignore_errors=True)

    # ---- restore -------------------------------------------------------------

    def all_steps(self) -> List[int]:
        out = []
        for name in os.listdir(self.dir):
            if name.startswith("step_"):
                try:
                    out.append(int(name.split("_")[1]))
                except ValueError:
                    pass
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        self.wait()
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, template: Any, step: Optional[int] = None,
                shardings: Optional[Any] = None) -> Any:
        """Restore into the structure of ``template``: each tensor leaf
        comes back as a new tensor on the template leaf's device and in its
        dtype (any other leaf as a numpy array of its dtype); with
        ``shardings`` (the template's structure) as this rank's block of
        the saved full array."""
        self.wait()
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.dir}")
        path = os.path.join(self.dir, f"step_{step}", "arrays.npz")
        flat = pytree.leaves_with_path(template)
        with np.load(path) as data:
            arrays = [data[k] for k, _ in flat]
        shs = pytree.leaves(shardings) if shardings is not None else [None] * len(flat)
        leaves = []
        for (_, leaf), arr, sh in zip(flat, arrays, shs):
            if isinstance(leaf, torch.Tensor):
                x = torch.from_numpy(arr)
                if sh is not None:
                    x = shard_tensor(x, sh)
                leaves.append(x.to(device=leaf.device, dtype=leaf.dtype))
            else:
                leaves.append(arr.astype(np.asarray(leaf).dtype))
        return pytree.unflatten(template, leaves)

    def meta(self, step: Optional[int] = None) -> dict:
        step = step if step is not None else self.latest_step()
        with open(os.path.join(self.dir, f"step_{step}", "meta.json")) as f:
            return json.load(f)
