"""Checkpointing: atomic, keep-k, async.

Port of the JAX package's ``checkpoint/checkpointer.py`` with its on-disk
layout: ``<dir>/step_<N>/arrays.npz`` + ``meta.json``, written to a temp
dir and atomically renamed (a crashed save never corrupts the latest good
checkpoint).  The arrays are keyed by the reference's leaf paths
(:mod:`repro_torch.pytree`), so a params dict (or a ``TrainState``) that
either package saved restores into the other with the same arrays.  A save
copies every leaf to the host before it returns, so the caller may go on
updating its tensors in place while the writer thread runs.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any, List, Optional

import numpy as np
import torch

from repro_torch import pytree

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
        os.makedirs(directory, exist_ok=True)

    # ---- save ---------------------------------------------------------------

    def save(self, step: int, state: Any, meta: Optional[dict] = None,
             block: bool = False) -> None:
        self.wait()
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

        if self.async_save and not block:
            self._thread = threading.Thread(target=_write, daemon=True)
            self._thread.start()
        else:
            _write()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None

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
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, template: Any, step: Optional[int] = None) -> Any:
        """Restore into the structure of ``template``: each tensor leaf
        comes back as a new tensor on the template leaf's device and in its
        dtype (any other leaf as a numpy array of its dtype)."""
        self.wait()
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.dir}")
        path = os.path.join(self.dir, f"step_{step}", "arrays.npz")
        flat = pytree.leaves_with_path(template)
        with np.load(path) as data:
            arrays = [data[k] for k, _ in flat]
        leaves = []
        for (_, leaf), arr in zip(flat, arrays):
            if isinstance(leaf, torch.Tensor):
                leaves.append(torch.from_numpy(arr).to(device=leaf.device, dtype=leaf.dtype))
            else:
                leaves.append(arr.astype(np.asarray(leaf).dtype))
        return pytree.unflatten(template, leaves)

    def meta(self, step: Optional[int] = None) -> dict:
        step = step if step is not None else self.latest_step()
        with open(os.path.join(self.dir, f"step_{step}", "meta.json")) as f:
            return json.load(f)
