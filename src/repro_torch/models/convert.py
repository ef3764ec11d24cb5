"""Carrying parameters across: the reference's parameter pytree, as numpy
arrays, into the port's dict of tensors and back, with the same names,
shapes and ``(d_in, d_out)`` layouts; and :class:`ParamTree`, such a dict
as an ``nn.Module``.

Both packages enumerate leaves in the order ``jax.tree_util`` visits them
(dict keys sorted) under the same ``"layers/attn/wq"`` paths
(:mod:`repro_torch.pytree`): ``optim/arrowhead.py::build_precond`` draws
each leaf's sample coordinates in that order from one seeded generator, so
the order is what makes the port's plans equal the reference's.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch
from torch import nn

from repro_torch import pytree

__all__ = ["params_from_numpy", "params_to_numpy", "ParamTree", "LMModule"]


def params_from_numpy(tree, device=None) -> Dict[str, Any]:
    """The port's parameters from a nested dict of array-likes (the
    reference's params through ``np.asarray``), copied, in their own
    dtype, on ``device`` (None: kept on the host)."""
    return pytree.tree_map(lambda x: torch.from_numpy(np.array(x, copy=True)).to(device), tree)


def params_to_numpy(params) -> Dict[str, Any]:
    """The port's parameters as a nested dict of numpy arrays (float32
    stays float32), for the reference or for storage."""
    return pytree.tree_map(lambda t: t.detach().cpu().numpy(), params)


class ParamTree(nn.Module):
    """A nested dict of tensors as an ``nn.Module``: each tensor an
    ``nn.Parameter`` sharing its storage, each dict a submodule, under the
    dict's names (``named_parameters()`` gives ``layers.attn.wq``, a
    module's own tensors before its submodules').  :meth:`tree` gives the
    dict back; walked by :mod:`repro_torch.pytree` it is in the reference's
    leaf order."""

    def __init__(self, tree: Dict[str, Any]):
        super().__init__()
        self._keys = sorted(tree)
        for k in self._keys:
            v = tree[k]
            if isinstance(v, dict):
                self.add_module(k, ParamTree(v))
            else:
                self.register_parameter(k, v if isinstance(v, nn.Parameter) else nn.Parameter(v))

    def tree(self) -> Dict[str, Any]:
        """The parameters as a nested dict (the module's own tensors)."""
        return {k: (getattr(self, k).tree() if isinstance(getattr(self, k), ParamTree)
                    else getattr(self, k)) for k in self._keys}


class LMModule(nn.Module):
    """A model family as an ``nn.Module``: its parameters (a dict of the
    family's ``init`` or one converted from the reference) registered in the
    reference's leaf order through :class:`ParamTree`, and the registry's
    entry points for its family (``models/registry.py::get_model``) bound to
    its config: ``forward`` is ``loss``, ``prefill`` takes the batch dict."""

    def __init__(self, cfg, run, params: Dict[str, Any]):
        super().__init__()
        self.cfg, self.run = cfg, run
        self.tree = ParamTree(params)

    def params(self) -> Dict[str, Any]:
        return self.tree.tree()

    def _api(self):
        from .registry import get_model     # the registry imports every family's module
        return get_model(self.cfg)

    def forward(self, batch):
        return self._api().loss(self.params(), batch, self.cfg, self.run)

    def prefill(self, batch):
        return self._api().prefill(self.params(), batch, self.cfg, self.run)

    def decode_step(self, caches, token, pos: int):
        return self._api().decode_step(self.params(), caches, token, pos, self.cfg, self.run)
