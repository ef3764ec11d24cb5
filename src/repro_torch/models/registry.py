"""Unified model API over the architecture families.

Every family exposes ``init(gen, cfg, max_seq)``, ``loss(params, batch,
cfg, run)``, ``prefill(params, batch, cfg, run)``, ``decode_step(params,
caches, token, pos, cfg, run)`` and ``init_cache(cfg, batch, max_len)``,
resolved here by ``cfg.family``, as in the JAX package's
``models/registry.py``.  The dense and vlm families run; the others raise
``NotImplementedError`` naming the module they wait for.  ``input_specs``
and ``supports_shape`` come with the dry run (``launch/dryrun.py``).
"""
from __future__ import annotations

import dataclasses
from typing import Callable

from repro_torch.configs.base import ModelConfig
from . import transformer

__all__ = ["ModelAPI", "get_model"]


@dataclasses.dataclass(frozen=True)
class ModelAPI:
    init: Callable
    loss: Callable
    prefill: Callable
    decode_step: Callable
    init_cache: Callable


def _transformer_api() -> ModelAPI:
    def _init(gen, cfg, max_seq=0):
        return transformer.init(gen, cfg)

    def _prefill(params, batch, cfg, run):
        if isinstance(batch, dict):
            return transformer.prefill(params, batch["tokens"], cfg, run,
                                       image_embeds=batch.get("image_embeds"))
        return transformer.prefill(params, batch, cfg, run)

    return ModelAPI(_init, transformer.loss, _prefill, transformer.decode_step,
                    transformer.init_cache)


_FAMILIES = {"dense": _transformer_api, "vlm": _transformer_api}
_NOT_PORTED = {"moe": "models/moe.py", "ssm": "models/mamba2.py",
               "hybrid": "models/zamba2.py", "encdec": "models/whisper.py"}


def get_model(cfg: ModelConfig) -> ModelAPI:
    if cfg.family in _NOT_PORTED:
        raise NotImplementedError(f"family {cfg.family!r} needs {_NOT_PORTED[cfg.family]}, "
                                  "which is not ported yet")
    return _FAMILIES[cfg.family]()
