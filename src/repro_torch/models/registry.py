"""Unified model API over the architecture families.

Every family exposes ``init(gen, cfg, max_seq)``, ``loss(params, batch,
cfg, run, constrain=None)``, ``prefill(params, batch, cfg, run,
constrain=None)``, ``decode_step(params, caches, token, pos, cfg, run,
constrain=None)`` and ``init_cache(cfg, batch, max_len)``, resolved here by
``cfg.family``, as in the JAX package's ``models/registry.py``; ``prefill``
takes the batch dict (``tokens``, and ``image_embeds`` or ``frame_embeds``
where the family reads them) or, but for whisper, the token ids alone.
``constrain`` is a split context (``sharding/split.py``): the entry point
then runs on this rank's blocks.  ``module`` is the family's ``nn.Module``
class (:func:`build_module`).  ``input_specs`` and ``supports_shape`` come
with the dry run (``launch/dryrun.py``).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig, RunConfig, ShapeConfig
from . import mamba2, transformer, whisper, zamba2

__all__ = ["ModelAPI", "get_model", "build_module", "supports_shape", "input_specs"]


@dataclasses.dataclass(frozen=True)
class ModelAPI:
    init: Callable
    loss: Callable
    prefill: Callable
    decode_step: Callable
    init_cache: Callable
    module: type


def _transformer_api() -> ModelAPI:
    def _init(gen, cfg, max_seq=0):
        return transformer.init(gen, cfg)

    def _prefill(params, batch, cfg, run, constrain=None):
        if isinstance(batch, dict):
            return transformer.prefill(params, batch["tokens"], cfg, run,
                                       image_embeds=batch.get("image_embeds"),
                                       constrain=constrain)
        return transformer.prefill(params, batch, cfg, run, constrain=constrain)

    return ModelAPI(_init, transformer.loss, _prefill, transformer.decode_step,
                    transformer.init_cache, transformer.Transformer)


def _ssm_api(module, cls) -> Callable[[], ModelAPI]:
    """mamba2 and zamba2: ``prefill`` reads the batch's tokens."""
    def api() -> ModelAPI:
        def _prefill(params, batch, cfg, run, constrain=None):
            tokens = batch["tokens"] if isinstance(batch, dict) else batch
            return module.prefill(params, tokens, cfg, run, constrain=constrain)

        return ModelAPI(module.init, module.loss, _prefill, module.decode_step,
                        module.init_cache, cls)
    return api


def _whisper_api() -> ModelAPI:
    return ModelAPI(whisper.init, whisper.loss, whisper.prefill, whisper.decode_step,
                    whisper.init_cache, whisper.Whisper)


_FAMILIES = {
    "dense": _transformer_api,
    "moe": _transformer_api,
    "vlm": _transformer_api,
    "ssm": _ssm_api(mamba2, mamba2.Mamba2),
    "hybrid": _ssm_api(zamba2, zamba2.Zamba2),
    "encdec": _whisper_api,
}


def get_model(cfg: ModelConfig) -> ModelAPI:
    return _FAMILIES[cfg.family]()


def build_module(cfg: ModelConfig, run: RunConfig, params: Dict[str, Any]) -> nn.Module:
    """The family's ``nn.Module`` over ``params`` (their storage shared)."""
    return get_model(cfg).module(cfg, run, params)


def supports_shape(cfg: ModelConfig, shape: ShapeConfig) -> Optional[str]:
    """Returns a skip-reason string, or None if the (arch, shape) cell runs.

    ``long_500k`` needs sub-quadratic attention: it runs for the SSM and
    hybrid families and is skipped for pure full-attention archs (the
    dense 500k KV cache per layer is the blow-up the skip rule exists for).
    """
    if shape.name == "long_500k" and cfg.family not in ("ssm", "hybrid"):
        return ("full-attention arch: 500k-token dense KV cache per layer "
                "(see DESIGN.md §6)")
    return None


def input_specs(cfg: ModelConfig, shape: ShapeConfig) -> Dict[str, Any]:
    """Stand-ins for every model input of this cell: tensors on the meta
    device (shape and dtype, no storage)."""
    B, S = shape.global_batch, shape.seq_len
    i32, bf16 = torch.int32, torch.bfloat16

    def sds(shp, dtype):
        return torch.empty(shp, dtype=dtype, device="meta")

    if shape.kind in ("train", "prefill"):
        batch = {"tokens": sds((B, S), i32)}
        if shape.kind == "train":
            batch["labels"] = sds((B, S), i32)
        if cfg.family == "vlm":
            batch["image_embeds"] = sds((B, cfg.n_image_tokens, cfg.d_model), bf16)
        if cfg.family == "encdec":
            batch["frame_embeds"] = sds((B, cfg.encoder_seq, cfg.d_model), bf16)
        return batch
    # decode: one new token against a seq_len cache
    return {"token": sds((B, 1), i32), "pos": sds((), i32)}
