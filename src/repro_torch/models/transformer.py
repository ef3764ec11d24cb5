"""Dense decoder-only transformer (qwen2, qwen3, command-r backbones) and
the VLM stub (phi-3-vision: precomputed patch embeddings in the first
positions).

Port of the JAX package's ``models/transformer.py`` for ``family ==
"dense"`` and ``"vlm"``: ``init`` builds a dict of tensors with the layer
parameters stacked on a leading ``(n_layers, …)`` axis, as the reference's
``jax.vmap`` init does (the arrowhead preconditioner reads each layer leaf
as ``leaf.reshape(n_layers, -1)``); ``loss`` / ``prefill`` /
``decode_step`` loop over that axis.  :class:`Transformer` is the same
model as an ``nn.Module``.  The MoE family waits for ``models/moe.py``.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
from torch import nn

from repro_torch import pytree
from repro_torch.configs.base import ModelConfig, RunConfig
from repro_torch.core.ctsf import resolve_device
from . import layers as L
from .convert import ParamTree

__all__ = ["init", "init_cache", "loss", "prefill", "decode_step", "Transformer"]


def _check_family(cfg: ModelConfig) -> None:
    if cfg.family == "moe":
        raise NotImplementedError("the MoE family needs models/moe.py, which is not ported yet")
    if cfg.family not in ("dense", "vlm"):
        raise ValueError(f"models/transformer.py runs the dense and vlm families, not "
                         f"{cfg.family!r}")


# ---------------------------------------------------------------------------
# params
# ---------------------------------------------------------------------------

def _layer_init(gen: torch.Generator, cfg: ModelConfig) -> Dict[str, Any]:
    return {
        "ln1": L.norm_params(cfg.d_model, cfg.norm, gen.device),
        "attn": L.attention_params(gen, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                                   cfg.hd, bias=cfg.qkv_bias, qk_norm=cfg.qk_norm),
        "ln2": L.norm_params(cfg.d_model, cfg.norm, gen.device),
        "mlp": L.mlp_params(gen, cfg.d_model, cfg.d_ff, cfg.act),
    }


def init(gen: torch.Generator, cfg: ModelConfig) -> Dict[str, Any]:
    """Random parameters drawn from ``gen``, on its device (float32)."""
    _check_family(cfg)
    params = {"embed": L.embed_init(gen, cfg.vocab_padded, cfg.d_model),
              "final_norm": L.norm_params(cfg.d_model, cfg.norm, gen.device)}
    per_layer = [_layer_init(gen, cfg) for _ in range(cfg.n_layers)]
    params["layers"] = pytree.tree_map(lambda *xs: torch.stack(xs), *per_layer)
    del per_layer
    if not cfg.tie_embeddings:
        params["unembed"] = L.dense_init(gen, cfg.d_model, cfg.vocab_padded)
    return params


def init_cache(cfg: ModelConfig, batch: int, max_len: int, dtype=torch.bfloat16,
               device=None) -> Dict[str, Any]:
    """Empty key/value caches on ``device`` (None: the card)."""
    dev = resolve_device(device)
    shape = (cfg.n_layers, batch, max_len, cfg.n_kv_heads, cfg.hd)
    return {"k": torch.zeros(shape, dtype=dtype, device=dev),
            "v": torch.zeros(shape, dtype=dtype, device=dev)}


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------

def _layer_apply(lp, h, cfg: ModelConfig, run: RunConfig, *, positions=None,
                 cache=None, cache_len=None):
    a, new_cache = L.attention_apply(
        lp["attn"], L.norm_apply(lp["ln1"], h, cfg.norm),
        n_heads=cfg.n_heads, n_kv=cfg.n_kv_heads, head_dim=cfg.hd,
        positions=positions, rope_theta=cfg.rope_theta,
        cache=cache, cache_len=cache_len, q_chunk=run.q_chunk,
        kv_chunk=run.kv_chunk, unroll=run.unroll_attn)
    h = h + a
    h = h + L.mlp_apply(lp["mlp"], L.norm_apply(lp["ln2"], h, cfg.norm), cfg.act)
    return h, new_cache


def _embed(params, tokens, cfg: ModelConfig, dtype,
           image_embeds: Optional[torch.Tensor] = None):
    h = params["embed"][tokens.long()].to(dtype)
    if cfg.n_image_tokens and image_embeds is not None:
        # VLM stub: precomputed patch embeddings occupy the first positions
        n = cfg.n_image_tokens
        h = torch.cat([image_embeds.to(dtype), h[:, n:]], dim=1)
    return h


def _stack_forward(params, h, cfg: ModelConfig, run: RunConfig, *,
                   positions=None, caches=None, cache_len=None,
                   fill_cache: bool = False):
    """Loop over the stacked layers.  Returns (h, new_caches); a decode
    step writes its token into ``caches`` in place."""
    if caches is not None:
        for i in range(cfg.n_layers):
            lp = pytree.tree_map(lambda x: x[i], params["layers"])
            h, _ = _layer_apply(lp, h, cfg, run, positions=positions,
                                cache=(caches["k"][i], caches["v"][i]),
                                cache_len=cache_len)
        return h, caches

    def body(h, lp):
        return _layer_apply(lp, h, cfg, run, positions=positions,
                            cache_len=cache_len if fill_cache else None)

    h, ys = L.scan_or_unroll(body, h, params["layers"], remat=run.remat)
    new_caches = None
    if fill_cache and ys is not None:
        new_caches = {"k": torch.stack([y[0] for y in ys]),
                      "v": torch.stack([y[1] for y in ys])}
    return h, new_caches


def _logits(params, h, cfg: ModelConfig):
    w = params["embed"].t() if cfg.tie_embeddings else params["unembed"]
    logits = torch.matmul(h, w.to(h.dtype))
    if cfg.logit_softcap:
        logits = torch.tanh(logits / cfg.logit_softcap) * cfg.logit_softcap
    return logits


# ---------------------------------------------------------------------------
# public entry points
# ---------------------------------------------------------------------------

def loss(params, batch: Dict[str, torch.Tensor], cfg: ModelConfig,
         run: RunConfig) -> torch.Tensor:
    """Mean next-token cross-entropy.  batch: tokens (B,S) int, labels (B,S)
    int (-1 = masked), optional image_embeds."""
    _check_family(cfg)
    dtype = L._dtype(run.compute_dtype)
    h = _embed(params, batch["tokens"], cfg, dtype, batch.get("image_embeds"))
    h, _ = _stack_forward(params, h, cfg, run)
    h = L.norm_apply(params["final_norm"], h, cfg.norm)
    w = params["embed"] if cfg.tie_embeddings else params["unembed"]
    return L.chunked_cross_entropy(h, w, batch["labels"], softcap=cfg.logit_softcap,
                                   chunk=run.loss_chunk, transpose_w=cfg.tie_embeddings)


def prefill(params, tokens: torch.Tensor, cfg: ModelConfig, run: RunConfig,
            image_embeds: Optional[torch.Tensor] = None
            ) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """Process a full prompt; returns (last-position logits, filled caches
    of shape (n_layers, B, S, KV, hd) in the compute dtype)."""
    _check_family(cfg)
    dtype = L._dtype(run.compute_dtype)
    S = tokens.shape[1]
    h = _embed(params, tokens, cfg, dtype, image_embeds)
    h, caches = _stack_forward(params, h, cfg, run, cache_len=S, fill_cache=True)
    h = L.norm_apply(params["final_norm"], h[:, -1:], cfg.norm)
    logits = _logits(params, h, cfg)
    return logits[:, 0].to(torch.float32), caches


def decode_step(params, caches: Dict[str, Any], token: torch.Tensor, pos: int,
                cfg: ModelConfig, run: RunConfig) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """One autoregressive step. token: (B, 1) int; pos: the cache length
    (an int).  Writes the token's keys and values into ``caches`` in place
    and returns (logits, caches)."""
    _check_family(cfg)
    dtype = L._dtype(run.compute_dtype)
    h = _embed(params, token, cfg, dtype)
    h, caches = _stack_forward(params, h, cfg, run, caches=caches, cache_len=pos)
    h = L.norm_apply(params["final_norm"], h, cfg.norm)
    logits = _logits(params, h, cfg)
    return logits[:, 0].to(torch.float32), caches


class Transformer(nn.Module):
    """The model as an ``nn.Module``: its parameters, the dict of
    :func:`init` (or one converted from the reference), registered in the
    reference's leaf order under its names (``layers.attn.wq``), and the
    entry points above bound to its config."""

    def __init__(self, cfg: ModelConfig, run: RunConfig, params: Dict[str, Any]):
        super().__init__()
        _check_family(cfg)
        self.cfg, self.run = cfg, run
        self.tree = ParamTree(params)

    def params(self) -> Dict[str, Any]:
        return self.tree.tree()

    def forward(self, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        return loss(self.params(), batch, self.cfg, self.run)

    def prefill(self, tokens: torch.Tensor, image_embeds: Optional[torch.Tensor] = None):
        return prefill(self.params(), tokens, self.cfg, self.run, image_embeds=image_embeds)

    def decode_step(self, caches: Dict[str, Any], token: torch.Tensor, pos: int):
        return decode_step(self.params(), caches, token, pos, self.cfg, self.run)
