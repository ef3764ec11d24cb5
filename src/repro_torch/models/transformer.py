"""Dense / MoE / VLM decoder-only transformer (qwen2, qwen3, command-r,
granite-moe backbones; the VLM stub, phi-3-vision: precomputed patch
embeddings in the first positions).

Port of the JAX package's ``models/transformer.py``: ``init`` builds a dict
of tensors with the layer parameters stacked on a leading ``(n_layers, …)``
axis, as the reference's ``jax.vmap`` init does (the arrowhead
preconditioner reads each layer leaf as ``leaf.reshape(n_layers, -1)``);
``loss`` / ``prefill`` / ``decode_step`` loop over that axis.  A MoE layer
carries ``moe`` (``models/moe.py``) in place of ``mlp``.
:class:`Transformer` is the same model as an ``nn.Module``.  ``loss``,
``prefill`` and ``decode_step`` take ``constrain=``, a split context
(``sharding/split.py``), as the reference's do: the residual stream then
lives in the rules' ``act`` layout (the sequence on ``model`` under SP),
each block is split over ``model``, and the caches are the rules' blocks.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig, RunConfig
from repro_torch.core.ctsf import resolve_device
from . import layers as L
from .convert import LMModule
from .moe import moe_apply, moe_params

__all__ = ["init", "init_cache", "loss", "prefill", "decode_step", "Transformer"]


def _check_family(cfg: ModelConfig) -> None:
    if cfg.family not in ("dense", "moe", "vlm"):
        raise ValueError(f"models/transformer.py runs the dense, moe and vlm families, not "
                         f"{cfg.family!r}")


# ---------------------------------------------------------------------------
# params
# ---------------------------------------------------------------------------

def _layer_init(gen: torch.Generator, cfg: ModelConfig) -> Dict[str, Any]:
    p = {
        "ln1": L.norm_params(cfg.d_model, cfg.norm, gen.device),
        "attn": L.attention_params(gen, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                                   cfg.hd, bias=cfg.qkv_bias, qk_norm=cfg.qk_norm),
        "ln2": L.norm_params(cfg.d_model, cfg.norm, gen.device),
    }
    if cfg.family == "moe":
        p["moe"] = moe_params(gen, cfg.d_model, cfg.d_ff, cfg.n_experts,
                              pad_to=cfg.expert_pad_to)
    else:
        p["mlp"] = L.mlp_params(gen, cfg.d_model, cfg.d_ff, cfg.act)
    return p


def init(gen: torch.Generator, cfg: ModelConfig) -> Dict[str, Any]:
    """Random parameters drawn from ``gen``, on its device (float32)."""
    _check_family(cfg)
    params = {"embed": L.embed_init(gen, cfg.vocab_padded, cfg.d_model),
              "final_norm": L.norm_params(cfg.d_model, cfg.norm, gen.device)}
    params["layers"] = L.stack_layers(gen, cfg, _layer_init, cfg.n_layers)
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
                 cache=None, cache_len=None, constrain=None):
    a, new_cache = L.attention_apply(
        lp["attn"], L.norm_apply(lp["ln1"], h, cfg.norm, constrain),
        n_heads=cfg.n_heads, n_kv=cfg.n_kv_heads, head_dim=cfg.hd,
        positions=positions, rope_theta=cfg.rope_theta,
        cache=cache, cache_len=cache_len, q_chunk=run.q_chunk,
        kv_chunk=run.kv_chunk, unroll=run.unroll_attn, constrain=constrain)
    h = h + a
    hn = L.norm_apply(lp["ln2"], h, cfg.norm, constrain)
    if cfg.family == "moe":
        m = moe_apply(lp["moe"], hn, top_k=cfg.top_k, capacity_factor=cfg.capacity_factor,
                      constrain=constrain)
    else:
        m = L.mlp_apply(lp["mlp"], hn, cfg.act, constrain=constrain)
    h = h + m
    if constrain is not None:
        h = constrain(h, "act")   # the residual stream stays in the SP layout
    return h, new_cache


def _embed(params, tokens, cfg: ModelConfig, dtype,
           image_embeds: Optional[torch.Tensor] = None, constrain=None):
    """The token lookup in the stream's layout (this rank's sequence block
    under SP, ``L.embed_lookup``), the VLM stub's precomputed patch
    embeddings over the first ``n_image_tokens`` positions: on a block,
    those of them that fall inside it."""
    h = L.embed_lookup(params["embed"], tokens, dtype, constrain)
    if cfg.n_image_tokens and image_embeds is not None:
        n = cfg.n_image_tokens
        off = constrain.q_offset(h.shape[1]) if h.shape[1] < tokens.shape[1] else 0
        k = min(max(n - off, 0), h.shape[1])
        if k:
            h = torch.cat([image_embeds[:, off:off + k].to(dtype), h[:, k:]], dim=1)
    return h


def _stack_forward(params, h, cfg: ModelConfig, run: RunConfig, *,
                   positions=None, caches=None, cache_len=None,
                   fill_cache: bool = False, constrain=None):
    """Loop over the stacked layers.  Returns (h, new_caches); a decode
    step writes its token into ``caches`` in place (under a split, its
    blocks: each layer's slice keeps the spec the caller bound,
    ``Split.bind``)."""
    c = constrain
    if caches is not None:
        kv = (c.slices({"k": caches["k"], "v": caches["v"]}) if c is not None
              else [{"k": k, "v": v} for k, v in zip(caches["k"], caches["v"])])
        it = iter(kv)

        def step(h, lp):
            layer = next(it)
            return _layer_apply(lp, h, cfg, run, positions=positions,
                                cache=(layer["k"], layer["v"]), cache_len=cache_len,
                                constrain=c)

        h, _ = L.scan_or_unroll(step, h, params["layers"], constrain=c)
        return h, caches

    def body(h, lp):
        return _layer_apply(lp, h, cfg, run, positions=positions,
                            cache_len=cache_len if fill_cache else None, constrain=c)

    h, ys = L.scan_or_unroll(body, h, params["layers"], remat=run.remat, constrain=c)
    new_caches = None
    if fill_cache and ys is not None:
        new_caches = {"k": torch.stack([y[0] for y in ys]),
                      "v": torch.stack([y[1] for y in ys])}
    return h, new_caches


def _logits(params, h, cfg: ModelConfig, constrain=None):
    w = params["embed"] if cfg.tie_embeddings else params["unembed"]
    return L.lm_logits(h, w, transpose_w=cfg.tie_embeddings, softcap=cfg.logit_softcap,
                       constrain=constrain)


# ---------------------------------------------------------------------------
# public entry points
# ---------------------------------------------------------------------------

def loss(params, batch: Dict[str, torch.Tensor], cfg: ModelConfig,
         run: RunConfig, constrain=None) -> torch.Tensor:
    """Mean next-token cross-entropy.  batch: tokens (B,S) int, labels (B,S)
    int (-1 = masked), optional image_embeds.  ``constrain``: a sharded
    step's split context (``params`` then this rank's blocks)."""
    _check_family(cfg)
    dtype = L._dtype(run.compute_dtype)
    c = constrain.at(batch["tokens"].shape[1]) if constrain is not None else None
    h = _embed(params, batch["tokens"], cfg, dtype, batch.get("image_embeds"), c)
    if c is not None:
        h = c(h, "act")
    h, _ = _stack_forward(params, h, cfg, run, constrain=c)
    h = L.norm_apply(params["final_norm"], h, cfg.norm, c)
    w = params["embed"] if cfg.tie_embeddings else params["unembed"]
    return L.chunked_cross_entropy(h, w, batch["labels"], softcap=cfg.logit_softcap,
                                   chunk=run.loss_chunk, transpose_w=cfg.tie_embeddings,
                                   constrain=c)


def prefill(params, tokens: torch.Tensor, cfg: ModelConfig, run: RunConfig,
            image_embeds: Optional[torch.Tensor] = None, constrain=None
            ) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """Process a full prompt; returns (last-position logits, filled caches
    of shape (n_layers, B, S, KV, hd) in the compute dtype).  With
    ``constrain`` (a split context, ``params`` this rank's blocks and
    ``tokens`` its batch block) the prompt runs as the split train forward
    does, the logits come back whole over ``model`` and the caches as this
    rank's blocks in the rules' cache layout (``Rules.cache_pspec``)."""
    _check_family(cfg)
    dtype = L._dtype(run.compute_dtype)
    S = tokens.shape[1]
    c = constrain.at(S) if constrain is not None else None
    h = _embed(params, tokens, cfg, dtype, image_embeds, c)
    if c is not None:
        h = c(h, "act")
    h, caches = _stack_forward(params, h, cfg, run, cache_len=S, fill_cache=True, constrain=c)
    h = L.norm_apply(params["final_norm"], c.last(h) if c is not None else h[:, -1:], cfg.norm)
    logits = _logits(params, h, cfg, c)
    return logits[:, 0].to(torch.float32), caches


def decode_step(params, caches: Dict[str, Any], token: torch.Tensor, pos: int,
                cfg: ModelConfig, run: RunConfig, constrain=None
                ) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """One autoregressive step. token: (B, 1) int; pos: the cache length
    (an int).  Writes the token's keys and values into ``caches`` in place
    and returns (logits, caches).  With ``constrain`` (a split context)
    ``caches`` are this rank's blocks, bound with their specs
    (``Split.bind``), and attention is flash decoding over them
    (``models/layers.py``); the logits come back whole over ``model``."""
    _check_family(cfg)
    dtype = L._dtype(run.compute_dtype)
    c = constrain.at(1) if constrain is not None else None
    h = _embed(params, token, cfg, dtype, constrain=c)
    h, caches = _stack_forward(params, h, cfg, run, caches=caches, cache_len=pos, constrain=c)
    h = L.norm_apply(params["final_norm"], h, cfg.norm)
    logits = _logits(params, h, cfg, c)
    return logits[:, 0].to(torch.float32), caches


class Transformer(LMModule):
    """The model as an ``nn.Module``
    (:class:`~repro_torch.models.convert.LMModule`): its parameters, the
    dict of :func:`init` (or one converted from the reference), registered
    in the reference's leaf order under its names (``layers.attn.wq``), and
    the registry's entry points bound to its config."""

    def __init__(self, cfg: ModelConfig, run: RunConfig, params: Dict[str, Any]):
        _check_family(cfg)
        super().__init__(cfg, run, params)
