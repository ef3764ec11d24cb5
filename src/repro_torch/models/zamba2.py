"""Zamba2-style hybrid: Mamba2 backbone + one *shared* attention/MLP block
applied every k SSM layers (arXiv:2411.15242).

Port of the JAX package's ``models/zamba2.py``, with its one recorded
simplification: the shared block consumes ``concat([hidden,
initial_embedding])`` (the Zamba "global residual", width 2d), runs full
attention + gated MLP on 2d and projects back to d; per-application LoRA
adapters are omitted.

The Mamba2 layers are stacked ``(n_super, per, …)``, ``per =
shared_attn_every``: superblocks of ``per`` layers, each preceded by one
application of the shared block, whose gradient accumulates over the
``n_super`` applications.  The arrowhead preconditioner reads that leading
axis, so its grid has ``n_super`` diagonal blocks, as the reference's has.
Under ``run.remat`` a superblock is checkpointed and, inside it, each Mamba2
layer again (nested non-reentrant checkpoints), which bounds the recompute
window to one layer's intra-chunk tensors.  Only ``n_super`` key/value
caches exist.  ``loss``, ``prefill`` and ``decode_step`` take
``constrain=``, a split context: the shared block is gathered over the
data-parallel axes at each application and split over ``model`` as the
dense blocks are (its ``proj_out`` gathered whole), the Mamba2 layers as
``models/mamba2.py`` splits them (by heads with ``run.ssm_head_shard``,
else on this rank's sequence block), the caches the rules' blocks.
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch import pytree
from repro_torch.configs.base import ModelConfig, RunConfig
from repro_torch.core.ctsf import resolve_device
from . import layers as L
from .convert import LMModule
from .mamba2 import init_mamba_cache, mamba_apply, mamba_decode, mamba_params

__all__ = ["init", "init_cache", "loss", "prefill", "decode_step", "Zamba2"]

_F32 = torch.float32


def _shared_block_init(gen: torch.Generator, cfg: ModelConfig) -> Dict[str, Any]:
    d2 = 2 * cfg.d_model
    return {
        "ln1": L.norm_params(d2, "rms", gen.device),
        "attn": L.attention_params(gen, d2, cfg.n_heads, cfg.n_kv_heads, cfg.hd),
        "ln2": L.norm_params(d2, "rms", gen.device),
        "mlp": L.mlp_params(gen, d2, cfg.d_ff, "silu"),
        "proj_out": L.dense_init(gen, d2, cfg.d_model),
    }


def _n_super(cfg: ModelConfig) -> int:
    if cfg.n_layers % cfg.shared_attn_every != 0:
        raise ValueError(f"n_layers={cfg.n_layers} must be divisible by "
                         f"shared_attn_every={cfg.shared_attn_every}")
    return cfg.n_layers // cfg.shared_attn_every


def init(gen: torch.Generator, cfg: ModelConfig, max_seq: int = 0) -> Dict[str, Any]:
    """Random parameters drawn from ``gen``, on its device (float32)."""
    ns, per = _n_super(cfg), cfg.shared_attn_every
    mamba = L.stack_layers(gen, cfg, mamba_params, cfg.n_layers)
    return {
        "embed": L.embed_init(gen, cfg.vocab_padded, cfg.d_model),
        "shared": _shared_block_init(gen, cfg),
        "mamba": pytree.tree_map(lambda x: x.reshape((ns, per) + tuple(x.shape[1:])), mamba),
        "final_norm": L.norm_params(cfg.d_model, "rms", gen.device),
        "unembed": L.dense_init(gen, cfg.d_model, cfg.vocab_padded),
    }


def init_cache(cfg: ModelConfig, batch: int, max_len: int, dtype=torch.bfloat16,
               device=None) -> Dict[str, Any]:
    """Empty caches on ``device`` (None: the card): every Mamba2 layer's
    SSM state and conv buffer, and ``n_super`` key/value caches."""
    dev = resolve_device(device)
    kv_shape = (_n_super(cfg), batch, max_len, cfg.n_kv_heads, cfg.hd)
    return {"ssm": init_mamba_cache(cfg, batch, n_layers=cfg.n_layers, dtype=dtype, device=dev),
            "k": torch.zeros(kv_shape, dtype=dtype, device=dev),
            "v": torch.zeros(kv_shape, dtype=dtype, device=dev)}


def _shared_apply(sp, h, h0, cfg: ModelConfig, run: RunConfig, *, cache=None,
                  cache_len=None, constrain=None):
    c = constrain
    x = torch.cat([h, h0], dim=-1)
    a, new_cache = L.attention_apply(
        sp["attn"], L.norm_apply(sp["ln1"], x, "rms", c),
        n_heads=cfg.n_heads, n_kv=cfg.n_kv_heads, head_dim=cfg.hd,
        rope_theta=cfg.rope_theta, cache=cache, cache_len=cache_len,
        q_chunk=run.q_chunk, kv_chunk=run.kv_chunk, unroll=run.unroll_attn, constrain=c)
    x = x + a
    x = x + L.mlp_apply(sp["mlp"], L.norm_apply(sp["ln2"], x, "rms", c), "silu", constrain=c)
    w = sp["proj_out"]
    if c is not None:
        d2 = 2 * cfg.d_model
        w = c.whole(w, 0, d2) if c.sp else c.whole_redundant(w, 0, d2)
    return h + torch.matmul(x, w.to(h.dtype)), new_cache


def _forward(params, h, cfg: ModelConfig, run: RunConfig, *, fill_cache: bool = False,
             constrain=None):
    """Training / prefill.  Returns (h, caches or None)."""
    c = constrain
    h0 = h
    cache_len = h.shape[1] if fill_cache else None

    def super_body(h, mp):
        shared = c.gather(params["shared"]) if c is not None else params["shared"]
        h, kv = _shared_apply(shared, h, h0, cfg, run, cache_len=cache_len, constrain=c)
        h, states = L.scan_or_unroll(
            lambda h, lp: mamba_apply(lp, h, cfg, chunk=run.ssd_chunk, return_state=fill_cache,
                                      constrain=c),
            h, mp, remat=run.remat if not fill_cache else "none", constrain=c)
        return h, (states, kv)

    h, ys = L.scan_or_unroll(super_body, h, params["mamba"], remat=run.remat, constrain=c,
                             gather=False)
    if not fill_cache:
        return h, None
    state = torch.stack([s[0] for states, _ in ys for s in states])
    conv = torch.stack([s[1] for states, _ in ys for s in states])
    return h, {"ssm": {"state": state, "conv": conv},
               "k": torch.stack([kv[0] for _, kv in ys]),
               "v": torch.stack([kv[1] for _, kv in ys])}


def _decode(params, h, caches, pos: int, cfg: ModelConfig, run: RunConfig, constrain=None):
    """One token through every superblock; the caches written in place
    (under a split, this rank's blocks, bound with their specs)."""
    c = constrain
    h0 = h
    if c is not None:
        kv, ssm = c.slices({"k": caches["k"], "v": caches["v"]}), c.slices(caches["ssm"])
    else:
        kv = [{"k": k, "v": v} for k, v in zip(caches["k"], caches["v"])]
        ssm = [{"state": s, "conv": v}
               for s, v in zip(caches["ssm"]["state"], caches["ssm"]["conv"])]
    kv_it, ssm_it = iter(kv), iter(ssm)

    def super_body(h, mp):
        shared = c.gather(params["shared"]) if c is not None else params["shared"]
        layer = next(kv_it)
        h, _ = _shared_apply(shared, h, h0, cfg, run, cache=(layer["k"], layer["v"]),
                             cache_len=pos, constrain=c)
        h, _ = L.scan_or_unroll(lambda h, lp: mamba_decode(lp, h, next(ssm_it), cfg, constrain=c),
                                h, mp, constrain=c)
        return h, None

    h, _ = L.scan_or_unroll(super_body, h, params["mamba"], constrain=c, gather=False)
    return h


def _lm_head(params, h, constrain=None):
    h = L.rms_norm(h, params["final_norm"]["scale"])
    return L.lm_logits(h, params["unembed"], constrain=constrain)


def loss(params, batch, cfg: ModelConfig, run: RunConfig, constrain=None):
    """Mean next-token cross-entropy; ``constrain``: a sharded step's split
    context (``params`` then this rank's blocks)."""
    dtype = L._dtype(run.compute_dtype)
    c = constrain.at(batch["tokens"].shape[1]) if constrain is not None else None
    h = L.embed_lookup(params["embed"], batch["tokens"], dtype, c)
    if c is not None:
        h = c(h, "act")
    h, _ = _forward(params, h, cfg, run, constrain=c)
    h = L.norm_apply(params["final_norm"], h, "rms", c)
    return L.chunked_cross_entropy(h, params["unembed"], batch["labels"],
                                   chunk=run.loss_chunk, constrain=c)


def prefill(params, tokens, cfg: ModelConfig, run: RunConfig, constrain=None):
    """Full forward; returns (last-position logits, caches in the compute
    dtype but the float32 SSM states).  With ``constrain`` (a split
    context) the logits come back whole over ``model`` and the caches as
    this rank's blocks in the rules' cache layout."""
    dtype = L._dtype(run.compute_dtype)
    c = constrain.at(tokens.shape[1]) if constrain is not None else None
    h = L.embed_lookup(params["embed"], tokens, dtype, c)
    if c is not None:
        h = c(h, "act")
    h, caches = _forward(params, h, cfg, run, fill_cache=True, constrain=c)
    logits = _lm_head(params, c.last(h) if c is not None else h[:, -1:], c)
    caches["ssm"]["conv"] = caches["ssm"]["conv"].to(dtype)
    caches["k"], caches["v"] = caches["k"].to(dtype), caches["v"].to(dtype)
    return logits[:, 0].to(_F32), caches


def decode_step(params, caches, token, pos: int, cfg: ModelConfig, run: RunConfig,
                constrain=None):
    """One autoregressive step at cache length ``pos`` (an int); writes
    into ``caches`` in place and returns (logits, caches).  With
    ``constrain`` (a split context) ``caches`` are this rank's blocks,
    bound with their specs (``Split.bind``)."""
    dtype = L._dtype(run.compute_dtype)
    c = constrain.at(1) if constrain is not None else None
    h = L.embed_lookup(params["embed"], token, dtype, c)
    h = _decode(params, h, caches, pos, cfg, run, c)
    return _lm_head(params, h, c)[:, 0].to(_F32), caches


class Zamba2(LMModule):
    """The Zamba2 hybrid as an ``nn.Module`` (:class:`~repro_torch.models.convert.LMModule`)."""
