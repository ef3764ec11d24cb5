"""Whisper-medium-style encoder-decoder backbone (arXiv:2212.04356).

Port of the JAX package's ``models/whisper.py``.  The audio conv frontend is
a stub, as in the reference: the batch carries precomputed frame embeddings
``frame_embeds (B, encoder_seq, d)`` in place of the two mel convolutions.
Downstream: learned positions, pre-LayerNorm blocks with biases, GELU MLPs,
an encoder with full (non-causal, rotary-free) self-attention, and a
decoder with causal self-attention plus cross-attention to the encoder's
output.  Decode reads the cross keys and values precomputed once by
:func:`_cross_kv` and writes its self-attention caches in place.
``loss``, ``prefill`` and ``decode_step`` take ``constrain=``, a split
context: encoder and decoder are two streams of their own lengths, each
split as the dense blocks are, and the decoder's cross-attention reads the
encoder's output entered whole once; the cross caches are the rules'
blocks (whole where ``model`` does not divide ``encoder_seq``).
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.configs.base import ModelConfig, RunConfig
from repro_torch.core.ctsf import resolve_device
from . import layers as L
from .convert import LMModule

__all__ = ["init", "init_cache", "loss", "prefill", "decode_step", "Whisper", "encode"]

_F32 = torch.float32


def _enc_layer_init(gen: torch.Generator, cfg: ModelConfig) -> Dict[str, Any]:
    dev = gen.device
    return {
        "ln1": L.norm_params(cfg.d_model, "layernorm", dev),
        "attn": L.attention_params(gen, cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd,
                                   bias=True),
        "ln2": L.norm_params(cfg.d_model, "layernorm", dev),
        "mlp": L.mlp_params(gen, cfg.d_model, cfg.d_ff, "gelu", bias=True),
    }


def _dec_layer_init(gen: torch.Generator, cfg: ModelConfig) -> Dict[str, Any]:
    p = _enc_layer_init(gen, cfg)
    p["ln_cross"] = L.norm_params(cfg.d_model, "layernorm", gen.device)
    p["cross"] = L.attention_params(gen, cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd,
                                    bias=True)
    return p


def init(gen: torch.Generator, cfg: ModelConfig, max_seq: int = 4096) -> Dict[str, Any]:
    """Random parameters drawn from ``gen``, on its device (float32);
    ``dec_pos`` has ``max_seq`` rows."""
    rand = lambda *shape: torch.randn(shape, generator=gen, device=gen.device, dtype=_F32)
    return {
        "enc_pos": rand(cfg.encoder_seq, cfg.d_model) * 0.01,
        "enc_layers": L.stack_layers(gen, cfg, _enc_layer_init, cfg.encoder_layers),
        "enc_norm": L.norm_params(cfg.d_model, "layernorm", gen.device),
        "embed": L.embed_init(gen, cfg.vocab_padded, cfg.d_model),
        "dec_pos": rand(max_seq, cfg.d_model) * 0.01,
        "dec_layers": L.stack_layers(gen, cfg, _dec_layer_init, cfg.n_layers),
        "dec_norm": L.norm_params(cfg.d_model, "layernorm", gen.device),
    }


def init_cache(cfg: ModelConfig, batch: int, max_len: int, dtype=torch.bfloat16,
               device=None) -> Dict[str, Any]:
    """Empty self-attention (``k``, ``v``) and cross (``xk``, ``xv``)
    caches on ``device`` (None: the card)."""
    dev = resolve_device(device)
    kv = (cfg.n_layers, batch, max_len, cfg.n_kv_heads, cfg.hd)
    xkv = (cfg.n_layers, batch, cfg.encoder_seq, cfg.n_kv_heads, cfg.hd)
    z = lambda shape: torch.zeros(shape, dtype=dtype, device=dev)
    return {"k": z(kv), "v": z(kv), "xk": z(xkv), "xv": z(xkv)}


def _attn_kw(cfg: ModelConfig, run: RunConfig):
    return dict(n_heads=cfg.n_heads, n_kv=cfg.n_kv_heads, head_dim=cfg.hd, use_rope=False,
                q_chunk=run.q_chunk, kv_chunk=run.kv_chunk, unroll=run.unroll_attn)


def encode(params, frame_embeds: torch.Tensor, cfg: ModelConfig, run: RunConfig,
           constrain=None) -> torch.Tensor:
    """The encoder's output; with ``constrain`` (a sharded step's split
    context) in the layout of its stream (:meth:`Split.at
    <repro_torch.sharding.split.Split.at>` of ``encoder_seq``)."""
    dtype = L._dtype(run.compute_dtype)
    c = constrain.at(frame_embeds.shape[1]) if constrain is not None else None
    pos = c.gather(params["enc_pos"]) if c is not None else params["enc_pos"]
    h = frame_embeds.to(dtype) + pos[None].to(dtype)
    if c is not None:
        h = c(h, "act")

    def body(h, lp):
        a, _ = L.attention_apply(lp["attn"], L.norm_apply(lp["ln1"], h, "layernorm", c),
                                 causal=False, constrain=c, **_attn_kw(cfg, run))
        h = h + a
        h = h + L.mlp_apply(lp["mlp"], L.norm_apply(lp["ln2"], h, "layernorm", c), "gelu",
                            constrain=c)
        return h, None

    h, _ = L.scan_or_unroll(body, h, params["enc_layers"], remat=run.remat, constrain=c)
    return L.norm_apply(params["enc_norm"], h, "layernorm", c)


def _dec_layer(lp, h, enc_out, cfg: ModelConfig, run: RunConfig, *, cache=None,
               cache_len=None, xcache=None, constrain=None):
    """One decoder layer: self-attention (+cache), cross-attention, MLP.
    With ``constrain`` ``enc_out`` is whole on every rank (entered)."""
    c = constrain
    a, new_cache = L.attention_apply(lp["attn"], L.norm_apply(lp["ln1"], h, "layernorm", c),
                                     cache=cache, cache_len=cache_len, constrain=c,
                                     **_attn_kw(cfg, run))
    h = h + a
    hn = L.norm_apply(lp["ln_cross"], h, "layernorm", c)
    if xcache is not None:
        # decode: the cross keys and values precomputed, every frame attended
        x = L.cross_decode(lp["cross"], hn, xcache, n_heads=cfg.n_heads, head_dim=cfg.hd,
                           constrain=c)
    else:
        x, _ = L.attention_apply(lp["cross"], hn, causal=False, kv_x=enc_out, constrain=c,
                                 **_attn_kw(cfg, run))
    h = h + x
    h = h + L.mlp_apply(lp["mlp"], L.norm_apply(lp["ln2"], h, "layernorm", c), "gelu",
                        constrain=c)
    return h, new_cache


def _decoder(params, tokens, enc_out, cfg: ModelConfig, run: RunConfig, *, pos_offset: int = 0,
             caches=None, fill_cache: bool = False, constrain=None):
    """The decoder stack and its final norm.  Training / prefill: returns
    (h, [(k, v) a layer] with ``fill_cache``, else None); decode (``caches``
    given, one token at ``pos_offset``): (h, caches), written in place.
    ``constrain``: the decoder stream's split context (the caches then
    this rank's blocks, bound with their specs)."""
    c = constrain
    dtype = L._dtype(run.compute_dtype)
    S = tokens.shape[1]
    h = L.embed_lookup(params["embed"], tokens, dtype, c, whole=True)
    pos = c.gather(params["dec_pos"]) if c is not None else params["dec_pos"]
    h = h + pos[pos_offset:pos_offset + S][None].to(dtype)
    if c is not None:
        h = c(h, "act")
    if caches is not None:
        names = ("k", "v", "xk", "xv")
        layers = (c.slices({k: caches[k] for k in names}) if c is not None
                  else [dict(zip(names, x)) for x in zip(*(caches[k] for k in names))])
        it = iter(layers)

        def step(h, lp):
            l = next(it)
            return _dec_layer(lp, h, None, cfg, run, cache=(l["k"], l["v"]),
                              cache_len=pos_offset, xcache=(l["xk"], l["xv"]), constrain=c)

        h, _ = L.scan_or_unroll(step, h, params["dec_layers"], constrain=c)
        return L.norm_apply(params["dec_norm"], h, "layernorm", c), caches

    h, ys = L.scan_or_unroll(
        lambda h, lp: _dec_layer(lp, h, enc_out, cfg, run, cache_len=S if fill_cache else None,
                                 constrain=c),
        h, params["dec_layers"], remat=run.remat, constrain=c)
    return L.norm_apply(params["dec_norm"], h, "layernorm", c), ys


def loss(params, batch, cfg: ModelConfig, run: RunConfig, constrain=None):
    """Mean next-token cross-entropy of the decoder (tied embedding) given
    the encoder's output on ``batch["frame_embeds"]``; ``constrain``: a
    sharded step's split context (``params`` then this rank's blocks)."""
    frames, tokens = batch["frame_embeds"], batch["tokens"]
    enc_out = encode(params, frames, cfg, run, constrain)
    c = None
    if constrain is not None:
        # the encoder's output whole on every rank, entered once for every
        # decoder layer's cross-attention (its gradient summed once)
        enc_out = constrain.at(frames.shape[1]).enter(enc_out)
        c = constrain.at(tokens.shape[1])
    h, _ = _decoder(params, tokens, enc_out, cfg, run, constrain=c)
    return L.chunked_cross_entropy(h, params["embed"], batch["labels"],
                                   chunk=run.loss_chunk, transpose_w=True, constrain=c)


def _cross_kv(params, enc_out, cfg: ModelConfig, constrain=None):
    """Each decoder layer's cross-attention keys and values of the encoder
    output, stacked ``(n_layers, B, encoder_seq, KV, hd)``.  With
    ``constrain`` (the encoder stream's split context, ``enc_out`` in its
    layout) this rank's blocks in the rules' cache layout: its sequence
    block where ``model`` divides ``encoder_seq``, else whole; each layer's
    ``wk``/``wv`` gathered whole."""
    dtype = enc_out.dtype
    B, S, _ = enc_out.shape
    c = constrain
    if c is None:
        xp = params["dec_layers"]["cross"]
        proj = lambda w, b: (torch.matmul(enc_out[None], xp[w].to(dtype)[:, None])
                             + xp[b].to(dtype)[:, None, None]).reshape(
            cfg.n_layers, B, S, cfg.n_kv_heads, cfg.hd)
        return proj("wk", "bk"), proj("wv", "bv")
    if c.tp > 1 and not c.sp and S % c.tp == 0:         # a whole stream, a cut cache
        enc_out = enc_out.narrow(1, c.rank * (S // c.tp), S // c.tp)
    cols = cfg.n_kv_heads * cfg.hd
    ks, vs = [], []
    for lp in c.slices(params["dec_layers"]):
        xp = c.gather(lp["cross"])
        for w, b, out in (("wk", "bk", ks), ("wv", "bv", vs)):
            y = torch.matmul(enc_out, c.whole(xp[w], 1, cols).to(dtype)) + xp[b].to(dtype)
            out.append(y.reshape(B, enc_out.shape[1], cfg.n_kv_heads, cfg.hd))
    return torch.stack(ks), torch.stack(vs)


def prefill(params, batch, cfg: ModelConfig, run: RunConfig, constrain=None):
    """``batch``: dict(tokens, frame_embeds).  Returns (last-position
    logits, caches: the self-attention ``k``/``v`` of the prompt and the
    cross ``xk``/``xv``).  With ``constrain`` (a split context) the
    logits come back whole over ``model`` and the caches as this rank's
    blocks in the rules' cache layout."""
    frames, tokens = batch["frame_embeds"], batch["tokens"]
    enc_out = encode(params, frames, cfg, run, constrain)
    ce = c = None
    enc_whole = enc_out
    if constrain is not None:
        ce, c = constrain.at(frames.shape[1]), constrain.at(tokens.shape[1])
        enc_whole = ce.enter(enc_out)
    h, ys = _decoder(params, tokens, enc_whole, cfg, run, fill_cache=True, constrain=c)
    h = c.last(h) if c is not None else h[:, -1:]
    logits = L.lm_logits(h, params["embed"], transpose_w=True, constrain=c)[:, 0]
    xk, xv = _cross_kv(params, enc_out, cfg, ce)
    caches = {"k": torch.stack([y[0] for y in ys]), "v": torch.stack([y[1] for y in ys]),
              "xk": xk, "xv": xv}
    return logits.to(_F32), caches


def decode_step(params, caches, token, pos: int, cfg: ModelConfig, run: RunConfig,
                constrain=None):
    """One autoregressive step at cache length ``pos`` (an int): writes the
    token's self-attention keys and values into ``caches`` in place and
    returns (logits, caches).  With ``constrain`` (a split context)
    ``caches`` are this rank's blocks, bound with their specs
    (``Split.bind``)."""
    c = constrain.at(1) if constrain is not None else None
    h, caches = _decoder(params, token, None, cfg, run, pos_offset=pos, caches=caches,
                         constrain=c)
    logits = L.lm_logits(h, params["embed"], transpose_w=True, constrain=c)
    return logits[:, 0].to(_F32), caches


class Whisper(LMModule):
    """The whisper encoder-decoder as an ``nn.Module`` (:class:`~repro_torch.models.convert.LMModule`)."""
