"""Shared model building blocks: norms, rotary, chunked (flash-style)
attention with GQA (causal or not, self- or cross-attention), gated and
plain MLPs, the chunked loss and the layer loop.

Port of the JAX package's ``models/layers.py``: plain functions over dicts
of tensors, the weights in the reference's ``(d_in, d_out)`` layout applied
as ``x @ W`` (the arrowhead preconditioner samples flat coordinates of each
leaf, so a transposed leaf would sketch other entries).  Norms, rotary and
softmax statistics compute in float32 and cast back.  Attention never
materializes the ``(S, S)`` score matrix: key/value blocks stream through
an online-softmax accumulator, and the backward pass recomputes score
blocks from the saved log-sum-exp (:class:`_Flash`).

Under a sharded train step, prefill or decode step the blocks take
``constrain=``, the split context (``sharding/split.py``), at the
reference's call sites: the layer loop gathers each layer over the
data-parallel axes, attention is split by heads over ``model`` where both
head counts divide it (else each rank takes its query block against keys
and values gathered over ``model``), the MLP by columns and rows, and the
loss, the embedding and the logits by vocabulary blocks.  What a rank
holds at once is bounded as Megatron's sequence parallelism bounds it: the
embedding is reduce-scattered into the rank's sequence block, the
gathered input of the attention's and the MLP's column projections is
not kept for their backward (``Split.enter_columns``), the loss's chunks
return their gradients to the blocks one at a time (:class:`_VocabCE`),
under a remat policy the norms recompute their float32 temporaries, and
the flash blocks go a few batch rows at a time, every row's arithmetic
that of the whole batch's.  A prefill's keys
and values come back in the rules' cache layout (the sequence on
``model``); a decode step attends by flash decoding over those blocks
(:func:`_attention_decode_split`).
"""
from __future__ import annotations

import functools
import math
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint, create_selective_checkpoint_contexts
from torch.utils.checkpoint import CheckpointPolicy

from repro_torch import pytree
from repro_torch.sharding.collectives import (all_gather_rs, all_gather_split, all_reduce_id,
                                              all_reduce_max, all_to_all, reduce_scatter_ag,
                                              row_pieces, split_ag)

__all__ = [
    "dense_init", "embed_init", "rms_norm", "layer_norm", "apply_rope",
    "chunked_attention", "decode_attention", "attention_params",
    "attention_apply", "mlp_params", "mlp_apply", "norm_params", "norm_apply",
    "chunked_cross_entropy", "scan_or_unroll", "stack_layers", "embed_lookup", "lm_logits",
    "cross_decode", "whole_columns",
]

_F32 = torch.float32


def _dtype(name) -> torch.dtype:
    return name if isinstance(name, torch.dtype) else getattr(torch, str(name))


# ---------------------------------------------------------------------------
# init helpers (the reference's distributions, drawn from a torch.Generator
# on the generator's device)
# ---------------------------------------------------------------------------

def dense_init(gen: torch.Generator, d_in: int, d_out: int, dtype=_F32) -> torch.Tensor:
    scale = 1.0 / math.sqrt(d_in)
    w = torch.randn((d_in, d_out), generator=gen, device=gen.device, dtype=_F32)
    return (w * scale).to(dtype)


def embed_init(gen: torch.Generator, vocab: int, d: int, dtype=_F32) -> torch.Tensor:
    w = torch.randn((vocab, d), generator=gen, device=gen.device, dtype=_F32)
    return (w * 0.02).to(dtype)


def norm_params(d: int, kind: str = "rms", device=None) -> Dict[str, torch.Tensor]:
    p = {"scale": torch.ones((d,), dtype=_F32, device=device)}
    if kind == "layernorm":
        p["bias"] = torch.zeros((d,), dtype=_F32, device=device)
    return p


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    dt = x.dtype
    x = x.to(_F32)
    x = x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps)
    return (x * scale).to(dt)


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    dt = x.dtype
    x = x.to(_F32)
    mu = torch.mean(x, dim=-1, keepdim=True)
    var = torch.mean((x - mu) ** 2, dim=-1, keepdim=True)
    x = (x - mu) * torch.rsqrt(var + eps)
    return (x * scale + bias).to(dt)


def norm_apply(p: Dict[str, torch.Tensor], x: torch.Tensor, kind: str = "rms",
               constrain=None):
    """``constrain``: the split context of the stream ``x`` belongs to; a
    scale applied to a sequence block gets its gradient summed over
    ``model``.  Under autograd and a remat policy (the split's
    ``run.remat`` "full" or "dots") the norm keeps only its input for its
    backward, which recomputes it: its float32 temporaries are not held
    while the rest of a layer, or the loss, runs.  Under "none" it keeps
    them, as the run asked."""
    rep = constrain.rep if constrain is not None else (lambda t: t)
    if kind == "layernorm":
        args = (layer_norm, x, rep(p["scale"]), rep(p["bias"]))
    else:
        args = (rms_norm, x, rep(p["scale"]))
    if constrain is not None and constrain.remat != "none" and torch.is_grad_enabled():
        return checkpoint(*args, use_reentrant=False)       # the same operations
    return args[0](*args[1:])


# ---------------------------------------------------------------------------
# rotary embeddings
# ---------------------------------------------------------------------------

def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 10_000.0) -> torch.Tensor:
    """x: (B, S, H, D); positions: (S,) or (B, S)."""
    d = x.shape[-1]
    half = d // 2
    freqs = theta ** (-torch.arange(0, half, dtype=_F32, device=x.device) / half)
    if positions.ndim == 1:
        positions = positions[None, :]
    ang = positions[:, :, None].to(_F32) * freqs[None, None, :]     # (B,S,half)
    sin = torch.sin(ang)[:, :, None, :]
    cos = torch.cos(ang)[:, :, None, :]
    x1, x2 = x[..., :half].to(_F32), x[..., half:].to(_F32)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------

def _chunk_size(total: int, want: int) -> int:
    c = min(want, total)
    while total % c:
        c -= 1
    return max(1, c)


def _block_mask(qi, ki, qc, kc, q_offset, device):
    """``(qc, kc)`` causal mask of a score block; None when the block is
    fully visible."""
    if ki * kc + kc - 1 <= qi * qc + q_offset:
        return None
    qpos = qi * qc + q_offset + torch.arange(qc, device=device)
    kpos = ki * kc + torch.arange(kc, device=device)
    return qpos[:, None] >= kpos[None, :]


def _masked(s, causal, qi, ki, qc, kc, q_offset):
    """Whether the block is fully masked (skip it: every score is -1e30
    behind an unmasked key 0 of the row, so its softmax weights are exact
    zeros), and the scores with the causal mask applied."""
    if not causal:
        return False, s
    if ki * kc > qi * qc + q_offset + qc - 1:
        return True, s
    mask = _block_mask(qi, ki, qc, kc, q_offset, s.device)
    if mask is None:
        return False, s
    return False, torch.where(mask, s, torch.full((), -1e30, dtype=s.dtype, device=s.device))


def _flash_layout(q, k, v, q_chunk, kv_chunk):
    B, Sq, H, D = q.shape
    _, Skv, KV, _ = k.shape
    G = H // KV
    qc = _chunk_size(Sq, q_chunk)
    kc = _chunk_size(Skv, kv_chunk)
    return B, Sq, H, D, Skv, KV, G, qc, kc, Sq // qc, Skv // kc


def _flash_forward(q, k, v, causal, q_chunk, kv_chunk, q_offset):
    """The forward blocks: ``out (B, Sq, H, D)`` in q's dtype and ``lse
    (nq, B, KV, G, qc)``, the only O(S) softmax residual."""
    B, Sq, H, D, Skv, KV, G, qc, kc, nq, nk = _flash_layout(q, k, v, q_chunk, kv_chunk)
    q5 = q.reshape(B, nq, qc, KV, G, D)
    k4 = k.reshape(B, nk, kc, KV, D)
    v4 = v.reshape(B, nk, kc, KV, D)
    outs, lses = [], []
    for qi in range(nq):
        qblk = q5[:, qi].to(_F32)
        m = torch.full((B, KV, G, qc), -1e30, dtype=_F32, device=q.device)
        l = torch.zeros((B, KV, G, qc), dtype=_F32, device=q.device)
        acc = torch.zeros((B, KV, G, qc, D), dtype=_F32, device=q.device)
        for ki in range(nk):
            s = torch.einsum("bqhgd,bkhd->bhgqk", qblk, k4[:, ki].to(_F32))
            skip, s = _masked(s, causal, qi, ki, qc, kc, q_offset)
            if skip:
                continue
            m_new = torch.maximum(m, s.amax(-1))
            alpha = torch.exp(m - m_new)
            p = torch.exp(s - m_new[..., None])
            l = l * alpha + p.sum(-1)
            acc = acc * alpha[..., None] + torch.einsum("bhgqk,bkhd->bhgqd", p,
                                                        v4[:, ki].to(_F32))
            m = m_new
        l = torch.clamp_min(l, 1e-30)
        outs.append((acc / l[..., None]).permute(0, 3, 1, 2, 4))      # (B,qc,KV,G,D)
        lses.append(m + torch.log(l))
    out = torch.cat(outs, dim=1).reshape(B, Sq, H, D).to(q.dtype)
    return out, torch.stack(lses)


def _flash_backward(q, k, v, out, lse, do, causal, q_chunk, kv_chunk, q_offset):
    B, Sq, H, D, Skv, KV, G, qc, kc, nq, nk = _flash_layout(q, k, v, q_chunk, kv_chunk)
    q5 = q.reshape(B, nq, qc, KV, G, D)
    k4 = k.reshape(B, nk, kc, KV, D)
    v4 = v.reshape(B, nk, kc, KV, D)
    do5 = do.reshape(B, nq, qc, KV, G, D)
    # delta_i = rowsum(dO * O) -> (B, nq, KV, G, qc)
    delta = torch.einsum("bnqhgd,bnqhgd->bnhgq", do5.to(_F32),
                         out.reshape(B, nq, qc, KV, G, D).to(_F32))
    dk = torch.zeros((B, nk, kc, KV, D), dtype=_F32, device=q.device)
    dv = torch.zeros((B, nk, kc, KV, D), dtype=_F32, device=q.device)
    dqs = []
    for qi in range(nq):
        qblk, doblk = q5[:, qi].to(_F32), do5[:, qi].to(_F32)
        lse_i, delta_i = lse[qi], delta[:, qi]
        dq_i = torch.zeros((B, qc, KV, G, D), dtype=_F32, device=q.device)
        for ki in range(nk):
            kblk, vblk = k4[:, ki].to(_F32), v4[:, ki].to(_F32)
            s = torch.einsum("bqhgd,bkhd->bhgqk", qblk, kblk)
            skip, s = _masked(s, causal, qi, ki, qc, kc, q_offset)
            if skip:
                continue
            p = torch.exp(s - lse_i[..., None])                       # (B,KV,G,qc,kc)
            dp = torch.einsum("bqhgd,bkhd->bhgqk", doblk, vblk)
            ds = p * (dp - delta_i[..., None])
            dq_i = dq_i + torch.einsum("bhgqk,bkhd->bqhgd", ds, kblk)
            dk[:, ki] += torch.einsum("bhgqk,bqhgd->bkhd", ds, qblk)
            dv[:, ki] += torch.einsum("bhgqk,bqhgd->bkhd", p, doblk)
        dqs.append(dq_i)
    dq = torch.cat(dqs, dim=1).reshape(B, Sq, H, D).to(q.dtype)
    return dq, dk.reshape(B, Skv, KV, D).to(k.dtype), dv.reshape(B, Skv, KV, D).to(v.dtype)


def _flash_rows(q, k, q_chunk: int, kv_chunk: int):
    """Ranges of batch rows whose float32 score block ``(b, KV, G, qc,
    kc)`` takes at most
    :data:`~repro_torch.sharding.collectives.PIECE_BYTES` (at least one
    row): the flash blocks run a range at a time, every row's arithmetic
    that of the whole batch's, so the live blocks of a wide layer stay a
    fraction of one sequence's."""
    B, Sq, H, _ = q.shape
    qc, kc = _chunk_size(Sq, q_chunk), _chunk_size(k.shape[1], kv_chunk)
    return row_pieces(B, H * qc * kc * 4)


class _Flash(torch.autograd.Function):
    """Flash attention core (q pre-scaled), the reference's custom-VJP
    ``_flash``: O(S) residuals, the backward pass recomputing score blocks
    from the saved log-sum-exp, so the score tensor never exists at O(S²)
    in either direction."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, q_chunk: int, kv_chunk: int, q_offset: int):
        ctx.args = (causal, q_chunk, kv_chunk, q_offset)
        ranges = _flash_rows(q, k, q_chunk, kv_chunk)
        parts = [_flash_forward(q[r0:r1], k[r0:r1], v[r0:r1], *ctx.args) for r0, r1 in ranges]
        if len(parts) == 1:
            out, lse = parts[0]
        else:
            out = torch.cat([o for o, _ in parts])
            lse = torch.cat([l for _, l in parts], dim=1)
        ctx.save_for_backward(q, k, v, out, lse)
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        ranges = _flash_rows(q, k, *ctx.args[1:3])
        parts = [_flash_backward(q[r0:r1], k[r0:r1], v[r0:r1], out[r0:r1], lse[:, r0:r1],
                                 do[r0:r1], *ctx.args) for r0, r1 in ranges]
        if len(parts) == 1:
            dq, dk, dv = parts[0]
        else:
            dq, dk, dv = (torch.cat(x) for x in zip(*parts))
        return dq, dk, dv, None, None, None, None


def chunked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      causal: bool = True, q_chunk: int = 512,
                      kv_chunk: int = 1024, q_offset: int = 0,
                      unroll: bool = False) -> torch.Tensor:
    """Flash attention.  q: (B,Sq,H,D), k/v: (B,Skv,KV,D) -> (B,Sq,H,D).

    KV blocks stream through an online-softmax accumulator and the backward
    pass recomputes score blocks, so live score memory is (B, KV, G, qc, kc)
    in both directions; fully masked causal blocks are skipped (their
    weights are exact zeros).  ``unroll=True`` is the reference's
    ``_attention_blocked_unrolled``: the same blocked forward, its gradient
    taken by autograd through every block (the reference's loop-free
    lowering for its cost analysis; ``launch/dryrun.py`` counts every loop
    trip either way)."""
    scale = q.shape[-1] ** -0.5
    if unroll:
        return _flash_forward(q * scale, k, v, causal, q_chunk, kv_chunk, q_offset)[0]
    return _Flash.apply(q * scale, k, v, causal, q_chunk, kv_chunk, q_offset)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
                     cache_len, softcap: float = 0.0) -> torch.Tensor:
    """Single-token attention against a (possibly partially filled) cache.

    q: (B, 1, H, D); caches: (B, T, KV, D); cache_len: an int or a () or
    (B,) tensor, the valid length (the new token's position is cache_len,
    attended inclusively).
    """
    B, _, H, D = q.shape
    _, T, KV, _ = k_cache.shape
    G = H // KV
    q5 = (q * D ** -0.5).reshape(B, KV, G, D)
    s = torch.einsum("bhgd,bkhd->bhgk", q5.to(_F32), k_cache.to(_F32))
    if softcap:
        s = torch.tanh(s / softcap) * softcap
    pos = torch.arange(T, device=q.device)
    valid = pos[None, :] <= torch.as_tensor(cache_len, device=q.device).reshape(-1, 1)
    s = torch.where(valid[:, None, None, :], s, torch.full((), -1e30, device=q.device))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhgk,bkhd->bhgd", p, v_cache.to(_F32))
    return out.reshape(B, 1, H, D).to(q.dtype)


# ---------------------------------------------------------------------------
# attention block (params + apply)
# ---------------------------------------------------------------------------

def attention_params(gen: torch.Generator, d_model: int, n_heads: int, n_kv: int,
                     head_dim: int, bias: bool = False, qk_norm: bool = False) -> Dict[str, Any]:
    dev = gen.device
    p = {
        "wq": dense_init(gen, d_model, n_heads * head_dim),
        "wk": dense_init(gen, d_model, n_kv * head_dim),
        "wv": dense_init(gen, d_model, n_kv * head_dim),
        "wo": dense_init(gen, n_heads * head_dim, d_model),
    }
    if bias:
        p["bq"] = torch.zeros((n_heads * head_dim,), dtype=_F32, device=dev)
        p["bk"] = torch.zeros((n_kv * head_dim,), dtype=_F32, device=dev)
        p["bv"] = torch.zeros((n_kv * head_dim,), dtype=_F32, device=dev)
    if qk_norm:
        p["q_norm"] = torch.ones((head_dim,), dtype=_F32, device=dev)
        p["k_norm"] = torch.ones((head_dim,), dtype=_F32, device=dev)
    return p


def _project_qkv(p, xq, xk, xv, n_heads, n_kv, head_dim, dtype, mats=None):
    """q from ``xq``, k from ``xk`` and v from ``xv`` (one stream for all
    three, or the cross-attention's ``kv_x`` for k and v); ``mats``: the
    three products already made (a split block's, ``Split.enter_columns``),
    to which the biases and norms are applied."""
    if mats is None:
        mats = (torch.matmul(xq, p["wq"].to(dtype)), torch.matmul(xk, p["wk"].to(dtype)),
                torch.matmul(xv, p["wv"].to(dtype)))
    q, k, v = mats
    B, S = q.shape[:2]
    Skv = k.shape[1]
    if "bq" in p:
        q, k, v = q + p["bq"].to(dtype), k + p["bk"].to(dtype), v + p["bv"].to(dtype)
    q = q.reshape(B, S, n_heads, head_dim)
    k = k.reshape(B, Skv, n_kv, head_dim)
    v = v.reshape(B, Skv, n_kv, head_dim)
    if "q_norm" in p:
        q = rms_norm(q, p["q_norm"])
        k = rms_norm(k, p["k_norm"])
    return q, k, v


def attention_apply(p: Dict[str, Any], x: torch.Tensor, *,
                    n_heads: int, n_kv: int, head_dim: int,
                    positions: Optional[torch.Tensor] = None,
                    rope_theta: float = 10_000.0, use_rope: bool = True,
                    causal: bool = True, kv_x: Optional[torch.Tensor] = None,
                    cache: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                    cache_len=None, q_chunk: int = 512, kv_chunk: int = 1024,
                    unroll: bool = False, constrain=None
                    ) -> Tuple[torch.Tensor, Optional[Tuple]]:
    """Full attention block.  Returns (out, new_cache).

    Modes:
      * training/prefill: cache=None -> chunked attention (causal unless
        ``causal=False``); if ``cache_len`` is given the computed k/v are
        returned for caching.
      * decode: cache=(k,v) -> write one token at ``cache_len`` (an int;
        the caches are updated in place) and attend.
      * cross: ``kv_x`` set, ``causal=False``, ``use_rope=False`` (the
        whisper decoder; its encoder is the same without ``kv_x``).
      * split (``constrain``): ``x`` is the stream in its layout, ``kv_x``
        whole on every rank (entered by the caller); the output is in the
        stream's layout (:func:`_attention_split`), and a prefill's k/v
        come back in the rules' cache layout (``Rules.cache_pspec``: this
        rank's sequence block where ``model`` divides the length, else
        whole).  A decode step's caches are such blocks, registered with
        their specs (``Split.bind``), and it attends by flash decoding
        (:func:`_attention_decode_split`).
    """
    kw = dict(positions=positions, rope_theta=rope_theta, use_rope=use_rope, causal=causal,
              q_chunk=q_chunk, kv_chunk=kv_chunk, unroll=unroll)
    if constrain is not None:
        if cache is not None:
            return _attention_decode_split(constrain, p, x, n_heads=n_heads, n_kv=n_kv,
                                           head_dim=head_dim, rope_theta=rope_theta,
                                           use_rope=use_rope, cache=cache, pos=int(cache_len))
        return _attention_split(constrain, p, x, n_heads=n_heads, n_kv=n_kv,
                                head_dim=head_dim, kv_x=kv_x, cache_len=cache_len, **kw)
    kv = kv_x if kv_x is not None else x
    return _attend(p, x, kv, kv, n_heads=n_heads, n_kv=n_kv, head_dim=head_dim, cache=cache,
                   cache_len=cache_len, **kw)


def _attend(p, xq, xk, xv, *, n_heads, n_kv, head_dim, positions, rope_theta, use_rope,
            causal, cache, cache_len, q_chunk, kv_chunk, unroll, mats=None):
    """The attention block's body on whole inputs (:func:`attention_apply`
    less the split): q from ``xq``, k and v from ``xk`` and ``xv``, or the
    projections ``mats`` (:func:`_project_qkv`)."""
    dtype = xq.dtype
    q, k, v = _project_qkv(p, xq, xk, xv, n_heads, n_kv, head_dim, dtype, mats)

    new_cache = None
    if cache is not None:
        k_cache, v_cache = cache
        pos = int(cache_len)
        if use_rope:
            at = torch.full((1, 1), pos, dtype=torch.int32, device=xq.device)
            q = apply_rope(q, at, rope_theta)
            k = apply_rope(k, at, rope_theta)
        k_cache[:, pos:pos + 1] = k.to(k_cache.dtype)
        v_cache[:, pos:pos + 1] = v.to(v_cache.dtype)
        out = decode_attention(q, k_cache.to(dtype), v_cache.to(dtype), pos)
        new_cache = (k_cache, v_cache)
    else:
        if use_rope:
            if positions is None:
                positions = torch.arange(q.shape[1], device=q.device)
            q = apply_rope(q, positions, rope_theta)
            k = apply_rope(k, positions, rope_theta)
        out = chunked_attention(q, k, v, causal=causal, q_chunk=q_chunk,
                                kv_chunk=kv_chunk, unroll=unroll)
        if cache_len is not None:           # prefill: hand k/v to the caller
            new_cache = (k, v)
    out = out.reshape(out.shape[0], out.shape[1], n_heads * head_dim)
    out = torch.matmul(out, p["wo"].to(dtype))
    return out, new_cache


def _heads_to_cache(c, x):
    """A prefill's keys or values of this rank's heads, ``(B, S, KV/tp,
    hd)`` over the whole sequence, in the cache layout: one all-to-all
    from heads to sequence blocks (block i of the sequence to rank i)
    where ``model`` divides S, else all-gathered whole."""
    B, S, kb, hd = x.shape
    if c.tp == 1:
        return x
    if S % c.tp:
        return c.model_gather(x, 2)
    sb = S // c.tp
    got = all_to_all(x.transpose(0, 1).contiguous(), c.model)     # block i: rank i's heads
    return got.reshape(c.tp, sb, B, kb, hd).permute(2, 1, 0, 3, 4).reshape(B, sb, c.tp * kb, hd)


def _attention_split(c, p, x, *, n_heads, n_kv, head_dim, kv_x, positions, rope_theta,
                     use_rope, causal, q_chunk, kv_chunk, unroll, cache_len=None):
    """The attention block split over ``model`` (``c`` the stream's split
    context).  Where both head counts divide ``model``: heads, the stream
    entered whole (the sequence all-gathered under SP) into
    :func:`_attend` with this rank's column blocks of ``wq``/``wk``/``wv``
    and row block of ``wo``, the partial output left by a reduce-scatter.
    Otherwise the sequence: this rank's query block (the stream's block
    under SP) with ``wq``/``wk``/``wv``/``wo`` gathered over ``model``
    against the keys and values of every block, all-gathered (a causal
    block skips what lies after it, so the last rank works most).  With
    ``cache_len`` (prefill) returns ``(out, (k, v))``, the keys and values
    in the cache layout: the sequence split's own block, or the head
    split's heads moved to sequence blocks (:func:`_heads_to_cache`);
    else ``(out, None)``."""
    tp = c.tp
    qcols, kvcols = n_heads * head_dim, n_kv * head_dim
    norms = ({"q_norm": c.tp_rep(p["q_norm"]), "k_norm": c.tp_rep(p["k_norm"])}
             if "q_norm" in p else {})
    if tp == 1 or (n_heads % tp == 0 and n_kv % tp == 0):
        pb = {"wq": c.block(p["wq"], 1, qcols), "wk": c.block(p["wk"], 1, kvcols),
              "wv": c.block(p["wv"], 1, kvcols), "wo": c.block(p["wo"], 0, qcols), **norms}
        if "bq" in p:
            pb.update(bq=c.block(p["bq"], 0, qcols), bk=c.block(p["bk"], 0, kvcols),
                      bv=c.block(p["bv"], 0, kvcols))
        ws = [pb[k].to(x.dtype) for k in ("wq", "wk", "wv")]
        if kv_x is None:
            mats = c.enter_columns(x, ws)
        else:
            mats = (*c.enter_columns(x, ws[:1]), torch.matmul(kv_x, ws[1]),
                    torch.matmul(kv_x, ws[2]))
        out, kv = _attend(pb, x, kv_x, kv_x, mats=mats, n_heads=n_heads // tp, n_kv=n_kv // tp,
                          head_dim=head_dim, positions=positions, rope_theta=rope_theta,
                          use_rope=use_rope, causal=causal, cache=None, cache_len=cache_len,
                          q_chunk=q_chunk, kv_chunk=kv_chunk, unroll=unroll)
        if kv is not None:
            kv = (_heads_to_cache(c, kv[0]), _heads_to_cache(c, kv[1]))
        return c.leave(out), kv
    # the sequence split: this rank's queries (the stream's block under SP)
    whole_x = not c.sp
    if whole_x and x.shape[1] % tp:
        raise ValueError(f"attention of {n_heads}/{n_kv} heads splits over model of {tp} "
                         f"only by its sequence, and {x.shape[1]} positions do not divide")
    xb = split_ag(x, c.model, dim=1) if whole_x else x
    B, sb = xb.shape[:2]
    off = c.q_offset(sb)
    pw = {"wq": c.whole(p["wq"], 1, qcols), "wk": c.whole(p["wk"], 1, kvcols),
          "wv": c.whole(p["wv"], 1, kvcols), **norms}
    if "bq" in p:
        pw.update(bq=c.tp_rep(p["bq"]), bk=c.tp_rep(p["bk"]), bv=c.tp_rep(p["bv"]))
    xkv = xb if kv_x is None else kv_x
    q, k, v = _project_qkv(pw, xb, xkv, xkv, n_heads, n_kv, head_dim, x.dtype)
    if use_rope:
        pos = (positions if positions is not None
               else torch.arange(x.shape[1] * (tp if c.sp else 1), device=x.device))
        pos = pos[..., off:off + sb]                 # this block's positions
        q = apply_rope(q, pos, rope_theta)
        if kv_x is None:
            k = apply_rope(k, pos, rope_theta)
    kv = (k, v) if cache_len is not None else None     # this block's: the cache layout
    if kv_x is None:
        # every block's keys and values: their gradient, each rank's
        # queries' part, reduce-scattered back to the block
        k, v = all_gather_rs(k, c.model, dim=1), all_gather_rs(v, c.model, dim=1)
    out = chunked_attention(q, k, v, causal=causal, q_chunk=q_chunk, kv_chunk=kv_chunk,
                            q_offset=off if causal else 0, unroll=unroll)
    out = torch.matmul(out.reshape(B, sb, qcols), c.whole(p["wo"], 0, qcols).to(x.dtype))
    return (all_gather_split(out, c.model, dim=1) if whole_x else out), kv


def whole_columns(c, x, w, b, cols: int) -> torch.Tensor:
    """``x @ w (+ b)`` with all ``cols`` columns on every rank: this
    rank's column block of ``w`` (the rules cut its columns over
    ``model``) all-gathered over ``model``, else ``w`` whole."""
    cut = c.is_cut(w, 1, cols)
    y = torch.matmul(x, w.to(x.dtype))
    if b is not None:
        y = y + (c.block(b, 0, cols) if cut else b).to(x.dtype)
    return c.model_gather(y, -1) if cut else y


def _flash_decode(c, q, k_blk, v_blk, last: int) -> torch.Tensor:
    """:func:`decode_attention` of one token over a cache whose sequence
    is cut over ``model``: this rank scores its block ``(B, Tb, KV, D)``,
    masking its positions after ``last`` (the last valid one in the
    block's own coordinates: below 0 masks the whole block, past its end
    none) with ``-1e30``; the row max comes from an all-reduce MAX over
    ``model`` and the exponentials' sums and the weighted values from one
    ordered sum.  A block wholly masked scores ``-1e30`` against the real
    max of position 0 (rank 0's, always valid), so its weights are exact
    zeros and add nothing."""
    B, _, H, D = q.shape
    Tb, KV = k_blk.shape[1], k_blk.shape[2]
    q5 = (q * D ** -0.5).reshape(B, KV, H // KV, D)
    s = torch.einsum("bhgd,bkhd->bhgk", q5.to(_F32), k_blk.to(_F32))
    valid = torch.arange(Tb, device=q.device) <= last
    s = torch.where(valid, s, torch.full((), -1e30, device=q.device))
    m = c.model_max(s.amax(-1))                                       # (B, KV, G)
    p = torch.exp(s - m[..., None])
    acc = torch.einsum("bhgk,bkhd->bhgd", p, v_blk.to(_F32))
    tot = all_reduce_id(torch.cat([acc, p.sum(-1)[..., None]], dim=-1), c.model)
    out = tot[..., :D] / tot[..., D:]
    return out.reshape(B, 1, H, D).to(q.dtype)


def _attend_cache(c, q, k_cache, v_cache, last: int, dtype) -> torch.Tensor:
    """One token's attention over a decode cache: flash decoding where the
    rules cut its sequence over ``model`` (``last`` a global position),
    else :func:`decode_attention` on the whole cache."""
    off = c.cache_offset(k_cache)
    if off is None:
        return decode_attention(q, k_cache.to(dtype), v_cache.to(dtype), last)
    return _flash_decode(c, q, k_cache.to(dtype), v_cache.to(dtype), last - off)


def _rows_out(c, out, wo, rows: int) -> torch.Tensor:
    """``out @ wo`` for ``out`` whole on every rank: this rank's row block
    of ``wo`` (the rules cut its rows over ``model``) on its columns of
    ``out``, the partial left (an ordered all-reduce), else ``wo``
    whole."""
    if not c.is_cut(wo, 0, rows):
        return torch.matmul(out, wo.to(out.dtype))
    rb = wo.shape[0]
    return c.leave(torch.matmul(out[..., c.rank * rb:(c.rank + 1) * rb], wo.to(out.dtype)))


def _attention_decode_split(c, p, x, *, n_heads, n_kv, head_dim, rope_theta, use_rope,
                            cache, pos: int):
    """One decode step of the attention block under a split (``c`` the
    one-token stream's context, ``x`` ``(B, 1, D)`` whole on every
    ``model`` rank): the token's q/k/v from this rank's column blocks of
    ``wq``/``wk``/``wv``, all-gathered over ``model`` to whole heads (a
    few kilobytes a token), rotary at the global position ``pos``; the
    rank whose cache block holds ``pos`` writes the token's k/v into it in
    place; flash decoding over the blocks (:func:`_attend_cache`); the
    output through this rank's row block of ``wo``, left."""
    B, dtype = x.shape[0], x.dtype
    qcols, kvcols = n_heads * head_dim, n_kv * head_dim
    q = whole_columns(c, x, p["wq"], p.get("bq"), qcols).reshape(B, 1, n_heads, head_dim)
    k = whole_columns(c, x, p["wk"], p.get("bk"), kvcols).reshape(B, 1, n_kv, head_dim)
    v = whole_columns(c, x, p["wv"], p.get("bv"), kvcols).reshape(B, 1, n_kv, head_dim)
    if "q_norm" in p:
        q, k = rms_norm(q, p["q_norm"]), rms_norm(k, p["k_norm"])
    if use_rope:
        at = torch.full((1, 1), pos, dtype=torch.int32, device=x.device)
        q, k = apply_rope(q, at, rope_theta), apply_rope(k, at, rope_theta)
    k_cache, v_cache = cache
    local = pos - (c.cache_offset(k_cache) or 0)
    if 0 <= local < k_cache.shape[1]:                   # this rank's block holds pos
        k_cache[:, local:local + 1] = k.to(k_cache.dtype)
        v_cache[:, local:local + 1] = v.to(v_cache.dtype)
    out = _attend_cache(c, q, k_cache, v_cache, pos, dtype)
    return _rows_out(c, out.reshape(B, 1, qcols), p["wo"], qcols), cache


def cross_decode(p: Dict[str, Any], x: torch.Tensor, xcache, *, n_heads: int, head_dim: int,
                 constrain=None) -> torch.Tensor:
    """One token's cross-attention against precomputed keys and values
    ``xcache = (xk, xv)`` ``(B, T, KV, hd)``, every position attended (the
    whisper decoder's decode step): q from ``wq`` + ``bq``, no rotary, the
    output through ``wo``.  With ``constrain`` (the one-token stream's
    split context) the caches are blocks in the rules' layout, attended as
    :func:`_attention_decode_split` attends (nothing written)."""
    B, S, _ = x.shape
    qcols = n_heads * head_dim
    xk, xv = xcache
    if constrain is None:
        q = torch.matmul(x, p["wq"].to(x.dtype)) + p["bq"].to(x.dtype)
        out = decode_attention(q.reshape(B, S, n_heads, head_dim), xk.to(x.dtype),
                               xv.to(x.dtype), xk.shape[1] - 1)
        return torch.matmul(out.reshape(B, S, qcols), p["wo"].to(x.dtype))
    c = constrain
    q = whole_columns(c, x, p["wq"], p["bq"], qcols).reshape(B, S, n_heads, head_dim)
    total = xk.shape[1] * (c.tp if c.cache_offset(xk) is not None else 1)
    out = _attend_cache(c, q, xk, xv, total - 1, x.dtype)
    return _rows_out(c, out.reshape(B, S, qcols), p["wo"], qcols)


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------

def mlp_params(gen: torch.Generator, d_model: int, d_ff: int,
               act: str = "silu", bias: bool = False) -> Dict[str, Any]:
    p = {"wi": dense_init(gen, d_model, d_ff),
         "wo": dense_init(gen, d_ff, d_model)}
    if act == "silu":
        p["wg"] = dense_init(gen, d_model, d_ff)
    if bias:
        p["bi"] = torch.zeros((d_ff,), dtype=_F32, device=gen.device)
        p["bo"] = torch.zeros((d_model,), dtype=_F32, device=gen.device)
    return p


def mlp_apply(p: Dict[str, Any], x: torch.Tensor, act: str = "silu",
              constrain=None) -> torch.Tensor:
    """Gated (silu) or plain (gelu) MLP; ``bi``/``bo`` biases where the
    parameters carry them (``mlp_params(bias=True)``, the whisper blocks).

    With ``constrain`` (the stream's split context) and d_ff divisible by
    ``model``: Megatron's column-split ``wi``/``wg`` and row-split ``wo``,
    the stream entered whole and the partial output left (a reduce-scatter
    of the sequence under SP, else an all-reduce); otherwise each rank
    runs the whole MLP on its sequence block (or, on a whole stream, the
    whole of it)."""
    dtype = x.dtype
    wi, wo, wg, bi, bo = p["wi"], p["wo"], p.get("wg"), p.get("bi"), p.get("bo")
    c = constrain
    split = c is not None and c.tp > 1 and c.cfg.d_ff % c.tp == 0
    g = None
    if split:
        f = c.cfg.d_ff
        wi, wo = c.block(wi, 1, f), c.block(wo, 0, f)
        wg = c.block(wg, 1, f) if wg is not None else None
        bi = c.block(bi, 0, f) if bi is not None else None
        cols = [wi.to(dtype)] + ([wg.to(dtype)] if wg is not None else [])
        h, *gs = c.enter_columns(x, cols)
        g = gs[0] if gs else None
    else:
        if c is not None and c.sp:
            f = c.cfg.d_ff
            wi, wo = c.whole(wi, 1, f), c.whole(wo, 0, f)
            wg = c.whole(wg, 1, f) if wg is not None else None
            bi = c.tp_rep(bi) if bi is not None else None
        h = torch.matmul(x, wi.to(dtype))
    if bi is not None:
        h = h + bi.to(dtype)
    if act == "silu":
        if g is None:
            g = torch.matmul(x, wg.to(dtype))
        h = F.silu(g) * h
    else:
        h = F.gelu(h, approximate="tanh")     # jax.nn.gelu's default
    out = torch.matmul(h, wo.to(dtype))
    if split:
        out = c.leave(out)
    if bo is not None:
        out = out + (c.rep(bo) if c is not None else bo).to(dtype)
    return out


# ---------------------------------------------------------------------------
# loss
# ---------------------------------------------------------------------------

def _ce_chunk(hb, lb, w, softcap: float, transpose_w: bool):
    """(sum of masked token losses, token count) of one sequence chunk."""
    wt = w.to(hb.dtype)
    logits = torch.matmul(hb, wt.t() if transpose_w else wt).to(_F32)
    if softcap:
        logits = torch.tanh(logits / softcap) * softcap
    logz = torch.logsumexp(logits, dim=-1)
    tgt = torch.gather(logits, -1, torch.clamp_min(lb, 0)[..., None].long())[..., 0]
    mask = (lb >= 0).to(_F32)
    return torch.sum((logz - tgt) * mask), mask.sum()


class _VocabCE(torch.autograd.Function):
    """:func:`_ce_chunk` on this rank's vocabulary block ``[v0, v0 + V_b)``
    of ``w``: the max, the sum of exponentials and the target's logit
    combined over ``group`` (the max exactly, the sums in rank order), so
    every rank has every token's loss, the same bits.  Only the chunk's
    log-sum-exp is kept for the backward, which recomputes the logits and
    takes their gradient in place, each sum in the order autograd adds it:
    ``exp(l − lse)·g`` with the target's ``−g`` added at its index, through
    the soft cap where one is set (``tanh``'s gradient ``1 − tanh²``
    between the two scalings), then the product's gradients by autograd.
    The chunks of one loss share ``acc``: each adds its gradient of ``w``
    into one float32 sum in the order their backwards run (autograd's
    order), and the last returns it, so a chunk's backward holds one
    float32 logits block (two with a soft cap) and one float32 gradient of
    the vocabulary block, not the several that autograd and a checkpoint's
    recompute hold."""

    @staticmethod
    def forward(ctx, hb, w, lb, softcap: float, transpose_w: bool, v0: int, group, acc):
        wt = w.to(hb.dtype)
        logits = torch.matmul(hb, wt.t() if transpose_w else wt).to(_F32)
        if softcap:
            logits = torch.tanh(logits / softcap) * softcap
        vb = logits.shape[-1]
        m = all_reduce_max(logits.amax(dim=-1), group)
        se = all_reduce_id((logits - m[..., None]).exp_().sum(dim=-1), group)
        lse = torch.log(se) + m
        local = lb.long() - v0
        inside = (local >= 0) & (local < vb)
        idx = local.clamp(0, vb - 1)
        tgt = torch.gather(logits, -1, idx[..., None])[..., 0]
        zero = torch.zeros((), dtype=_F32, device=tgt.device)
        tgt = all_reduce_id(torch.where(inside, tgt, zero), group)
        mask = (lb >= 0).to(_F32)
        ctx.save_for_backward(hb, w, lse, idx, inside, mask)
        ctx.softcap, ctx.transpose_w, ctx.acc = softcap, transpose_w, acc
        acc["left"] += 1
        return torch.sum((lse - tgt) * mask), mask.sum()

    @staticmethod
    def backward(ctx, g, _):
        hb, w, lse, idx, inside, mask = ctx.saved_tensors
        softcap = ctx.softcap
        with torch.enable_grad():
            h_ = hb.detach().requires_grad_()
            wt = w.detach().to(hb.dtype).requires_grad_()
            out = torch.matmul(h_, wt.t() if ctx.transpose_w else wt)
        zero = torch.zeros((), dtype=_F32, device=g.device)
        gt = g.expand(mask.shape) * mask                  # d(sum((lse − tgt)·mask))
        d = out.detach().to(_F32)                        # the logits, then their gradient
        if softcap:
            t = torch.tanh(d / softcap)
            d = t * softcap
        d.sub_(lse[..., None]).exp_().mul_(gt[..., None])
        d.add_(0.0)                                       # + the gather's zeros
        d.scatter_add_(-1, idx[..., None], (zero + torch.where(inside, -gt, zero))[..., None])
        if softcap:                                       # (· softcap), tanh, (/ softcap)
            d = torch.ops.aten.tanh_backward(d.mul_(softcap), t).div_(softcap)
            del t
        d = d.to(out.dtype)                               # the float32 block freed here
        dh, dwt = torch.autograd.grad(out, (h_, wt), d)
        del d, out
        acc = ctx.acc
        if acc.get("w") is None:
            acc["w"] = dwt.to(w.dtype)                    # the cast's backward
        else:
            acc["w"].add_(dwt)                            # autograd's sum, in place
        acc["left"] -= 1
        return (dh, (acc.pop("w") if not acc["left"] else None), None, None, None, None, None,
                None)


def _loss_chunk(S: int, chunk: int) -> int:
    """The loss's chunk length: the largest divisor of ``S`` up to ``chunk``."""
    c = min(chunk, S)
    while S % c:
        c -= 1
    return c


def chunked_cross_entropy(h: torch.Tensor, w: torch.Tensor, labels: torch.Tensor,
                          softcap: float = 0.0, chunk: int = 512,
                          transpose_w: bool = False, constrain=None) -> torch.Tensor:
    """Mean next-token CE without materializing full (B, S, V) logits.

    h: (B, S, D); w: (D, V) (or (V, D) with transpose_w); labels: (B, S),
    -1 = masked.  Walks sequence chunks; under autograd each chunk's logits
    are recomputed in the backward pass (``torch.utils.checkpoint``),
    bounding live logit memory to (B, chunk, V).

    With ``constrain`` (the stream's split context; ``w`` this rank's
    block, gathered here over the data-parallel axes): where the rules cut
    the vocabulary over ``model``, the stream is entered whole and each
    rank takes the logits of its vocabulary block (vocabulary-parallel);
    a sequence-sharded stream is gathered once, in its own dtype, as the
    chunks, each chunk's gradient summed straight into the blocks that hold
    it (:meth:`Split.enter_chunks
    <repro_torch.sharding.split.Split.enter_chunks>`), and each chunk
    keeps only its log-sum-exp (:class:`_VocabCE`, no checkpoint).
    Otherwise (a ``model`` size that does not divide the vocabulary) every
    rank takes the whole loss.
    """
    c = constrain
    vocab = None
    if c is not None:
        w = c.gather(w)
        vocab = c.vocab_block(w, 0 if transpose_w else 1)
        if vocab is None:
            h = c.redundant(h)
    if vocab is not None:
        size = _loss_chunk(labels.shape[1], chunk)
        hs = c.enter_chunks(h, size)
        vocab = (vocab[0], c.model)
    else:
        size = _loss_chunk(h.shape[1], chunk)
        hs = [h[:, i * size:(i + 1) * size] for i in range(h.shape[1] // size)]
    return _cross_entropy_chunks(hs, size, w, labels, softcap, transpose_w, vocab)


def _cross_entropy_chunks(hs, c, w, labels, softcap, transpose_w, vocab=None):
    tot = torch.zeros((), dtype=_F32, device=w.device)
    cnt = torch.zeros((), dtype=_F32, device=w.device)
    acc = {"left": 0}
    for i, hb in enumerate(hs):
        lb = labels[:, i * c:(i + 1) * c]
        if vocab is not None:
            part, n = _VocabCE.apply(hb, w, lb, softcap, transpose_w, *vocab, acc)
        elif torch.is_grad_enabled():
            part, n = checkpoint(_ce_chunk, hb, lb, w, softcap, transpose_w,
                                 use_reentrant=False)
        else:
            part, n = _ce_chunk(hb, lb, w, softcap, transpose_w)
        tot, cnt = tot + part, cnt + n
    return tot / torch.clamp_min(cnt, 1.0)


class _VocabLookup(torch.autograd.Function):
    """``where(inside, w[local], 0)`` in ``dtype``, a vocabulary block's
    part of a lookup, made a piece of batch rows at a time (no float32
    copy of the whole lookup is made); the gradient of ``w`` accumulated
    piece by piece, rows in order, by ``index_put_``, as the plain
    lookup's backward accumulates all of them at once."""

    @staticmethod
    def forward(ctx, w, local, inside, dtype):
        ctx.save_for_backward(local, inside)
        ctx.w_shape, ctx.w_dtype = w.shape, w.dtype
        out = torch.empty(tuple(local.shape) + (w.shape[1],), dtype=dtype, device=w.device)
        zero = torch.zeros((), dtype=dtype, device=w.device)
        row = local[0].numel() * w.shape[1] * w.element_size()
        for r0, r1 in row_pieces(local.shape[0], row):
            e = w[local[r0:r1]].to(dtype)
            out[r0:r1] = torch.where(inside[r0:r1, ..., None], e, zero)
        return out

    @staticmethod
    def backward(ctx, g):
        local, inside = ctx.saved_tensors
        gw = torch.zeros(ctx.w_shape, dtype=ctx.w_dtype, device=g.device)
        zero = torch.zeros((), dtype=g.dtype, device=g.device)
        row = local[0].numel() * ctx.w_shape[1] * gw.element_size()
        for r0, r1 in row_pieces(local.shape[0], row):
            gp = torch.where(inside[r0:r1, ..., None], g[r0:r1], zero).to(gw.dtype)
            gw.index_put_((local[r0:r1],), gp, accumulate=True)
        return gw, None, None, None


def embed_lookup(w: torch.Tensor, tokens: torch.Tensor, dtype, constrain=None, *,
                 whole: bool = False) -> torch.Tensor:
    """``w[tokens]`` in ``dtype``.  With ``constrain`` (``w`` this rank's
    block, gathered here over the data-parallel axes) and the vocabulary
    cut over ``model``: each rank looks up the tokens of its vocabulary
    block (zeros elsewhere, :class:`_VocabLookup`) and the parts are
    summed over ``model`` (one term of each sum is not zero, so the sum is
    the lookup's bits): on a sequence-sharded stream reduce-scattered
    straight into this rank's sequence block (Megatron's sequence-parallel
    embedding), else all-reduced, whole on every rank.  ``whole``: the
    all-reduce on any stream, for a caller that adds to the whole lookup
    before laying it out.  Otherwise the lookup is whole and the caller
    lays it out by ``constrain(h, "act")``, which takes a block as it
    is."""
    if constrain is None:
        return w[tokens.long()].to(dtype)
    w = constrain.gather(w)
    vocab = constrain.vocab_block(w, 0)
    if vocab is None:
        return w[tokens.long()].to(dtype)
    v0, n = vocab
    local = tokens.long() - v0
    inside = (local >= 0) & (local < n)
    e = _VocabLookup.apply(w, local.clamp(0, n - 1), inside, dtype)
    if constrain.sp and not whole:
        return reduce_scatter_ag(e, constrain.model, dim=1)
    return all_reduce_id(e, constrain.model)


def lm_logits(h: torch.Tensor, w: torch.Tensor, *, transpose_w: bool = False,
              softcap: float = 0.0, constrain=None) -> torch.Tensor:
    """``h @ w`` (``w`` ``(D, V)``, or ``(V, D)`` with ``transpose_w``) in
    ``h``'s dtype, soft-capped where ``softcap`` is set.  With ``constrain``
    (``h`` whole on every rank, ``w`` this rank's block, gathered here over
    the data-parallel axes) and the vocabulary cut over ``model``: this
    rank's vocabulary block of the logits, all-gathered over ``model``, so
    every rank returns them whole."""
    c = constrain
    if c is not None:
        w = c.gather(w)
    wt = w.to(h.dtype)
    logits = torch.matmul(h, wt.t() if transpose_w else wt)
    if c is not None and c.vocab_block(w, 0 if transpose_w else 1) is not None:
        logits = c.model_gather(logits, -1)
    if softcap:
        logits = torch.tanh(logits / softcap) * softcap
    return logits


# ---------------------------------------------------------------------------
# layer loop
# ---------------------------------------------------------------------------

def _keep_matmuls(ctx, op, *args, **kwargs):
    """The ``"dots"`` policy: keep the outputs of the matmuls without batch
    dimensions (the projections, ``aten.mm``), recompute the rest (the
    attention blocks' batched products included), as the reference's
    ``checkpoint_dots_with_no_batch_dims``."""
    if op in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default):
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def stack_layers(gen: torch.Generator, cfg, layer_init: Callable, n: int) -> Dict[str, Any]:
    """``n`` draws of ``layer_init(gen, cfg)`` stacked on a leading axis, as
    the reference's ``jax.vmap`` init stacks its layers."""
    per_layer = [layer_init(gen, cfg) for _ in range(n)]
    return pytree.tree_map(lambda *xs: torch.stack(xs), *per_layer)


def scan_or_unroll(body: Callable, carry, xs, *, remat: str = "none", constrain=None,
                   gather: bool = True):
    """Run ``body(carry, xs_slice)`` over the leading axis of the tree
    ``xs`` (the stacked layers), the reference's ``lax.scan``/unroll as a
    loop; the slices are taken by one ``unbind`` a leaf (a slice's
    gradient is then one stack, where indexing a layer at a time would make
    a gradient of the whole stack a layer).  Under autograd ``remat`` picks
    what a layer keeps for the backward pass: ``"none"`` everything,
    ``"full"`` only its input (the layer recomputed,
    ``torch.utils.checkpoint``), ``"dots"`` its matmul outputs (a
    selective checkpoint).  Returns ``(carry, ys)``, ``ys`` the list of the
    bodies' second outputs, or None.

    With ``constrain`` (a split context) ``xs`` holds this rank's blocks:
    each body gathers its own slice over the data-parallel axes first
    (``gather=False``: it does not, for an outer loop whose body loops
    again), inside the checkpoint, so the backward gathers again and no
    two layers are gathered at once under remat; the gradient leaves each
    layer as this rank's block."""
    if remat not in ("none", "full", "dots"):
        raise ValueError(f"remat must be 'none', 'full' or 'dots', got {remat!r}")
    fn = body
    if constrain is not None and gather:
        def fn(c, lp):
            return body(c, constrain.gather(lp))
    step = fn
    if remat != "none" and torch.is_grad_enabled():
        kw = {"use_reentrant": False}
        if remat == "dots":
            kw["context_fn"] = functools.partial(create_selective_checkpoint_contexts,
                                                 _keep_matmuls)
        step = functools.partial(checkpoint, fn, **kw)
    if constrain is not None:
        slices = constrain.slices(xs)
    else:
        leaves = pytree.leaves(xs)
        slices = [pytree.unflatten(xs, list(row))
                  for row in zip(*(x.unbind(0) for x in leaves))]
    ys: List[Any] = []
    for lp in slices:
        carry, y = step(carry, lp)
        ys.append(y)
    return carry, (ys if ys and ys[0] is not None else None)
