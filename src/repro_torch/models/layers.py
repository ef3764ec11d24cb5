"""Shared model building blocks of the dense family: norms, rotary, chunked
(flash-style) attention with GQA, gated MLPs, the chunked loss and the
layer loop.

Port of the JAX package's ``models/layers.py``: plain functions over dicts
of tensors, the weights in the reference's ``(d_in, d_out)`` layout applied
as ``x @ W`` (the arrowhead preconditioner samples flat coordinates of each
leaf, so a transposed leaf would sketch other entries).  Norms, rotary and
softmax statistics compute in float32 and cast back.  Attention never
materializes the ``(S, S)`` score matrix: key/value blocks stream through
an online-softmax accumulator, and the backward pass recomputes score
blocks from the saved log-sum-exp (:class:`_Flash`).
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

__all__ = [
    "dense_init", "embed_init", "rms_norm", "layer_norm", "apply_rope",
    "chunked_attention", "decode_attention", "attention_params",
    "attention_apply", "mlp_params", "mlp_apply", "norm_params", "norm_apply",
    "chunked_cross_entropy", "scan_or_unroll",
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


def norm_apply(p: Dict[str, torch.Tensor], x: torch.Tensor, kind: str = "rms"):
    if kind == "layernorm":
        return layer_norm(x, p["scale"], p["bias"])
    return rms_norm(x, p["scale"])


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


class _Flash(torch.autograd.Function):
    """Flash attention core (q pre-scaled), the reference's custom-VJP
    ``_flash``: O(S) residuals, the backward pass recomputing score blocks
    from the saved log-sum-exp, so the score tensor never exists at O(S²)
    in either direction."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, q_chunk: int, kv_chunk: int, q_offset: int):
        out, lse = _flash_forward(q, k, v, causal, q_chunk, kv_chunk, q_offset)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.args = (causal, q_chunk, kv_chunk, q_offset)
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = _flash_backward(q, k, v, out, lse, do, *ctx.args)
        return dq, dk, dv, None, None, None, None


def chunked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      causal: bool = True, q_chunk: int = 512,
                      kv_chunk: int = 1024, q_offset: int = 0,
                      unroll: bool = False) -> torch.Tensor:
    """Flash attention.  q: (B,Sq,H,D), k/v: (B,Skv,KV,D) -> (B,Sq,H,D).

    KV blocks stream through an online-softmax accumulator and the backward
    pass recomputes score blocks, so live score memory is (B, KV, G, qc, kc)
    in both directions; fully masked causal blocks are skipped (their
    weights are exact zeros).  ``unroll=True`` is the reference's loop-free
    lowering for its cost-analysis harness (``launch/dryrun.py``), not
    ported yet."""
    if unroll:
        raise NotImplementedError("unroll=True serves launch/dryrun.py's cost analysis, "
                                  "which is not ported yet")
    scale = q.shape[-1] ** -0.5
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


def _project_qkv(p, x, n_heads, n_kv, head_dim, dtype):
    B, S, _ = x.shape
    q = torch.matmul(x, p["wq"].to(dtype))
    k = torch.matmul(x, p["wk"].to(dtype))
    v = torch.matmul(x, p["wv"].to(dtype))
    if "bq" in p:
        q, k, v = q + p["bq"].to(dtype), k + p["bk"].to(dtype), v + p["bv"].to(dtype)
    q = q.reshape(B, S, n_heads, head_dim)
    k = k.reshape(B, S, n_kv, head_dim)
    v = v.reshape(B, S, n_kv, head_dim)
    if "q_norm" in p:
        q = rms_norm(q, p["q_norm"])
        k = rms_norm(k, p["k_norm"])
    return q, k, v


def attention_apply(p: Dict[str, Any], x: torch.Tensor, *,
                    n_heads: int, n_kv: int, head_dim: int,
                    positions: Optional[torch.Tensor] = None,
                    rope_theta: float = 10_000.0,
                    cache: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                    cache_len=None, q_chunk: int = 512, kv_chunk: int = 1024,
                    unroll: bool = False) -> Tuple[torch.Tensor, Optional[Tuple]]:
    """Causal self-attention block with rotary positions.  Returns (out,
    new_cache).

    Modes:
      * training/prefill: cache=None -> chunked causal attention; if
        ``cache_len`` is given the computed k/v are returned for caching.
      * decode: cache=(k,v) -> write one token at ``cache_len`` (an int;
        the caches are updated in place) and attend.

    The reference's cross-attention mode (``kv_x``, no rope, not causal)
    serves the whisper decoder and comes with ``models/whisper.py``.
    """
    dtype = x.dtype
    q, k, v = _project_qkv(p, x, n_heads, n_kv, head_dim, dtype)

    new_cache = None
    if cache is not None:
        k_cache, v_cache = cache
        pos = int(cache_len)
        at = torch.full((1, 1), pos, dtype=torch.int32, device=x.device)
        q = apply_rope(q, at, rope_theta)
        k = apply_rope(k, at, rope_theta)
        k_cache[:, pos:pos + 1] = k.to(k_cache.dtype)
        v_cache[:, pos:pos + 1] = v.to(v_cache.dtype)
        out = decode_attention(q, k_cache.to(dtype), v_cache.to(dtype), pos)
        new_cache = (k_cache, v_cache)
    else:
        if positions is None:
            positions = torch.arange(x.shape[1], device=x.device)
        q = apply_rope(q, positions, rope_theta)
        k = apply_rope(k, positions, rope_theta)
        out = chunked_attention(q, k, v, causal=True, q_chunk=q_chunk,
                                kv_chunk=kv_chunk, unroll=unroll)
        if cache_len is not None:           # prefill: hand k/v to the caller
            new_cache = (k, v)
    out = out.reshape(out.shape[0], out.shape[1], n_heads * head_dim)
    out = torch.matmul(out, p["wo"].to(dtype))
    return out, new_cache


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------

def mlp_params(gen: torch.Generator, d_model: int, d_ff: int,
               act: str = "silu") -> Dict[str, Any]:
    p = {"wi": dense_init(gen, d_model, d_ff),
         "wo": dense_init(gen, d_ff, d_model)}
    if act == "silu":
        p["wg"] = dense_init(gen, d_model, d_ff)
    return p


def mlp_apply(p: Dict[str, Any], x: torch.Tensor, act: str = "silu") -> torch.Tensor:
    """Gated (silu) or plain (gelu) MLP; ``bi``/``bo`` biases where the
    parameters carry them (the reference's whisper blocks)."""
    dtype = x.dtype
    h = torch.matmul(x, p["wi"].to(dtype))
    if "bi" in p:
        h = h + p["bi"].to(dtype)
    if act == "silu":
        g = torch.matmul(x, p["wg"].to(dtype))
        h = F.silu(g) * h
    else:
        h = F.gelu(h, approximate="tanh")     # jax.nn.gelu's default
    out = torch.matmul(h, p["wo"].to(dtype))
    if "bo" in p:
        out = out + p["bo"].to(dtype)
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


def chunked_cross_entropy(h: torch.Tensor, w: torch.Tensor, labels: torch.Tensor,
                          softcap: float = 0.0, chunk: int = 512,
                          transpose_w: bool = False) -> torch.Tensor:
    """Mean next-token CE without materializing full (B, S, V) logits.

    h: (B, S, D); w: (D, V) (or (V, D) with transpose_w); labels: (B, S),
    -1 = masked.  Walks sequence chunks; under autograd each chunk's logits
    are recomputed in the backward pass (``torch.utils.checkpoint``),
    bounding live logit memory to (B, chunk, V).
    """
    B, S, D = h.shape
    c = min(chunk, S)
    while S % c:
        c -= 1
    tot = torch.zeros((), dtype=_F32, device=h.device)
    cnt = torch.zeros((), dtype=_F32, device=h.device)
    for i in range(S // c):
        hb, lb = h[:, i * c:(i + 1) * c], labels[:, i * c:(i + 1) * c]
        if torch.is_grad_enabled():
            part, n = checkpoint(_ce_chunk, hb, lb, w, softcap, transpose_w,
                                 use_reentrant=False)
        else:
            part, n = _ce_chunk(hb, lb, w, softcap, transpose_w)
        tot, cnt = tot + part, cnt + n
    return tot / torch.clamp_min(cnt, 1.0)


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


def scan_or_unroll(body: Callable, carry, xs, *, remat: str = "none"):
    """Run ``body(carry, xs_slice)`` over the leading axis of the tree
    ``xs`` (the stacked layers), the reference's ``lax.scan``/unroll as a
    loop.  Under autograd ``remat`` picks what a layer keeps for the
    backward pass: ``"none"`` everything, ``"full"`` only its input (the
    layer recomputed, ``torch.utils.checkpoint``), ``"dots"`` its
    matmul outputs (a selective checkpoint).  Returns ``(carry, ys)``,
    ``ys`` the list of the bodies' second outputs, or None."""
    if remat not in ("none", "full", "dots"):
        raise ValueError(f"remat must be 'none', 'full' or 'dots', got {remat!r}")
    step = body
    if remat != "none" and torch.is_grad_enabled():
        kw = {"use_reentrant": False}
        if remat == "dots":
            kw["context_fn"] = functools.partial(create_selective_checkpoint_contexts,
                                                 _keep_matmuls)
        step = functools.partial(checkpoint, body, **kw)
    n = pytree.leaves(xs)[0].shape[0]
    ys: List[Any] = []
    for i in range(n):
        carry, y = step(carry, pytree.tree_map(lambda x: x[i], xs))
        ys.append(y)
    return carry, (ys if ys and ys[0] is not None else None)
