"""Mamba2 (SSD — state-space duality) blocks, chunked-scan formulation.

Port of the JAX package's ``models/mamba2.py`` (Dao & Gu,
arXiv:2405.21060): the sequence is split into chunks of Q tokens; within a
chunk the recurrence is a masked, decay-weighted quadratic contraction;
across chunks a small ``(G, HG, P, N)`` state is carried by a loop over the
chunks.  Decode keeps the recurrent form: an O(1) state update per token.
The SSD core computes in float32 whatever the compute dtype.

Block layout (mamba2-1.3b): in_proj -> [z | x | B | C | dt], short causal
depthwise conv on (x|B|C), SSD core, gated RMSNorm, out_proj.

One deliberate departure: the intra-chunk decay is ``exp(seg)`` with the
entries above the diagonal filled with ``-inf`` *before* the exponential.
The reference masks after it (``where(causal, exp(seg), 0)``); above the
diagonal ``seg`` is positive, so its ``exp`` can overflow and the gradient
becomes ``0·inf = NaN``.  The forward values are the same wherever the
reference's are finite.

``loss`` takes ``constrain=``, a sharded step's split context, as the
reference's does.  The SSD mixer is the split's one exception: it is not
split over ``model`` (the reference's packed ``w_in`` does not cut by
heads), so each layer is gathered whole over both axes and runs on the
whole sequence on every ``model`` rank, and ``constrain(h, "act")`` cuts
its output back to the stream's block.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F

from repro_torch import pytree
from repro_torch.configs.base import ModelConfig, RunConfig
from repro_torch.core.ctsf import resolve_device
from . import layers as L
from .convert import LMModule

__all__ = ["mamba_params", "mamba_apply", "mamba_decode", "init_mamba_cache",
           "ssd_chunked", "ssd_decode", "init", "loss", "prefill", "decode_step",
           "init_cache", "Mamba2"]

_F32 = torch.float32


# ---------------------------------------------------------------------------
# SSD core
# ---------------------------------------------------------------------------

def ssd_chunked(x, dt, a_log, bmat, cmat, d_skip, chunk: int = 64):
    """SSD forward.

    x: (B, S, H, P); dt: (B, S, H) (post-softplus); a_log: (H,);
    bmat/cmat: (B, S, G, N); d_skip: (H,).  Returns (y, final_state) with
    y in x's dtype and final_state (B, G, HG, P, N) float32.
    """
    B, S, H, P = x.shape
    G, N = bmat.shape[2], bmat.shape[3]
    HG = H // G
    Q = min(chunk, S)
    while S % Q:
        Q -= 1
    nc = S // Q

    A = -torch.exp(a_log.to(_F32))                       # (H,) negative
    a = dt.to(_F32) * A                                  # (B,S,H)
    cum = torch.cumsum(a.reshape(B, nc, Q, G, HG), dim=2)    # (B,nc,Q,G,HG)

    xg = x.reshape(B, nc, Q, G, HG, P).to(_F32)
    dtg = dt.reshape(B, nc, Q, G, HG).to(_F32)
    dtx = xg * dtg[..., None]
    bg = bmat.reshape(B, nc, Q, G, N).to(_F32)
    cg = cmat.reshape(B, nc, Q, G, N).to(_F32)

    # ---- intra-chunk (quadratic within Q) -------------------------------
    scores = torch.einsum("bcqgn,bckgn->bcqkg", cg, bg)
    seg = cum[:, :, :, None] - cum[:, :, None]           # (B,nc,Q,Q,G,HG)
    iq = torch.arange(Q, device=x.device)
    causal = (iq[:, None] >= iq[None, :])[None, None, :, :, None, None]
    decay = torch.exp(torch.where(causal, seg, torch.full((), -torch.inf, device=x.device)))
    att = scores[..., None] * decay                      # (B,nc,Q,Q,G,HG)
    y_intra = torch.einsum("bcqkgh,bckghp->bcqghp", att, dtx)

    # ---- chunk states ----------------------------------------------------
    last = cum[:, :, -1:]                                # (B,nc,1,G,HG)
    w = torch.exp(last - cum)                            # decay to chunk end
    state_c = torch.einsum("bckghp,bckgn->bcghpn", dtx * w[..., None], bg)

    # ---- inter-chunk recurrence: the state *before* each chunk ----------
    chunk_decay = torch.exp(last[:, :, 0])               # (B,nc,G,HG)
    h = torch.zeros((B, G, HG, P, N), dtype=_F32, device=x.device)
    h_prev = []
    for c in range(nc):
        h_prev.append(h)
        h = h * chunk_decay[:, c, ..., None, None] + state_c[:, c]
    h_prev = torch.stack(h_prev, dim=1)                  # (B,nc,G,HG,P,N)

    y_inter = torch.einsum("bcqgn,bcqgh,bcghpn->bcqghp", cg, torch.exp(cum), h_prev)

    y = (y_intra + y_inter).reshape(B, S, H, P)
    y = y + x.to(_F32) * d_skip.to(_F32)[None, None, :, None]
    return y.to(x.dtype), h


def ssd_decode(state, x, dt, a_log, bvec, cvec, d_skip):
    """One-token SSD update.  x: (B,H,P); dt: (B,H); b/c: (B,G,N);
    state: (B,G,HG,P,N).  Returns (y, new_state)."""
    B, H, P = x.shape
    G, N = bvec.shape[1], bvec.shape[2]
    HG = H // G
    A = -torch.exp(a_log.to(_F32))
    ag = (dt.to(_F32) * A).reshape(B, G, HG)
    xg = x.reshape(B, G, HG, P).to(_F32)
    dtx = xg * dt.reshape(B, G, HG)[..., None]
    new_state = (state * torch.exp(ag)[..., None, None]
                 + torch.einsum("bghp,bgn->bghpn", dtx, bvec.to(_F32)))
    y = torch.einsum("bgn,bghpn->bghp", cvec.to(_F32), new_state)
    y = y.reshape(B, H, P) + x.to(_F32) * d_skip.to(_F32)[None, :, None]
    return y.to(x.dtype), new_state


# ---------------------------------------------------------------------------
# Mamba2 block
# ---------------------------------------------------------------------------

def mamba_params(gen: torch.Generator, cfg: ModelConfig) -> Dict[str, Any]:
    d, di = cfg.d_model, cfg.d_inner
    g, n, h = cfg.ssm_groups, cfg.ssm_state, cfg.ssm_heads
    conv_ch = di + 2 * g * n
    dev = gen.device
    full = lambda shape, v: torch.full(shape, v, dtype=_F32, device=dev)
    return {
        "ln": L.norm_params(d, "rms", dev),
        "w_in": L.dense_init(gen, d, 2 * di + 2 * g * n + h),
        "conv": torch.randn((cfg.ssm_conv, conv_ch), generator=gen, device=dev,
                            dtype=_F32) * 0.2,
        "conv_b": full((conv_ch,), 0.0),
        "a_log": full((h,), 0.0),
        "d_skip": full((h,), 1.0),
        "dt_bias": full((h,), -2.0),
        "gate_norm": full((di,), 1.0),
        "w_out": L.dense_init(gen, di, d),
    }


def _split_proj(proj, cfg: ModelConfig):
    di, g, n, h = cfg.d_inner, cfg.ssm_groups, cfg.ssm_state, cfg.ssm_heads
    z = proj[..., :di]
    xbc = proj[..., di: di + di + 2 * g * n]
    dt = proj[..., -h:]
    return z, xbc, dt


def _causal_conv(xbc, kernel, bias):
    """Depthwise causal conv, width w: sum of shifted copies (w is 4)."""
    w = kernel.shape[0]
    out = xbc * kernel[-1]
    for i in range(1, w):
        shifted = F.pad(xbc, (0, 0, i, 0))[:, :-i]
        out = out + shifted * kernel[-1 - i]
    return out + bias


def _gate_out(p, y, z, dtype):
    y = L.rms_norm(y * F.silu(z.to(_F32)).to(dtype), p["gate_norm"])
    return torch.matmul(y, p["w_out"].to(dtype))


def mamba_apply(p, h, cfg: ModelConfig, chunk: int = 64, return_state: bool = False,
                constrain=None):
    """Full-sequence Mamba2 block (training / prefill).  Returns (h + out,
    None) or, with ``return_state``, (h + out, (final_state, conv_tail)),
    ``conv_tail`` the last ``ssm_conv`` raw (pre-conv) inputs for decode.
    With ``constrain`` (the stream's split context) ``h`` is the stream in
    its layout and so is ``h + out``: the layer runs whole on every rank,
    its ``model`` blocks and the sequence all-gathered (their gradients cut
    back to the blocks)."""
    if constrain is not None:
        c = constrain
        g, n = cfg.ssm_groups, cfg.ssm_state
        p = dict(p, w_in=c.whole_redundant(p["w_in"], 1, 2 * cfg.d_inner + 2 * g * n
                                           + cfg.ssm_heads),
                 conv=c.whole_redundant(p["conv"], 1, cfg.d_inner + 2 * g * n),
                 w_out=c.whole_redundant(p["w_out"], 0, cfg.d_inner))
        out, state = mamba_apply(p, c.redundant(h), cfg, chunk, return_state)
        return c(out, "act"), state
    dtype = h.dtype
    di, g, n, nh = cfg.d_inner, cfg.ssm_groups, cfg.ssm_state, cfg.ssm_heads
    B, S, _ = h.shape
    hn = L.rms_norm(h, p["ln"]["scale"])
    proj = torch.matmul(hn, p["w_in"].to(dtype))
    z, xbc, dt = _split_proj(proj, cfg)
    conv_tail = xbc[:, -cfg.ssm_conv:]
    xbc = F.silu(_causal_conv(xbc, p["conv"].to(dtype), p["conv_b"].to(dtype)))
    x = xbc[..., :di].reshape(B, S, nh, cfg.ssm_head_dim)
    bmat = xbc[..., di: di + g * n].reshape(B, S, g, n)
    cmat = xbc[..., di + g * n:].reshape(B, S, g, n)
    dt = F.softplus(dt.to(_F32) + p["dt_bias"])
    y, final_state = ssd_chunked(x, dt, p["a_log"], bmat, cmat, p["d_skip"], chunk=chunk)
    out = _gate_out(p, y.reshape(B, S, di), z, dtype)
    if return_state:
        return h + out, (final_state, conv_tail)
    return h + out, None


def mamba_decode(p, h, cache, cfg: ModelConfig):
    """One-token Mamba2 step.  h: (B, 1, d); cache: dict(state (B, G, HG,
    P, N) float32, conv (B, w, conv_ch)), both updated in place.  Returns
    (h + out, cache)."""
    dtype = h.dtype
    di, g, n, nh = cfg.d_inner, cfg.ssm_groups, cfg.ssm_state, cfg.ssm_heads
    B = h.shape[0]
    hn = L.rms_norm(h[:, 0], p["ln"]["scale"])
    proj = torch.matmul(hn, p["w_in"].to(dtype))
    z, xbc, dt = _split_proj(proj, cfg)
    # conv over the rolling buffer of raw inputs
    conv_buf = torch.cat([cache["conv"][:, 1:].to(dtype), xbc[:, None]], dim=1)
    cache["conv"].copy_(conv_buf)
    kernel = p["conv"].to(dtype)
    xbc = F.silu((conv_buf * kernel[None]).sum(dim=1) + p["conv_b"].to(dtype))
    x = xbc[..., :di].reshape(B, nh, cfg.ssm_head_dim)
    bvec = xbc[..., di: di + g * n].reshape(B, g, n)
    cvec = xbc[..., di + g * n:].reshape(B, g, n)
    dt = F.softplus(dt.to(_F32) + p["dt_bias"])
    y, new_state = ssd_decode(cache["state"], x, dt, p["a_log"], bvec, cvec, p["d_skip"])
    cache["state"].copy_(new_state)
    out = _gate_out(p, y.reshape(B, di), z, dtype)
    return h + out[:, None], cache


def init_mamba_cache(cfg: ModelConfig, batch: int, n_layers: Optional[int] = None,
                     dtype=torch.bfloat16, device=None) -> Dict[str, Any]:
    """Empty SSM caches on ``device`` (None: the card)."""
    dev = resolve_device(device)
    nl = n_layers if n_layers is not None else cfg.n_layers
    g, n = cfg.ssm_groups, cfg.ssm_state
    hg = cfg.ssm_heads // g
    conv_ch = cfg.d_inner + 2 * g * n
    return {
        "state": torch.zeros((nl, batch, g, hg, cfg.ssm_head_dim, n), dtype=_F32, device=dev),
        "conv": torch.zeros((nl, batch, cfg.ssm_conv, conv_ch), dtype=dtype, device=dev),
    }


# ---------------------------------------------------------------------------
# full mamba2 LM (attention-free)
# ---------------------------------------------------------------------------

def init(gen: torch.Generator, cfg: ModelConfig, max_seq: int = 0) -> Dict[str, Any]:
    """Random parameters drawn from ``gen``, on its device (float32)."""
    return {
        "embed": L.embed_init(gen, cfg.vocab_padded, cfg.d_model),
        "final_norm": L.norm_params(cfg.d_model, "rms", gen.device),
        "layers": L.stack_layers(gen, cfg, mamba_params, cfg.n_layers),
        "unembed": L.dense_init(gen, cfg.d_model, cfg.vocab_padded),
    }


def init_cache(cfg: ModelConfig, batch: int, max_len: int, dtype=torch.bfloat16,
               device=None):
    return init_mamba_cache(cfg, batch, dtype=dtype, device=device)


def _embed(params, tokens, dtype):
    return L.embed_lookup(params["embed"], tokens, dtype)


def _lm_head(params, h):
    h = L.rms_norm(h, params["final_norm"]["scale"])
    return torch.matmul(h, params["unembed"].to(h.dtype))


def loss(params, batch, cfg: ModelConfig, run: RunConfig, constrain=None):
    """Mean next-token cross-entropy; ``constrain``: a sharded step's split
    context (``params`` then this rank's blocks)."""
    dtype = L._dtype(run.compute_dtype)
    c = constrain.at(batch["tokens"].shape[1]) if constrain is not None else None
    h = L.embed_lookup(params["embed"], batch["tokens"], dtype, c)
    if c is not None:
        h = c(h, "act")
    h, _ = L.scan_or_unroll(
        lambda h, lp: mamba_apply(lp, h, cfg, chunk=run.ssd_chunk, constrain=c),
        h, params["layers"], remat=run.remat, constrain=c)
    h = L.norm_apply(params["final_norm"], h, "rms", c)
    return L.chunked_cross_entropy(h, params["unembed"], batch["labels"],
                                   chunk=run.loss_chunk, constrain=c)


def prefill(params, tokens, cfg: ModelConfig, run: RunConfig):
    """Full forward collecting each layer's final SSM state and conv tail.
    Returns (last-position logits, caches)."""
    dtype = L._dtype(run.compute_dtype)
    h = _embed(params, tokens, dtype)
    h, ys = L.scan_or_unroll(
        lambda h, lp: mamba_apply(lp, h, cfg, chunk=run.ssd_chunk, return_state=True),
        h, params["layers"], remat=run.remat)
    logits = _lm_head(params, h[:, -1:])
    cache = {"state": torch.stack([y[0] for y in ys]),
             "conv": torch.stack([y[1] for y in ys]).to(dtype)}
    return logits[:, 0].to(_F32), cache


def decode_step(params, caches, token, pos, cfg: ModelConfig, run: RunConfig):
    """One step; writes each layer's state and conv buffer into ``caches``
    in place and returns (logits, caches)."""
    dtype = L._dtype(run.compute_dtype)
    h = _embed(params, token, dtype)
    for i in range(cfg.n_layers):
        lp = pytree.tree_map(lambda x: x[i], params["layers"])
        h, _ = mamba_decode(lp, h, {"state": caches["state"][i], "conv": caches["conv"][i]},
                            cfg)
    logits = _lm_head(params, h)
    return logits[:, 0].to(_F32), caches


class Mamba2(LMModule):
    """The attention-free Mamba2 LM as an ``nn.Module`` (:class:`~repro_torch.models.convert.LMModule`)."""
