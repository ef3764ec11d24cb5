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

``loss``, ``prefill`` and ``decode_step`` take ``constrain=``, a split
context (``sharding/split.py``), as the reference's do.  With
``run.ssm_head_shard`` (the rules lay ``ssm_x`` out by heads) a training or
prefill layer runs this rank's heads on the whole sequence (the stream
entered): ``w_in`` is gathered over ``model`` one layer at a time and its
z, x and dt columns narrowed to the rank's heads, B and C kept whole (cut
by groups where ``model`` divides ``ssm_groups``), the conv channels,
``a_log``, ``d_skip``, ``dt_bias`` and ``gate_norm`` narrowed alike, the
gated RMSNorm's mean square over ``d_inner`` summed over ``model``, and
``w_out``'s row block's partial output left.  With the flag off (the
rules' default ``ssm_x`` layout, by sequence) and the stream cut over
``model`` a layer runs every head on this rank's sequence block only:
``w_in``, ``conv`` and ``w_out`` gathered whole a layer at a time and the
replicated leaves taken as they are, each gradient a part summed over
``model``; the norm, the projections and the gated norm within each
position; the causal conv on the block behind a halo of the
``ssm_conv - 1`` raw positions before it (``Split.halo``: from the rank
before, zeros on rank 0); the SSD chunked over the block from a zero
state, then every rank's end state and total log decay stacked over
``model`` (``Split.stacked``) and folded in rank order into the state
entering the block (``_SeqCarry``), from which the chunk loop runs as the
reference's scan reaches the block.  Where the stream is whole on every
rank (``activation_sharding="replicated"``, or a sequence ``model`` does
not divide) every rank runs the whole layer, as the reference does.  A
prefill's final state (the fold over every block, on every rank) and
conv tail (the last rank's, all-gathered) come back as this rank's
blocks of the rules' cache layout (the state by heads, the conv buffer by
a contiguous block of its packed channels).  A decode step under a split
is head-parallel whatever the flag, as the cache's layout is: the token's
projection from ``w_in``'s column block, all-gathered; the conv on the
rank's block of the buffer, its activations all-gathered; the SSD update,
the gated norm and ``w_out``'s rows on the state's heads, left.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F

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

def ssd_chunked(x, dt, a_log, bmat, cmat, d_skip, chunk: int = 64, carry=None):
    """SSD forward.

    x: (B, S, H, P); dt: (B, S, H) (post-softplus); a_log: (H,);
    bmat/cmat: (B, S, G, N); d_skip: (H,).  Returns (y, final_state) with
    y in x's dtype and final_state (B, G, HG, P, N) float32.

    ``carry`` (None: a zero state before the first position) is a function
    ``carry(s, a)`` of the state these positions end in from a zero start
    ``s`` (B, G, HG, P, N) and their total log decay ``a = Σ dt·A``
    (B, G, HG), returning the state before the first position: a block of
    a sequence split, whose carry folds the blocks before it
    (:class:`_SeqCarry`).  The chunk loop then starts from it, as the
    reference's scan reaches the block.
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
    if carry is not None:
        s = h
        for c in range(nc):
            s = s * chunk_decay[:, c, ..., None, None] + state_c[:, c]
        h = carry(s, last[:, :, 0].sum(dim=1))
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


# ---------------------------------------------------------------------------
# the split over ``model`` (sharding/split.py)
# ---------------------------------------------------------------------------

def _local(cfg: ModelConfig, c, mode: Optional[str], device) -> Dict[str, Any]:
    """The SSD heads this ``model`` rank runs and the packed indices that
    select them: ``mode`` ``"heads"`` takes, in every group, this rank's
    block of the group's heads (B and C whole; the decode state's layout,
    ``Rules.cache_pspec``), ``"groups"`` this rank's block of groups (B
    and C cut with them), None every head.  ``heads``/``groups`` are the
    global indices in ``(group, head)`` order; ``chan`` the heads'
    channels of ``x``, ``z`` and ``gate_norm``; ``xbc`` the conv channels
    (``x``, then B, then C); ``cols`` the ``w_in`` columns (``z``, ``xbc``,
    ``dt``); ``contiguous`` whether ``chan`` is this rank's contiguous
    block of ``d_inner`` (the rules' row block of ``w_out``)."""
    di, g, n, hg, pd = (cfg.d_inner, cfg.ssm_groups, cfg.ssm_state,
                        cfg.ssm_heads // cfg.ssm_groups, cfg.ssm_head_dim)
    ar = lambda a, b: torch.arange(a, b, device=device)
    if mode == "heads":
        hb = hg // c.tp
        heads = (ar(0, g)[:, None] * hg + ar(c.rank * hb, (c.rank + 1) * hb)).reshape(-1)
        groups = ar(0, g)
    elif mode == "groups":
        gb = g // c.tp
        groups = ar(c.rank * gb, (c.rank + 1) * gb)
        heads = (groups[:, None] * hg + ar(0, hg)).reshape(-1)
    else:
        heads, groups = ar(0, g * hg), ar(0, g)
    chan = (heads[:, None] * pd + ar(0, pd)).reshape(-1)
    gn = (groups[:, None] * n + ar(0, n)).reshape(-1)
    xbc = torch.cat([chan, di + gn, di + g * n + gn])
    cols = torch.cat([chan, di + xbc, 2 * di + 2 * g * n + heads])
    return {"heads": heads, "groups": groups, "chan": chan, "xbc": xbc, "cols": cols,
            "contiguous": mode == "groups" or (mode == "heads" and g == 1)}


def _ssd_mode(cfg: ModelConfig, c) -> Optional[str]:
    """How ``run.ssm_head_shard`` splits the SSD mixer over ``model`` (see
    :func:`_local`): by groups where ``model`` divides them, else by heads
    within each group where it divides a group's heads; None (the flag off,
    or neither dividing): every head, on this rank's sequence block where
    the stream is cut, else on the whole stream."""
    g, hg = cfg.ssm_groups, cfg.ssm_heads // cfg.ssm_groups
    if c.tp == 1 or not c.rules.run.ssm_head_shard:
        return None
    if g % c.tp == 0:
        return "groups"
    return "heads" if hg % c.tp == 0 else None


def _gate_norm_split(c, y, z, scale, di: int, dtype, cut: bool) -> torch.Tensor:
    """The gated RMSNorm over ``d_inner`` of this rank's channels ``y``
    (``z`` and ``scale`` cut alike): the mean square's sum over ``model``
    in rank order where the channels are cut."""
    x = (y * F.silu(z.to(_F32)).to(dtype)).to(_F32)
    ss = (x * x).sum(dim=-1, keepdim=True)
    ms = (c.model_sum(ss) if cut else ss) / di
    return (x * torch.rsqrt(ms + 1e-6) * scale).to(dtype)


def _out_rows(c, w_out, sel, di: int):
    """``w_out``'s rows of this rank's channels: the rules' row block
    where it is that block, else the rows taken from the whole leaf."""
    if sel["contiguous"]:
        return c.block(w_out, 0, di)
    return c.whole(w_out, 0, di).index_select(0, sel["chan"])


def _cache_block(c, x: torch.Tensor, dim: int) -> torch.Tensor:
    """A cache computed whole over ``model`` cut to this rank's block along
    ``dim`` where ``model`` divides it (``Rules.cache_pspec``)."""
    if c.tp == 1 or x.shape[dim] % c.tp:
        return x
    b = x.shape[dim] // c.tp
    return x.narrow(dim, c.rank * b, b).contiguous()


class _SeqCarry:
    """:func:`ssd_chunked`'s ``carry`` on rank r's block of a sequence split
    over ``model``: every rank's zero-start end state ``s_j`` and total log
    decay ``a_j`` stacked over ``model`` (:meth:`Split.stacked`, the
    gradient summed back to rank j), and the state entering block r, the
    reference's scan over the blocks before it written as a sum,
    ``h_r = Σ_{j<r} exp(Σ_{j<k<r} a_k) s_j`` (the exponent's masked
    entries ``-inf`` before the ``exp``, so every rank's whole stack, rank
    0's too, takes part in the gradient's collective).  With ``final`` it
    also keeps the sequence's end state, the same sum over every block (a
    prefill's cache), in ``self.final``."""

    def __init__(self, c, final: bool):
        self.c, self.want_final, self.final = c, final, None

    def _entering(self, s, cum, r: int) -> torch.Tensor:
        j = torch.arange(self.c.tp, device=s.device).reshape(-1, 1, 1, 1)
        expo = torch.where(j < r, cum[r - 1] - cum, torch.full((), -torch.inf, device=s.device))
        return torch.einsum("jbgh,jbghpn->bghpn", torch.exp(expo), s)

    def __call__(self, s, a):
        s, cum = self.c.stacked(s), torch.cumsum(self.c.stacked(a), dim=0)
        if self.want_final:
            self.final = self._entering(s, cum, self.c.tp)
        return self._entering(s, cum, self.c.rank)


def _mamba_seq(p, h, cfg: ModelConfig, chunk: int, return_state: bool, c):
    """:func:`mamba_apply` on this rank's block of a sequence split over
    ``model`` (see the module docstring)."""
    dtype = h.dtype
    di, g, n, nh, w = cfg.d_inner, cfg.ssm_groups, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_conv
    K, conv_ch = 2 * di + 2 * g * n + nh, di + 2 * g * n
    B, S, _ = h.shape
    hn = L.rms_norm(h, c.rep(p["ln"]["scale"]))
    proj = torch.matmul(hn, c.whole(p["w_in"], 1, K).to(dtype))
    z, xbc, dt = _split_proj(proj, cfg)
    raw = torch.cat([c.halo(xbc, w - 1), xbc], dim=1)       # the conv's inputs
    conv = _causal_conv(raw, c.whole(p["conv"], 1, conv_ch).to(dtype),
                        c.rep(p["conv_b"]).to(dtype))
    xbc = F.silu(conv[:, w - 1:])
    x = xbc[..., :di].reshape(B, S, nh, cfg.ssm_head_dim)
    bmat = xbc[..., di: di + g * n].reshape(B, S, g, n)
    cmat = xbc[..., di + g * n:].reshape(B, S, g, n)
    dt = F.softplus(dt.to(_F32) + c.rep(p["dt_bias"]))
    carry = _SeqCarry(c, return_state)
    y, _ = ssd_chunked(x, dt, c.rep(p["a_log"]), bmat, cmat, c.rep(p["d_skip"]), chunk=chunk,
                       carry=carry)
    out = _gate_out(dict(gate_norm=c.rep(p["gate_norm"]), w_out=c.whole(p["w_out"], 0, di)),
                    y.reshape(B, S, di), z, dtype)
    if not return_state:
        return h + out, None
    # the conv tail: the sequence's last raw inputs, the last rank's
    tail = c.stacked(raw[:, -min(w, c.seq):])[-1]
    return h + out, (_cache_block(c, carry.final, 2), _cache_block(c, tail, 2))


def _mamba_split(p, h, cfg: ModelConfig, chunk: int, return_state: bool, c):
    """:func:`mamba_apply` under a split (see the module docstring)."""
    di, g, n, nh = cfg.d_inner, cfg.ssm_groups, cfg.ssm_state, cfg.ssm_heads
    K, conv_ch = 2 * di + 2 * g * n + nh, di + 2 * g * n
    mode = _ssd_mode(cfg, c)
    if mode is None and c.sp:
        return _mamba_seq(p, h, cfg, chunk, return_state, c)
    if mode is None:
        # the stream whole on every rank: the layer whole on every rank
        pw = dict(p, w_in=c.whole_redundant(p["w_in"], 1, K),
                  conv=c.whole_redundant(p["conv"], 1, conv_ch),
                  w_out=c.whole_redundant(p["w_out"], 0, di))
        out, state = mamba_apply(pw, h, cfg, chunk, return_state)
        if state is not None:
            state = (_cache_block(c, state[0], 2), _cache_block(c, state[1], 2))
        return out, state
    dtype = h.dtype
    sel = _local(cfg, c, mode, h.device)
    hl, gl, dl = len(sel["heads"]), len(sel["groups"]), len(sel["chan"])
    xin = c.enter(L.rms_norm(h, c.rep(p["ln"]["scale"])))       # the whole sequence
    B, S, _ = xin.shape
    w_in = c.whole(p["w_in"], 1, K)
    proj = torch.matmul(xin, w_in.index_select(1, sel["cols"]).to(dtype))
    z, xbc, dt = proj[..., :dl], proj[..., dl:dl + len(sel["xbc"])], proj[..., -hl:]
    rep = lambda t: c.tp_rep(t).index_select(0, sel["heads"])
    conv = c.whole(p["conv"], 1, conv_ch).index_select(1, sel["xbc"])
    conv_b = c.tp_rep(p["conv_b"]).index_select(0, sel["xbc"])
    xbc = F.silu(_causal_conv(xbc, conv.to(dtype), conv_b.to(dtype)))
    x = xbc[..., :dl].reshape(B, S, hl, cfg.ssm_head_dim)
    bmat = xbc[..., dl:dl + gl * n].reshape(B, S, gl, n)
    cmat = xbc[..., dl + gl * n:].reshape(B, S, gl, n)
    dt = F.softplus(dt.to(_F32) + rep(p["dt_bias"]))
    y, final_state = ssd_chunked(x, dt, rep(p["a_log"]), bmat, cmat, rep(p["d_skip"]),
                                 chunk=chunk)
    gate = c.tp_rep(p["gate_norm"]).index_select(0, sel["chan"])
    yn = _gate_norm_split(c, y.reshape(B, S, dl), z, gate, di, dtype, True)
    out = c.leave(torch.matmul(yn, _out_rows(c, p["w_out"], sel, di).to(dtype)))
    if not return_state:
        return h + out, None
    if mode == "groups":        # the cache cuts the state by heads, if at all
        final_state = _cache_block(c, c.model_gather(final_state, 1), 2)
    # the conv tail in the cache's layout: the raw inputs of its channels
    ch = torch.arange(conv_ch, device=h.device)
    ch = _cache_block(c, ch, 0)
    tail = torch.matmul(xin[:, -cfg.ssm_conv:], w_in.index_select(1, di + ch).to(dtype))
    return h + out, (final_state, tail)


def mamba_apply(p, h, cfg: ModelConfig, chunk: int = 64, return_state: bool = False,
                constrain=None):
    """Full-sequence Mamba2 block (training / prefill).  Returns (h + out,
    None) or, with ``return_state``, (h + out, (final_state, conv_tail)),
    ``conv_tail`` the last ``ssm_conv`` raw (pre-conv) inputs for decode.
    With ``constrain`` (the stream's split context) ``h`` is the stream in
    its layout and so is ``h + out``, and the state and the conv tail are
    this rank's blocks in the rules' cache layout (see the module
    docstring)."""
    if constrain is not None:
        return _mamba_split(p, h, cfg, chunk, return_state, constrain)
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


def mamba_decode(p, h, cache, cfg: ModelConfig, constrain=None):
    """One-token Mamba2 step.  h: (B, 1, d); cache: dict(state (B, G, HG,
    P, N) float32, conv (B, w, conv_ch)), both updated in place.  Returns
    (h + out, cache).  With ``constrain`` (the one-token stream's split
    context) the caches are this rank's blocks in the rules' layout,
    registered with their specs, and the step is head-parallel where the
    state is cut by heads, whatever ``run.ssm_head_shard`` says (see the
    module docstring)."""
    if constrain is not None:
        return _mamba_decode_split(p, h, cache, cfg, constrain)
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


def _mamba_decode_split(p, h, cache, cfg: ModelConfig, c):
    """:func:`mamba_decode` under a split: the token's projection from this
    rank's column block of ``w_in``, all-gathered over ``model``; the conv
    on this rank's block of the conv buffer's channels (with its block of
    ``conv``), the activations all-gathered; the SSD update, the gated
    norm and ``w_out``'s rows on this rank's heads of the state, the
    output left."""
    dtype = h.dtype
    di, g, n, nh = cfg.d_inner, cfg.ssm_groups, cfg.ssm_state, cfg.ssm_heads
    K, conv_ch = 2 * di + 2 * g * n + nh, di + 2 * g * n
    B = h.shape[0]
    hn = L.rms_norm(h[:, 0], p["ln"]["scale"])
    proj = L.whole_columns(c, hn, p["w_in"], None, K)
    z, xbc, dt = _split_proj(proj, cfg)
    conv_c, state = cache["conv"], cache["state"]
    cut = c.on_model(conv_c, 2)
    if cut:
        cb = conv_c.shape[2]
        xbc = xbc[..., c.rank * cb:(c.rank + 1) * cb]
        kernel, bias = c.block(p["conv"], 1, conv_ch), c.block(p["conv_b"], 0, conv_ch)
    else:
        kernel, bias = c.whole(p["conv"], 1, conv_ch), p["conv_b"]
    conv_buf = torch.cat([conv_c[:, 1:].to(dtype), xbc[:, None]], dim=1)
    conv_c.copy_(conv_buf)
    act = F.silu((conv_buf * kernel.to(dtype)[None]).sum(dim=1) + bias.to(dtype))
    xbc = c.model_gather(act, -1) if cut else act
    heads_cut = c.cache_offset(state, 2) is not None
    sel = _local(cfg, c, "heads" if heads_cut else None, h.device)
    hl = len(sel["heads"])
    x = xbc.index_select(-1, sel["chan"]).reshape(B, hl, cfg.ssm_head_dim)
    bvec = xbc[..., di: di + g * n].reshape(B, g, n)
    cvec = xbc[..., di + g * n:].reshape(B, g, n)
    dt = F.softplus(dt.index_select(-1, sel["heads"]).to(_F32)
                    + p["dt_bias"].index_select(0, sel["heads"]))
    y, new_state = ssd_decode(state, x, dt, p["a_log"].index_select(0, sel["heads"]), bvec, cvec,
                              p["d_skip"].index_select(0, sel["heads"]))
    state.copy_(new_state)
    yn = _gate_norm_split(c, y.reshape(B, -1), z.index_select(-1, sel["chan"]),
                          p["gate_norm"].index_select(0, sel["chan"]), di, dtype, heads_cut)
    if heads_cut:
        out = c.leave(torch.matmul(yn, _out_rows(c, p["w_out"], sel, di).to(dtype)))
    else:
        out = torch.matmul(yn, c.whole(p["w_out"], 0, di).to(dtype))
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
    h, _ = L.scan_or_unroll(
        lambda h, lp: mamba_apply(lp, h, cfg, chunk=run.ssd_chunk, constrain=c),
        h, params["layers"], remat=run.remat, constrain=c)
    h = L.norm_apply(params["final_norm"], h, "rms", c)
    return L.chunked_cross_entropy(h, params["unembed"], batch["labels"],
                                   chunk=run.loss_chunk, constrain=c)


def prefill(params, tokens, cfg: ModelConfig, run: RunConfig, constrain=None):
    """Full forward collecting each layer's final SSM state and conv tail.
    Returns (last-position logits, caches).  With ``constrain`` (a split
    context) the logits come back whole over ``model`` and the caches as
    this rank's blocks in the rules' cache layout."""
    dtype = L._dtype(run.compute_dtype)
    c = constrain.at(tokens.shape[1]) if constrain is not None else None
    h = L.embed_lookup(params["embed"], tokens, dtype, c)
    if c is not None:
        h = c(h, "act")
    h, ys = L.scan_or_unroll(
        lambda h, lp: mamba_apply(lp, h, cfg, chunk=run.ssd_chunk, return_state=True,
                                  constrain=c),
        h, params["layers"], remat=run.remat, constrain=c)
    logits = _lm_head(params, c.last(h) if c is not None else h[:, -1:], c)
    cache = {"state": torch.stack([y[0] for y in ys]),
             "conv": torch.stack([y[1] for y in ys]).to(dtype)}
    return logits[:, 0].to(_F32), cache


def decode_step(params, caches, token, pos, cfg: ModelConfig, run: RunConfig, constrain=None):
    """One step; writes each layer's state and conv buffer into ``caches``
    in place and returns (logits, caches).  With ``constrain`` (a split
    context) ``caches`` are this rank's blocks, bound with their specs
    (``Split.bind``)."""
    dtype = L._dtype(run.compute_dtype)
    c = constrain.at(1) if constrain is not None else None
    h = L.embed_lookup(params["embed"], token, dtype, c)
    layers = (c.slices(caches) if c is not None
              else [{"state": s, "conv": v} for s, v in zip(caches["state"], caches["conv"])])
    it = iter(layers)
    h, _ = L.scan_or_unroll(lambda h, lp: mamba_decode(lp, h, next(it), cfg, constrain=c),
                            h, params["layers"], constrain=c)
    logits = _lm_head(params, h, c)
    return logits[:, 0].to(_F32), caches


class Mamba2(LMModule):
    """The attention-free Mamba2 LM as an ``nn.Module`` (:class:`~repro_torch.models.convert.LMModule`)."""
