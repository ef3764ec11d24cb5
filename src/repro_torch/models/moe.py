"""Mixture-of-Experts MLP (granite-moe style): top-k routing with
capacity-bounded sort-based dispatch.

Port of the JAX package's ``models/moe.py``.  The (tokens × top_k)
assignments of a sequence are ordered token-major, sorted by expert with a
stable sort, truncated to a per-expert capacity ``C = ceil(S·k·cf / E)``
(rounded up to a multiple of 4), gathered into a ``(B, Ep, C, D)`` buffer,
run through batched expert products and combined back with the router's
gates.  ``E`` is the number of routable experts (``router.shape[1]``);
``Ep`` (``wi.shape[0]``) may be larger (``expert_pad_to``): the padded
experts are never routed and their buffer rows stay zero.

Both directions are gathers, so the forward pass adds in a fixed order on
the card: the buffer's slot ``(e, c)`` holds the sorted assignment
``start_e + c``; the combine inverts the sort and sums each token's
``top_k`` rows in slot order (the reference's ``.at[st].add`` adds the
same terms in sorted order, so float32 results agree to rounding).  The
backward pass does too: the dispatch's gradient gathers each token's kept
rows and sums them in slot order (:class:`_Dispatch`), where a gather's
own backward would add them by atomics, in bf16 an order-dependent ulp.

Split over ``model`` (``constrain=``, a sharded step's split context) the
sequence is entered whole (the routing needs every token: capacity is a
sequence's) and routed alike on every rank.  Where ``model`` divides the
padded expert count (``Rules.ep``) each rank dispatches, runs and combines
only its own experts' rows (EP); otherwise each rank runs every expert on
its block of d_ff.  Either way a rank's combine is a part of each token's
sum, which the stream's ``leave`` adds over ``model`` in rank order.
"""
from __future__ import annotations

import math
from typing import Any, Dict

import torch
import torch.nn.functional as F

from .layers import dense_init

__all__ = ["moe_params", "moe_apply", "moe_routing"]

_F32 = torch.float32


def moe_params(gen: torch.Generator, d_model: int, d_ff: int, n_experts: int,
               pad_to: int = 0) -> Dict[str, Any]:
    scale = 1.0 / math.sqrt(d_model)
    ep = pad_to or n_experts          # padded weight count (EP divisibility)
    rand = lambda *shape: torch.randn(shape, generator=gen, device=gen.device, dtype=_F32)
    return {
        "router": dense_init(gen, d_model, n_experts),
        "wi": rand(ep, d_model, d_ff) * scale,
        "wg": rand(ep, d_model, d_ff) * scale,
        "wo": rand(ep, d_ff, d_model) / math.sqrt(d_ff),
    }


def _capacity(S: int, top_k: int, capacity_factor: float, E: int) -> int:
    cap = max(1, int(math.ceil(S * top_k * capacity_factor / E)))
    return (cap + 3) // 4 * 4                            # lane-friendly


def moe_routing(p: Dict[str, Any], x: torch.Tensor, *, top_k: int,
                capacity_factor: float = 1.25, n_padded: int = 0
                ) -> Dict[str, torch.Tensor]:
    """The dispatch plan of ``x`` (B, S, D): each sequence's assignments in
    token-major order, ``(B, S·k)``: ``expert``, ``gate`` (renormalised
    softmax weights, float32, differentiable to the router), ``keep``
    (within capacity) and ``slot`` (the buffer row ``e·C + c`` a kept
    assignment fills); and ``src`` ``(B, Ep·C)``, the assignment each buffer
    row holds (``-1``: empty), with ``cap`` and ``ep``.  ``n_padded``: the
    padded expert count, where ``p["wi"]`` holds only a rank's experts."""
    B, S, _ = x.shape
    E = p["router"].shape[1]
    Ep = n_padded or p["wi"].shape[0]
    cap = _capacity(S, top_k, capacity_factor, E)
    logits = torch.matmul(x, p["router"].to(x.dtype)).to(_F32)
    gates, idx = torch.topk(torch.softmax(logits, dim=-1), top_k, dim=-1)
    gates = gates / torch.clamp_min(gates.sum(-1, keepdim=True), 1e-9)
    sk = S * top_k
    expert = idx.reshape(B, sk)
    # stable: equal experts keep token-major order, as jnp.argsort does
    order = torch.argsort(expert, dim=-1, stable=True)
    se = torch.gather(expert, 1, order)
    experts = torch.arange(Ep, device=x.device).expand(B, Ep).contiguous()
    start = torch.searchsorted(se, experts, right=False)          # (B, Ep)
    count = torch.searchsorted(se, experts, right=True) - start
    c = torch.arange(cap, device=x.device)
    filled = c[None, None, :] < count[..., None]                   # (B, Ep, C)
    pos = (start[..., None] + c).clamp_max(sk - 1)
    src = torch.where(filled, torch.gather(order, 1, pos.reshape(B, -1)).reshape(B, Ep, cap),
                      -1).reshape(B, Ep * cap)
    # each assignment's rank inside its expert, in sorted order, then back
    rank_sorted = torch.arange(sk, device=x.device) - torch.gather(start, 1, se)
    inv = torch.argsort(order, dim=-1)
    rank = torch.gather(rank_sorted, 1, inv)
    keep = rank < cap
    slot = torch.where(keep, expert * cap + rank, Ep * cap)
    return {"expert": expert, "gate": gates.reshape(B, sk), "keep": keep, "slot": slot,
            "src": src, "cap": cap, "ep": Ep}


class _Dispatch(torch.autograd.Function):
    """``buf[b, i] = x[b, tok[b, i]]`` where ``filled[b, i]``, else zero.
    Backward: token ``s``'s gradient is the sum of its kept assignments'
    rows ``slot[b, s·k + j]``, j in order, gathered; no two threads add
    into one element, so the gradient's bits do not depend on the card's
    scheduling."""

    @staticmethod
    def forward(ctx, x, tok, filled, slot, keep, top_k):
        D = x.shape[-1]
        buf = torch.gather(x, 1, tok[..., None].expand(-1, -1, D))
        ctx.save_for_backward(slot, keep)
        ctx.top_k = top_k
        return torch.where(filled[..., None], buf, torch.zeros((), dtype=x.dtype,
                                                                device=x.device))

    @staticmethod
    def backward(ctx, gbuf):
        slot, keep = ctx.saved_tensors
        B, n, D = gbuf.shape
        rows = torch.gather(gbuf, 1, slot.clamp_max(n - 1)[..., None].expand(-1, -1, D))
        rows = torch.where(keep[..., None], rows, torch.zeros((), dtype=gbuf.dtype,
                                                              device=gbuf.device))
        k = ctx.top_k
        return rows.reshape(B, slot.shape[1] // k, k, D).sum(dim=2), None, None, None, None, None


def moe_apply(p: Dict[str, Any], x: torch.Tensor, *, top_k: int,
              capacity_factor: float = 1.25, constrain=None) -> torch.Tensor:
    """The MoE MLP of ``x`` (B, S, D); with ``constrain`` (the stream's
    split context) ``x`` is the stream in its layout and so is the result
    (see the module docstring)."""
    dtype = x.dtype
    c = constrain
    wi, wg, wo, router = p["wi"], p["wg"], p["wo"], p["router"]
    Ep = wi.shape[0]
    first, n = 0, Ep                   # the experts this rank runs
    if c is not None and c.tp > 1:
        x = c.enter(x)
        router = c.tp_rep(router)
        Ep = c.cfg.n_experts_padded
        if c.is_cut(wi, 0, Ep):        # EP: this rank's experts
            first, n = c.rank * wi.shape[0], wi.shape[0]
        else:                          # each expert's d_ff block
            f = c.cfg.d_ff
            wi, wg, wo = c.block(wi, 2, f), c.block(wg, 2, f), c.block(wo, 1, f)
    B, S, D = x.shape
    r = moe_routing({"router": router, "wi": wi}, x, top_k=top_k,
                    capacity_factor=capacity_factor, n_padded=Ep)
    cap = r["cap"]
    rows = slice(first * cap, (first + n) * cap)
    # this rank's buffer rows: each assignment's row among them, or none
    slot = r["slot"] - first * cap
    keep = r["keep"] & (slot >= 0) & (slot < n * cap)
    slot = slot.clamp(0, n * cap - 1)
    # dispatch: buffer row (e, c) gathers its assignment's token
    src = r["src"][:, rows]
    tok = torch.div(src.clamp_min(0), top_k, rounding_mode="floor")
    buf = _Dispatch.apply(x, tok, src >= 0, slot, keep, top_k).reshape(B, n, cap, D)

    h = torch.einsum("becd,edf->becf", buf, wi.to(dtype))
    g = torch.einsum("becd,edf->becf", buf, wg.to(dtype))
    h = F.silu(g) * h
    out = torch.einsum("becf,efd->becd", h, wo.to(dtype)).reshape(B, n * cap, D)

    # combine: each assignment gathers its row (dropped ones add zero), the
    # token's top_k rows summed in slot order
    y = torch.gather(out, 1, slot[..., None].expand(B, S * top_k, D))
    w = torch.where(keep, r["gate"], torch.zeros((), dtype=_F32, device=x.device))
    y = y * w.to(dtype)[..., None]
    y = y.reshape(B, S, top_k, D).sum(dim=2)
    return c.leave(y) if c is not None and c.tp > 1 else y
