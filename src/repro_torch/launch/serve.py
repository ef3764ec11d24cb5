"""Serving driver: batched prefill + greedy autoregressive decode.

Port of the JAX package's ``launch/serve.py`` on one device.  ``python -m
repro_torch.launch.serve --arch qwen2-7b --prompt-len 64 --gen 32
[--device cpu]`` serves a reduced model of any family on the card unless
asked for the CPU, through the registry's ``prefill`` and ``decode_step``.
The caches come out of the prefill in the compute dtype (bfloat16 by
default; the SSM states in float32), their attention ``k``/``v`` padded
once to the serving window, and are then written in place, a token a
step.  The reference's ``serve.*`` telemetry is emitted through
``runtime/telemetry.py``.
"""
from __future__ import annotations

import argparse
import time
from typing import Any, Dict

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from repro_torch import configs
from repro_torch.configs.base import ModelConfig, RunConfig
from repro_torch.core.ctsf import resolve_device
from repro_torch.models.registry import get_model
from repro_torch.runtime import telemetry
from repro_torch.sharding.collectives import all_gather, all_to_all
from repro_torch.sharding.partition import MeshAxes, P, spec_axes
from .train import reduce_config

__all__ = ["Server", "grow_caches", "main"]


def grow_caches(caches: Dict[str, Any], target_len: int, src=None, dst=None) -> Dict[str, Any]:
    """The attention caches ``k``/``v`` ``(L, B, S, KV, hd)`` grown from the
    prefill length S to the serving window ``target_len`` (zeros after S);
    every other cache (whisper's cross ``xk``/``xv``, the SSM states) as it
    is.

    With ``src`` and ``dst``, the rules' cache shardings of the prefill's
    caches and of the grown ones (``Rules.cache_shardings`` of
    ``init_cache`` at the two lengths), ``caches`` are this rank's blocks
    and so is the result: a sequence cut over ``model`` at both lengths
    moves by one uneven all-to-all over ``model``, each position to the
    rank whose block of the window holds it, so no rank holds more than
    its blocks; one whole at both is padded, one cut only in the window
    narrowed to this rank's block."""
    out = {}
    for name, x in caches.items():
        if name in ("k", "v") and x.ndim == 5:
            if src is not None:
                x = _grow_block(x, target_len, src[name], dst[name])
            elif x.shape[2] < target_len:
                x = F.pad(x, (0, 0, 0, 0, 0, target_len - x.shape[2]))
        out[name] = x
    return out


def _grow_block(x: torch.Tensor, target_len: int, src, dst) -> torch.Tensor:
    """:func:`grow_caches` of one cache block ``x`` laid out by ``src``
    into the window's block laid out by ``dst`` (the sequence on axis 2)."""
    tp = MeshAxes.from_mesh(src.mesh).tp
    group = src.mesh.get_group(tp)
    n, r = dist.get_world_size(group), dist.get_rank(group)
    src_cut, dst_cut = (tp in spec_axes(P(s.spec[2])) for s in (src, dst))
    if src_cut and not dst_cut:
        x, src_cut = all_gather(x, group, dim=2), False
    tb = target_len // n if dst_cut else target_len
    lo = r * tb if dst_cut else 0
    if not src_cut:
        part = x[:, :, lo:lo + tb]
    else:
        sb = x.shape[2]
        if sb * n > target_len:
            raise ValueError(f"a prompt of {sb * n} positions does not fit a window of "
                             f"{target_len}")
        span = lambda s, d: max(0, min((s + 1) * sb, (d + 1) * tb) - max(s * sb, d * tb))
        part = all_to_all(x.movedim(2, 0).contiguous(), group,
                          send=[span(r, d) for d in range(n)],
                          recv=[span(s, r) for s in range(n)]).movedim(0, 2)
    return F.pad(part, (0, 0, 0, 0, 0, tb - part.shape[2])).contiguous()


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Server:
    """Minimal batched-request server: prefill once, decode greedily, through
    the registry's entry points on the dict of parameters ``params``."""

    def __init__(self, cfg: ModelConfig, run: RunConfig, max_len: int = 512,
                 seed: int = 0, device=None):
        self.cfg, self.run, self.max_len = cfg, run, max_len
        self.device = resolve_device(device)
        self.api = get_model(cfg)
        self.params = self.api.init(torch.Generator(device=self.device).manual_seed(seed),
                                    cfg, max_len)

    @torch.no_grad()
    def generate(self, batch: Dict[str, Any], gen_len: int) -> Dict[str, Any]:
        """``batch``: ``tokens`` (B, S) (numpy or tensor) and, for the vlm
        stub, ``image_embeds``, for whisper ``frame_embeds``.  Returns the
        greedy tokens (numpy, (B, gen_len)), the prefill and decode seconds
        (host clock around work that ends in a synchronize) and decode
        tokens a second."""
        batch = {k: torch.as_tensor(v).to(self.device) for k, v in batch.items()}
        tokens = batch["tokens"]
        params, cfg, run = self.params, self.cfg, self.run
        with telemetry.span("serve.request", b=tokens.shape[0], gen_len=gen_len):
            t0 = time.perf_counter()
            logits, caches = self.api.prefill(params, batch, cfg, run)
            caches = grow_caches(caches, self.max_len)
            tok = torch.argmax(logits, -1)[:, None]
            _sync(self.device)
            prefill_t = time.perf_counter() - t0
            out = [tok]
            pos = tokens.shape[1]
            t0 = time.perf_counter()
            for i in range(gen_len - 1):
                logits, caches = self.api.decode_step(params, caches, tok, pos + i, cfg, run)
                tok = torch.argmax(logits, -1)[:, None]
                out.append(tok)
            gen = torch.cat(out, dim=1)
            _sync(self.device)
            decode_t = time.perf_counter() - t0
            b = gen.shape[0]
            if telemetry.enabled():
                telemetry.inc("serve.requests")
                telemetry.inc("serve.tokens_generated", b * gen_len)
                telemetry.observe("serve.prefill_seconds", prefill_t)
                telemetry.observe("serve.decode_seconds", decode_t)
                telemetry.observe("serve.request_seconds", prefill_t + decode_t)
            return {"tokens": gen.cpu().numpy(),
                    "prefill_s": prefill_t, "decode_s": decode_t,
                    "decode_tok_per_s": b * (gen_len - 1) / max(decode_t, 1e-9)}


def main(argv=None):
    p = argparse.ArgumentParser(description="Serve a reduced model of the repo's configs: "
                                            "prefill, then greedy decode.")
    p.add_argument("--arch", default="qwen2-7b", choices=configs.ARCH_IDS)
    p.add_argument("--batch", type=int, default=4)
    p.add_argument("--prompt-len", type=int, default=64)
    p.add_argument("--gen", type=int, default=32)
    p.add_argument("--device", default=None, help="torch device (default: cuda:0)")
    args = p.parse_args(argv)
    cfg = reduce_config(configs.get(args.arch))
    run = RunConfig(remat="none", loss_chunk=128)
    server = Server(cfg, run, max_len=args.prompt_len + args.gen, device=args.device)
    rng = np.random.default_rng(0)
    batch = {"tokens": rng.integers(0, cfg.vocab,
                                    (args.batch, args.prompt_len)).astype(np.int32)}
    if cfg.family == "vlm":
        batch["image_embeds"] = np.zeros(
            (args.batch, cfg.n_image_tokens, cfg.d_model), np.float32)
    if cfg.family == "encdec":
        batch["frame_embeds"] = rng.standard_normal(
            (args.batch, cfg.encoder_seq, cfg.d_model)).astype(np.float32)
    out = server.generate(batch, args.gen)
    print(f"prefill {out['prefill_s']*1e3:.1f} ms; "
          f"decode {out['decode_tok_per_s']:.1f} tok/s; "
          f"sample: {out['tokens'][0][:16].tolist()}")
    return out


if __name__ == "__main__":
    main()
