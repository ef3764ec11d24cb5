"""Serving driver: batched prefill + greedy autoregressive decode.

Port of the JAX package's ``launch/serve.py`` on one device.  ``python -m
repro_torch.launch.serve --arch qwen2-7b --prompt-len 64 --gen 32
[--device cpu]`` serves a reduced model on the card unless asked for the
CPU.  The caches come out of the prefill in the compute dtype (bfloat16
by default), are padded once to the serving window and then written in
place, a token a step.  The reference's ``serve.*`` telemetry is emitted
through ``runtime/telemetry.py``.
"""
from __future__ import annotations

import argparse
import time
from typing import Any, Dict

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch import configs
from repro_torch.configs.base import ModelConfig, RunConfig
from repro_torch.core.ctsf import resolve_device
from repro_torch.models.registry import get_model
from repro_torch.models.transformer import Transformer
from repro_torch.runtime import telemetry
from .train import reduce_config

__all__ = ["Server", "main"]


def _pad_caches(caches: Dict[str, torch.Tensor], target_len: int) -> Dict[str, torch.Tensor]:
    """Grow attention caches ``(L, B, S, KV, hd)`` from the prefill length
    to the serving window."""
    out = {}
    for name, x in caches.items():
        if name in ("k", "v") and x.ndim == 5 and x.shape[2] < target_len:
            x = F.pad(x, (0, 0, 0, 0, 0, target_len - x.shape[2]))
        out[name] = x
    return out


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Server:
    """Minimal batched-request server: prefill once, decode greedily."""

    def __init__(self, cfg: ModelConfig, run: RunConfig, max_len: int = 512,
                 seed: int = 0, device=None):
        self.cfg, self.run, self.max_len = cfg, run, max_len
        self.device = resolve_device(device)
        params = get_model(cfg).init(torch.Generator(device=self.device).manual_seed(seed),
                                     cfg, max_len)
        self.model = Transformer(cfg, run, params)

    @torch.no_grad()
    def generate(self, batch: Dict[str, Any], gen_len: int) -> Dict[str, Any]:
        """``batch``: ``tokens`` (B, S) (numpy or tensor) and, for the vlm
        stub, ``image_embeds``.  Returns the greedy tokens (numpy, (B,
        gen_len)), the prefill and decode seconds (host clock around work
        that ends in a synchronize) and decode tokens a second."""
        tokens = torch.as_tensor(batch["tokens"]).to(self.device)
        image = batch.get("image_embeds")
        image = None if image is None else torch.as_tensor(image).to(self.device)
        with telemetry.span("serve.request", b=tokens.shape[0], gen_len=gen_len):
            t0 = time.perf_counter()
            logits, caches = self.model.prefill(tokens, image)
            caches = _pad_caches(caches, self.max_len)
            tok = torch.argmax(logits, -1)[:, None]
            _sync(self.device)
            prefill_t = time.perf_counter() - t0
            out = [tok]
            pos = tokens.shape[1]
            t0 = time.perf_counter()
            for i in range(gen_len - 1):
                logits, caches = self.model.decode_step(caches, tok, pos + i)
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
    out = server.generate(batch, args.gen)
    print(f"prefill {out['prefill_s']*1e3:.1f} ms; "
          f"decode {out['decode_tok_per_s']:.1f} tok/s; "
          f"sample: {out['tokens'][0][:16].tolist()}")
    return out


if __name__ == "__main__":
    main()
