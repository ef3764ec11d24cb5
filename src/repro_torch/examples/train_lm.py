"""End-to-end training driver: a ~100M-parameter qwen2-style LM on synthetic
Markov data, with fault-tolerant checkpointing and a choice of AdamW or the
sTiles banded-arrowhead curvature preconditioner.

The twin of the JAX package's ``examples/train_lm.py``.  The default runs a
~10M reduced model for 200 steps; ``--full`` trains the ~100M config.  On
the card unless asked for the CPU:

    PYTHONPATH=src python -m repro_torch.examples.train_lm --steps 200 [--device cpu]
    PYTHONPATH=src python -m repro_torch.examples.train_lm --optimizer arrowhead
"""
from __future__ import annotations

import argparse

import numpy as np

from repro_torch.configs.base import ModelConfig
from repro_torch.launch import train as T


def model_100m() -> ModelConfig:
    return ModelConfig(name="lm-100m", family="dense", n_layers=12,
                       d_model=768, n_heads=12, n_kv_heads=4, d_ff=2048,
                       vocab=8192, head_dim=64, qk_norm=True)


def model_10m() -> ModelConfig:
    return ModelConfig(name="lm-10m", family="dense", n_layers=6,
                       d_model=320, n_heads=8, n_kv_heads=4, d_ff=896,
                       vocab=2048, head_dim=40, qk_norm=True)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--steps", type=int, default=200)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--seq", type=int, default=256)
    p.add_argument("--optimizer", default="adamw",
                   choices=["adamw", "arrowhead"])
    p.add_argument("--full", action="store_true", help="~100M params")
    p.add_argument("--device", default=None, help="torch device (default: cuda:0)")
    args = p.parse_args(argv)

    cfg = model_100m() if args.full else model_10m()
    n_params = cfg.param_count()
    print(f"model {cfg.name}: ~{n_params/1e6:.1f}M params, "
          f"optimizer={args.optimizer}")

    # the launch driver takes the explicit config as it is
    out = T.train(cfg, steps=args.steps, batch=args.batch, seq=args.seq,
                  optimizer=args.optimizer, reduced=False,
                  checkpoint_dir=T.default_checkpoint_dir(f"repro_torch_lm_{cfg.name}"),
                  log_every=20, device=args.device)
    losses = out["losses"]
    k = max(5, len(losses) // 20)
    print(f"\nloss: {np.mean(losses[:k]):.4f} -> {np.mean(losses[-k:]):.4f} "
          f"(markov entropy floor {out['entropy_floor']:.4f})")
    ck = len(out['loop'].straggler.times)
    print(f"steps timed: {ck}, median step {out['loop'].straggler.median*1e3:.0f} ms, "
          f"stragglers flagged: {len(out['loop'].straggler.flagged)}")
    return out


if __name__ == "__main__":
    main()
