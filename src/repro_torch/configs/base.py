"""Config system: architecture + run configuration dataclasses (a copy of
the JAX package's ``configs/base.py``; no framework import).

Every assigned architecture gets one ``configs/<id>.py`` exporting
``CONFIG``; ``repro_torch.configs.get(name)`` resolves them.  Shapes (the assigned
seq_len × global_batch cells) live here too.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

__all__ = ["ModelConfig", "ShapeConfig", "SHAPES", "RunConfig"]


def _ceil_to(x: int, m: int) -> int:
    return (x + m - 1) // m * m


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Architecture hyperparameters (exact values from the assignment)."""
    name: str
    family: str                      # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0                # 0 -> d_model // n_heads
    qk_norm: bool = False
    qkv_bias: bool = False
    tie_embeddings: bool = False
    norm: str = "rms"                # rms | layernorm
    act: str = "silu"                # silu (gated) | gelu (plain)
    rope_theta: float = 10_000.0
    logit_softcap: float = 0.0
    # --- MoE ---
    n_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    expert_pad_to: int = 0           # pad expert WEIGHTS to this count so EP
                                     # divides the model axis (dead experts
                                     # are never routed; +mem, zero flops)
    # --- SSM (Mamba2 / SSD) ---
    ssm_state: int = 0               # N
    ssm_expand: int = 2
    ssm_head_dim: int = 64           # P
    ssm_groups: int = 1              # G
    ssm_conv: int = 4
    # --- hybrid (zamba2-style shared attention block) ---
    shared_attn_every: int = 0       # apply shared block every k ssm layers
    # --- encoder-decoder (whisper-style) ---
    encoder_layers: int = 0
    encoder_seq: int = 0             # stub frame count (precomputed embeddings)
    # --- VLM (phi-3-vision-style) ---
    n_image_tokens: int = 0          # stub patch-embedding count
    # --- attention shape policy ---
    attn_kind: str = "full"          # full | none (ssm)

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def vocab_padded(self) -> int:
        """Vocab padded to 256 for clean TP sharding (MaxText-style)."""
        return _ceil_to(self.vocab, 256)

    @property
    def n_experts_padded(self) -> int:
        return self.expert_pad_to or self.n_experts

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    def param_count(self) -> int:
        """Approximate parameter count (for 6ND roofline MODEL_FLOPS)."""
        d, f, v = self.d_model, self.d_ff, self.vocab_padded
        hd, h, kv = self.hd, self.n_heads, self.n_kv_heads
        emb = v * d * (1 if self.tie_embeddings else 2)
        attn = d * h * hd + 2 * d * kv * hd + h * hd * d
        if self.act == "silu":
            mlp = 3 * d * f
        else:
            mlp = 2 * d * f
        if self.family == "moe":
            mlp *= self.n_experts
            mlp += d * self.n_experts  # router
        per_layer = attn + mlp + 2 * d
        if self.family in ("ssm", "hybrid"):
            di, g, n, hs = self.d_inner, self.ssm_groups, self.ssm_state, self.ssm_heads
            ssm = (d * 2 * di              # xz
                   + d * 2 * g * n         # B, C
                   + d * hs                # dt
                   + self.ssm_conv * (di + 2 * g * n)
                   + di * d + 2 * hs + di)  # out, A/D, norm
            if self.family == "ssm":
                per_layer = ssm + 2 * d
            else:  # hybrid: ssm layers + one shared attention block on 2d
                d2 = 2 * d
                shared = (d2 * h * hd + 2 * d2 * kv * hd + h * hd * d
                          + 3 * d2 * f + 2 * d2)
                return emb + self.n_layers * (ssm + 2 * d) + shared
        total = emb + self.n_layers * per_layer
        if self.family == "encdec":
            # encoder layers + decoder cross-attention
            enc = self.encoder_layers * (attn + mlp + 2 * d)
            cross = self.n_layers * (attn)  # cross-attn per decoder layer
            total += enc + cross
        return total

    def active_param_count(self) -> int:
        """MoE: params touched per token (6·N_active·D convention)."""
        if self.family != "moe":
            return self.param_count()
        d, f, v = self.d_model, self.d_ff, self.vocab_padded
        hd, h, kv = self.hd, self.n_heads, self.n_kv_heads
        emb = v * d * (1 if self.tie_embeddings else 2)
        attn = d * h * hd + 2 * d * kv * hd + h * hd * d
        mlp = 3 * d * f * self.top_k + d * self.n_experts
        return emb + self.n_layers * (attn + mlp + 2 * d)


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                        # train | prefill | decode

    @property
    def is_decode(self) -> bool:
        return self.kind == "decode"


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}


@dataclasses.dataclass(frozen=True)
class RunConfig:
    """Training/serving run knobs (parallelism, numerics, fault tolerance)."""
    activation_sharding: str = "sequence"   # sequence | replicated
    remat: str = "full"                     # none | full | dots
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    optimizer: str = "adamw"                # adamw | arrowhead
    learning_rate: float = 3e-4
    weight_decay: float = 0.01
    grad_clip: float = 1.0
    # sTiles arrowhead preconditioner
    precond_proj_dim: int = 32
    precond_band: int = 2
    precond_every: int = 10
    # distributed-optimization tricks
    pod_grad_compression: bool = False      # int8 error-feedback on pod axis
    # fault tolerance
    checkpoint_every: int = 50
    keep_checkpoints: int = 3
    max_step_retries: int = 2
    # attention chunking
    q_chunk: int = 512
    kv_chunk: int = 1024
    # SSD (mamba2) chunk length: intra-chunk memory scales with B*S*chunk
    ssd_chunk: int = 64
    # shard SSD heads over the model axis (head-parallel scans/convs)
    ssm_head_shard: bool = False
    # loss chunking (bounds (B, chunk, V) logits temps)
    loss_chunk: int = 512
    # loop-free attention for the cost-analysis harness
    unroll_attn: bool = False
    # gradient accumulation: process the global batch in this many sequential
    # microbatches (activation peak scales ~1/grad_accum; grads accumulate f32)
    grad_accum: int = 1
    # scan vs unrolled layers: scan keeps HLO/compile small (production);
    # unrolled is used by the roofline harness (XLA cost analysis does not
    # multiply while-loop bodies by trip count)
    scan_layers: bool = True
