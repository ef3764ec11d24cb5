"""phi-3-vision-4.2b [vlm]: phi3-mini backbone + CLIP frontend (stub).
[hf:microsoft/Phi-3-vision-128k-instruct; hf]"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="phi-3-vision-4.2b", family="vlm",
    n_layers=32, d_model=3072, n_heads=32, n_kv_heads=32, d_ff=8192,
    vocab=32064, head_dim=96, act="silu", norm="rms",
    rope_theta=10_000.0, n_image_tokens=256,
)
