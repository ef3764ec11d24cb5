"""qwen2-72b [dense]: GQA kv=8, QKV bias. [arXiv:2407.10671; hf]"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-72b", family="dense",
    n_layers=80, d_model=8192, n_heads=64, n_kv_heads=8, d_ff=29568,
    vocab=152064, head_dim=128, qkv_bias=True, rope_theta=1_000_000.0,
)
