"""mamba2-1.3b [ssm]: SSD (state-space duality), attention-free.
[arXiv:2405.21060; unverified]"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-1.3b", family="ssm",
    n_layers=48, d_model=2048, n_heads=0, n_kv_heads=0, d_ff=0,
    vocab=50280, head_dim=64, attn_kind="none",
    ssm_state=128, ssm_expand=2, ssm_head_dim=64, ssm_groups=1, ssm_conv=4,
)
