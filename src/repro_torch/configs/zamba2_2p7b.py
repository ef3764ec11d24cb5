"""zamba2-2.7b [hybrid]: Mamba2 backbone + shared attention block every 6
layers (concat global-residual input, width 2d). [arXiv:2411.15242; hf]"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-2.7b", family="hybrid",
    n_layers=54, d_model=2560, n_heads=32, n_kv_heads=32, d_ff=10240,
    vocab=32000, head_dim=160,           # shared block runs on 2*d = 5120
    ssm_state=64, ssm_expand=2, ssm_head_dim=80, ssm_groups=1, ssm_conv=4,
    shared_attn_every=6,
)
