"""granite-moe-3b-a800m [moe]: 40 experts top-8, per-expert d_ff=512.
[hf:ibm-granite/granite-3.0-3b-a800m-base; hf]"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="granite-moe-3b-a800m", family="moe",
    n_layers=32, d_model=1536, n_heads=24, n_kv_heads=8, d_ff=512,
    vocab=49155, head_dim=64, n_experts=40, top_k=8,
    expert_pad_to=48,   # EP-friendly: 48 %% 16 == 0 (8 dead experts)
)
