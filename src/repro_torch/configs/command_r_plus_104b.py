"""command-r-plus-104b [dense]: GQA kv=8, no bias, tied embeddings.
[hf:CohereForAI/c4ai-command-r-plus; unverified]"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="command-r-plus-104b", family="dense",
    n_layers=64, d_model=12288, n_heads=96, n_kv_heads=8, d_ff=33792,
    vocab=256000, head_dim=128, tie_embeddings=True, rope_theta=75_000.0,
)
