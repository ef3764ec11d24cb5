"""whisper-medium [audio]: enc-dec backbone; conv frontend is a STUB
(input_specs provides precomputed frame embeddings). [arXiv:2212.04356;
unverified]"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-medium", family="encdec",
    n_layers=24, d_model=1024, n_heads=16, n_kv_heads=16, d_ff=4096,
    vocab=51865, head_dim=64, norm="layernorm", act="gelu",
    encoder_layers=24, encoder_seq=1500,
)
