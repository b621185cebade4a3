"""phi3-mini-3.8b [dense] — RoPE SwiGLU GQA. [arXiv:2404.14219; unverified]"""
from repro_torch.config import ModelConfig

CONFIG = ModelConfig(
    name="phi3-mini-3.8b",
    family="dense",
    num_layers=32,
    d_model=3072,
    num_heads=32,
    num_kv_heads=32,
    head_dim=96,
    d_ff=8192,
    vocab_size=32064,
    rope_theta=10000.0,
    mlp_activation="swiglu",
)

SMOKE_CONFIG = CONFIG.replace(
    name="phi3-mini-smoke",
    num_layers=2,
    d_model=64,
    num_heads=4,
    num_kv_heads=4,
    head_dim=16,
    d_ff=128,
    vocab_size=512,
    max_seq_len=128,
)
