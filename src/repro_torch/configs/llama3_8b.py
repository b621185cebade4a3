"""llama3-8b [dense] — GQA, 128k vocab. [arXiv:2407.21783; unverified]"""
from repro_torch.config import ModelConfig

CONFIG = ModelConfig(
    name="llama3-8b",
    family="dense",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=128256,
    rope_theta=500000.0,
    mlp_activation="swiglu",
)

SMOKE_CONFIG = CONFIG.replace(
    name="llama3-8b-smoke",
    num_layers=2,
    d_model=64,
    num_heads=4,
    num_kv_heads=2,
    head_dim=16,
    d_ff=128,
    vocab_size=512,
    max_seq_len=128,
)
