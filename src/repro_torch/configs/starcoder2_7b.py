"""starcoder2-7b [dense] — GQA, RoPE. [arXiv:2402.19173; hf]"""
from repro_torch.config import ModelConfig

CONFIG = ModelConfig(
    name="starcoder2-7b",
    family="dense",
    num_layers=32,
    d_model=4608,
    num_heads=36,
    num_kv_heads=4,
    head_dim=128,
    d_ff=18432,
    vocab_size=49152,
    rope_theta=1000000.0,
    mlp_activation="gelu",
)

SMOKE_CONFIG = CONFIG.replace(
    name="starcoder2-smoke",
    num_layers=2,
    d_model=72,
    num_heads=6,
    num_kv_heads=2,
    head_dim=12,
    d_ff=144,
    vocab_size=512,
    max_seq_len=128,
)
