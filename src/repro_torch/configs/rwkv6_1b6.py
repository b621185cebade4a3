"""rwkv6-1.6b [ssm] — Finch, attention-free, data-dependent decay.
[arXiv:2404.05892; unverified]

Runs long_500k: constant-size recurrent state per layer.
"""
from repro_torch.config import ModelConfig

CONFIG = ModelConfig(
    name="rwkv6-1.6b",
    family="ssm",
    num_layers=24,
    d_model=2048,
    num_heads=32,            # d_model / rwkv_head_size
    num_kv_heads=32,
    head_dim=64,
    d_ff=7168,
    vocab_size=65536,
    rwkv_head_size=64,
    mlp_activation="relu_sq",  # rwkv channel-mix uses squared relu
    max_seq_len=1048576,
)

SMOKE_CONFIG = CONFIG.replace(
    name="rwkv6-smoke",
    num_layers=2,
    d_model=64,
    num_heads=4,
    num_kv_heads=4,
    head_dim=16,
    rwkv_head_size=16,
    d_ff=128,
    vocab_size=512,
    max_seq_len=256,
)
