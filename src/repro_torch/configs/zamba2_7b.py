"""zamba2-7b [hybrid] — Mamba2 backbone + shared attention block every 6 layers.
[arXiv:2411.15242; unverified]

ssm_state=64 per assignment. Runs long_500k (state-based backbone; the shared
attention applications keep KV caches but decode is O(L) per step).
"""
from repro_torch.config import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-7b",
    family="hybrid",
    num_layers=81,
    d_model=3584,
    num_heads=32,
    num_kv_heads=32,
    head_dim=112,
    d_ff=14336,             # shared-block MLP
    vocab_size=32000,
    ssm_state_dim=64,
    ssm_head_dim=64,
    ssm_expand=2,
    ssm_conv_width=4,
    attn_every=6,
    rope_theta=10000.0,
    mlp_activation="swiglu",
    max_seq_len=1048576,
)

SMOKE_CONFIG = CONFIG.replace(
    name="zamba2-smoke",
    num_layers=5,
    d_model=64,
    num_heads=4,
    num_kv_heads=4,
    head_dim=16,
    d_ff=128,
    vocab_size=512,
    ssm_state_dim=16,
    ssm_head_dim=16,
    attn_every=2,
    max_seq_len=256,
)
