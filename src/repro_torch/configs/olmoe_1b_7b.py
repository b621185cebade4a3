"""olmoe-1b-7b [moe] — 64 experts top-8, GQA kv=16. [arXiv:2409.02060; hf]"""
from repro_torch.config import ModelConfig

CONFIG = ModelConfig(
    name="olmoe-1b-7b",
    family="moe",
    num_layers=16,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    head_dim=128,
    d_ff=1024,              # per-expert intermediate
    vocab_size=50304,
    num_experts=64,
    experts_per_token=8,
    rope_theta=10000.0,
    mlp_activation="swiglu",
)

SMOKE_CONFIG = CONFIG.replace(
    name="olmoe-smoke",
    num_layers=2,
    d_model=64,
    num_heads=4,
    num_kv_heads=4,
    head_dim=16,
    d_ff=96,
    vocab_size=512,
    num_experts=8,
    experts_per_token=2,
    max_seq_len=128,
)
