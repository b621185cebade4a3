"""qwen3-moe-235b-a22b [moe] — 128 experts top-8, GQA kv=4.
[hf:Qwen/Qwen3-30B-A3B; hf] (assigned 235B-A22B scale)

The paper's own memory-construction backbone is Qwen3-30B-A3B — this arch
family is the most representative of the paper's write-path workload
(chunk extraction prefill). At full width it is 470 GB in bf16: more than
one card holds.
"""
from repro_torch.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-moe-235b-a22b",
    family="moe",
    num_layers=94,
    d_model=4096,
    num_heads=64,
    num_kv_heads=4,
    head_dim=128,
    d_ff=1536,              # per-expert intermediate
    vocab_size=151936,
    num_experts=128,
    experts_per_token=8,
    rope_theta=1000000.0,
    mlp_activation="swiglu",
)

SMOKE_CONFIG = CONFIG.replace(
    name="qwen3-moe-smoke",
    num_layers=2,
    d_model=64,
    num_heads=4,
    num_kv_heads=2,
    head_dim=16,
    d_ff=96,
    vocab_size=512,
    num_experts=8,
    experts_per_token=2,
    max_seq_len=128,
)
