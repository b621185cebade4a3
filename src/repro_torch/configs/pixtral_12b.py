"""pixtral-12b [vlm] — pixtral-ViT frontend STUB + mistral-nemo backbone.
[hf:mistralai/Pixtral-12B-2409; unverified]

Batches carry precomputed patch embeddings (batch, num_patches, d_model)
under ``patch_embeds`` (``models.factory.make_batch``), prepended to the
token sequence.
"""
from repro_torch.config import ModelConfig

CONFIG = ModelConfig(
    name="pixtral-12b",
    family="vlm",
    num_layers=40,
    d_model=5120,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=131072,
    num_patches=64,
    rope_theta=1000000000.0,
    mlp_activation="swiglu",
)

SMOKE_CONFIG = CONFIG.replace(
    name="pixtral-smoke",
    num_layers=2,
    d_model=64,
    num_heads=4,
    num_kv_heads=2,
    head_dim=16,
    d_ff=128,
    vocab_size=512,
    num_patches=4,
    max_seq_len=128,
)
