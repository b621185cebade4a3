"""whisper-base [audio] — enc-dec, conv frontend STUB (precomputed frame
embeddings under ``frames``, as ``models.factory.make_batch`` builds them).
[arXiv:2212.04356; unverified]
"""
from repro_torch.config import ModelConfig

CONFIG = ModelConfig(
    name="whisper-base",
    family="encdec",
    num_layers=6,            # decoder layers
    encoder_layers=6,
    encoder_seq_len=1500,    # frames after (stubbed) conv frontend
    d_model=512,
    num_heads=8,
    num_kv_heads=8,
    head_dim=64,
    d_ff=2048,
    vocab_size=51865,
    mlp_activation="gelu",
    rope_theta=0.0,          # whisper uses learned/sinusoidal positions
    max_seq_len=32768,
)

SMOKE_CONFIG = CONFIG.replace(
    name="whisper-smoke",
    num_layers=2,
    encoder_layers=2,
    encoder_seq_len=32,
    d_model=64,
    num_heads=4,
    num_kv_heads=4,
    head_dim=16,
    d_ff=128,
    vocab_size=512,
    max_seq_len=128,
)
