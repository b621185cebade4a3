"""Input-shape sets of the LM families (seq_len x global_batch).

Counterpart of the JAX package's ``configs/shapes.py``, copied as data.
``decode_*`` / ``long_*`` are serve steps (one new token against a KV cache
or recurrent state of seq_len), not train steps. ``long_500k`` runs only for
sub-quadratic archs (ssm/hybrid).
"""
from __future__ import annotations

from typing import List, Tuple

from repro_torch.config import ModelConfig, ShapeConfig

SHAPES = {
    "train_4k": ShapeConfig("train_4k", seq_len=4096, global_batch=256, kind="train"),
    "prefill_32k": ShapeConfig("prefill_32k", seq_len=32768, global_batch=32, kind="prefill"),
    "decode_32k": ShapeConfig("decode_32k", seq_len=32768, global_batch=128, kind="decode"),
    "long_500k": ShapeConfig("long_500k", seq_len=524288, global_batch=1, kind="decode"),
}

SHAPE_ORDER = ["train_4k", "prefill_32k", "decode_32k", "long_500k"]


def get_shape(name: str) -> ShapeConfig:
    return SHAPES[name]


def shape_applicable(cfg: ModelConfig, shape: ShapeConfig) -> Tuple[bool, str]:
    """(runnable, reason-if-skipped). long_500k only for ssm/hybrid."""
    if shape.name == "long_500k" and not cfg.supports_long_context:
        return False, "full-attention arch: long_500k runs only for ssm/hybrid"
    return True, ""


def cells_for_arch(cfg: ModelConfig) -> List[ShapeConfig]:
    out = []
    for name in SHAPE_ORDER:
        ok, _ = shape_applicable(cfg, SHAPES[name])
        if ok:
            out.append(SHAPES[name])
    return out
