"""Model configurations the port runs: the ten of the JAX package's
``repro.configs``, copied as data, and the input shapes (``shapes``).

Each module exports ``CONFIG`` (published width and depth) and
``SMOKE_CONFIG`` (a few layers at narrow widths, for the CPU tests).
"""
from __future__ import annotations

import importlib
from typing import List

from repro_torch.config import ModelConfig
from repro_torch.configs.shapes import (SHAPES, cells_for_arch,  # noqa: F401
                                        get_shape, shape_applicable)

ARCHS: List[str] = [
    "whisper_base",
    "rwkv6_1b6",
    "zamba2_7b",
    "qwen3_moe_235b",
    "olmoe_1b_7b",
    "starcoder2_7b",
    "phi3_mini",
    "llama3_8b",
    "granite_3_8b",
    "pixtral_12b",
]

# hyphen/dot aliases accepted from command lines
_ALIASES = {
    "whisper-base": "whisper_base",
    "rwkv6-1.6b": "rwkv6_1b6",
    "zamba2-7b": "zamba2_7b",
    "qwen3-moe-235b-a22b": "qwen3_moe_235b",
    "olmoe-1b-7b": "olmoe_1b_7b",
    "starcoder2-7b": "starcoder2_7b",
    "phi3-mini-3.8b": "phi3_mini",
    "llama3-8b": "llama3_8b",
    "granite-3-8b": "granite_3_8b",
    "pixtral-12b": "pixtral_12b",
}


def _module(name: str):
    canon = _ALIASES.get(name, name).replace("-", "_").replace(".", "_")
    if canon not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; the port has {ARCHS}")
    return importlib.import_module(f"repro_torch.configs.{canon}")


def get_config(name: str) -> ModelConfig:
    return _module(name).CONFIG


def get_smoke_config(name: str) -> ModelConfig:
    return _module(name).SMOKE_CONFIG
