"""Model configurations the port runs: the dense family, zamba2 and rwkv6 of
the JAX package's ``repro.configs``, copied as data.

Each module exports ``CONFIG`` (published width and depth) and
``SMOKE_CONFIG`` (a few layers at narrow widths, for the CPU tests).
"""
from __future__ import annotations

import importlib
from typing import List

from repro_torch.config import ModelConfig

ARCHS: List[str] = [
    "llama3_8b",
    "granite_3_8b",
    "phi3_mini",
    "starcoder2_7b",
    "zamba2_7b",
    "rwkv6_1b6",
]

# hyphen/dot aliases accepted from command lines
_ALIASES = {
    "llama3-8b": "llama3_8b",
    "granite-3-8b": "granite_3_8b",
    "phi3-mini-3.8b": "phi3_mini",
    "starcoder2-7b": "starcoder2_7b",
    "zamba2-7b": "zamba2_7b",
    "rwkv6-1.6b": "rwkv6_1b6",
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
