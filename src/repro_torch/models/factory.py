"""Model factory: one interface over the architectures the port runs.

    model = get_model(cfg)
    params = model.init(seed, device=...)
    model.prefill(params, batch, max_len) -> (logits, cache)
    model.decode(params, batch, cache) -> (logits, cache)
    model.init_cache(batch, max_len, device=...) -> empty cache

Counterpart of the JAX package's ``models/factory.py``. The dense, ``ssm``
(rwkv6) and ``hybrid`` (zamba2) families run; training (``loss``) and the
shape-only ``cache_specs`` of the dry-run tooling are not ported yet
(ROADMAP.md, queue 1, item 7). Every other family raises
``NotImplementedError`` naming the ROADMAP item that ports it.
"""
from __future__ import annotations

import functools
from typing import Any, Callable, NamedTuple

from repro_torch.config import ModelConfig
from repro_torch.models import rwkv6, transformer, zamba2

# family -> the ROADMAP.md queue-1 item that ports it
_NOT_PORTED = {
    "moe": "queue 1, item 6 (the MoE block of models/layers.py)",
    "vlm": "queue 1, item 6 (the VLM patch-embedding stub)",
    "encdec": "queue 1, item 6 (whisper and cross-attention)",
}


class Model(NamedTuple):
    cfg: ModelConfig
    init: Callable[..., Any]
    prefill: Callable[..., Any]
    decode: Callable[..., Any]
    init_cache: Callable[..., Any]


_MODULES = {"dense": transformer, "ssm": rwkv6, "hybrid": zamba2}


def get_model(cfg: ModelConfig) -> Model:
    if cfg.family in _NOT_PORTED:
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.family} family is not ported yet; "
            f"ROADMAP.md {_NOT_PORTED[cfg.family]}")
    if cfg.family not in _MODULES:
        raise ValueError(cfg.family)
    mod = _MODULES[cfg.family]
    return Model(
        cfg=cfg,
        init=functools.partial(mod.init_params, cfg),
        prefill=lambda params, batch, max_len: mod.prefill(params, cfg, batch,
                                                           max_len),
        decode=lambda params, batch, cache: mod.decode_step(params, cfg, batch,
                                                            cache),
        init_cache=functools.partial(mod.init_cache, cfg),
    )
