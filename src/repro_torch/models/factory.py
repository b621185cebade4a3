"""Model factory: one interface over the architectures the port runs.

    model = get_model(cfg)
    params = model.init(seed, device=...)
    model.loss(params, batch) -> (loss, metrics)
    model.prefill(params, batch, max_len) -> (logits, cache)
    model.decode(params, batch, cache) -> (logits, cache)
    model.init_cache(batch, max_len, device=...) -> empty cache

Counterpart of the JAX package's ``models/factory.py``: the dense, ``moe``
and ``vlm`` families run in ``transformer``, ``ssm`` in ``rwkv6``,
``hybrid`` in ``zamba2`` and ``encdec`` in ``whisper``. ``make_batch``
builds a seeded random batch of any family. ``loss`` trains every family;
on a card the scans of ``ssm`` and ``hybrid`` run their backward kernels.
Under an ambient model mesh (``launch.mesh.activate_mesh``) ``loss`` takes
parameters placed on it and runs ``transformer.sharded_loss_fn``; the
``ssm``, ``hybrid`` and ``encdec`` families do not run on a mesh yet.
The dry-run tooling (``cache_specs``, ``param_specs``, ``input_specs``) is
not ported (ROADMAP.md, queue 1).
"""
from __future__ import annotations

import functools
from typing import Any, Callable, Dict, NamedTuple

import torch

from repro_torch.config import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.launch.mesh import current_mesh
from repro_torch.models import rwkv6, transformer, whisper, zamba2
from repro_torch.models.layers import torch_dtype


class Model(NamedTuple):
    cfg: ModelConfig
    init: Callable[..., Any]
    loss: Callable[..., Any]
    prefill: Callable[..., Any]
    decode: Callable[..., Any]
    init_cache: Callable[..., Any]


_MODULES = {"dense": transformer, "moe": transformer, "vlm": transformer,
            "ssm": rwkv6, "hybrid": zamba2, "encdec": whisper}


def _loss(mod, cfg: ModelConfig, params, batch):
    mesh = current_mesh()
    if mesh is None:
        return mod.loss_fn(params, cfg, batch)
    if mod is not transformer:
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.family} family does not train on a model "
            "mesh in the port yet (ROADMAP.md, queue 1, item 5)")
    return transformer.sharded_loss_fn(params, cfg, batch, mesh)


def get_model(cfg: ModelConfig) -> Model:
    if cfg.family not in _MODULES:
        raise ValueError(cfg.family)
    mod = _MODULES[cfg.family]
    return Model(
        cfg=cfg,
        init=functools.partial(mod.init_params, cfg),
        loss=functools.partial(_loss, mod, cfg),
        prefill=lambda params, batch, max_len: mod.prefill(params, cfg, batch,
                                                           max_len),
        decode=lambda params, batch, cache: mod.decode_step(params, cfg, batch,
                                                            cache),
        init_cache=functools.partial(mod.init_cache, cfg),
    )


def make_batch(cfg: ModelConfig, shape_kind: str, batch: int, seq: int,
               seed: int = 0, *, device=None) -> Dict[str, torch.Tensor]:
    """A random batch from a seeded ``torch.Generator`` on ``device`` (None
    means the CUDA card): ``tokens`` (B, S), or (B,) for ``"decode"``,
    uniform in [0, vocab); ``labels`` (B, S) for ``"train"``; whisper's
    ``frames`` (B, encoder_seq_len, D) and the VLM's ``patch_embeds`` (B,
    num_patches, D), standard normal in ``cfg.dtype``."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    dtype = torch_dtype(cfg.dtype)
    out: Dict[str, torch.Tensor] = {}

    def normal(*shape):
        return torch.randn(shape, generator=gen, dtype=torch.float32,
                           device=dev).to(dtype)

    def ids(*shape):
        return torch.randint(0, cfg.vocab_size, shape, generator=gen,
                             device=dev)

    if cfg.family == "encdec":
        out["frames"] = normal(batch, cfg.encoder_seq_len, cfg.d_model)
    if cfg.family == "vlm":
        out["patch_embeds"] = normal(batch, cfg.num_patches, cfg.d_model)
    if shape_kind == "decode":
        out["tokens"] = ids(batch)
        return out
    out["tokens"] = ids(batch, seq)
    if shape_kind == "train":
        out["labels"] = ids(batch, seq)
    return out
