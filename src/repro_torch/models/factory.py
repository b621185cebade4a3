"""Model factory: one interface over the architectures the port runs.

    model = get_model(cfg)
    params = model.init(seed, device=...)
    model.loss(params, batch) -> (loss, metrics)
    model.prefill(params, batch, max_len) -> (logits, cache)
    model.decode(params, batch, cache) -> (logits, cache)
    model.init_cache(batch, max_len, device=...) -> empty cache
    model.cache_specs(batch, max_len) -> the cache's tree on ``meta``

Counterpart of the JAX package's ``models/factory.py``: the dense, ``moe``
and ``vlm`` families run in ``transformer``, ``ssm`` in ``rwkv6``,
``hybrid`` in ``zamba2`` and ``encdec`` in ``whisper``. ``make_batch``
builds a seeded random batch of any family. ``loss`` trains every family;
on a card the scans of ``ssm`` and ``hybrid`` run their backward kernels.
Under an ambient model mesh (``launch.mesh.activate_mesh``) ``loss``,
``prefill`` and ``decode`` take parameters placed on it and run the
family's sharded forms (``sharded_loss_fn``, ``sharded_prefill``,
``sharded_decode_step`` of every family's module; the cache placed by
``launch.sharding.cache_shardings``). The dry-run's stand-ins, as the
reference's ``jax.eval_shape`` gives them: ``cache_specs``,
``param_specs(cfg)`` and ``input_specs(cfg, shape)``, empty tensors on the
``meta`` device; ``launch/dryrun.py`` pairs them with the shardings.
"""
from __future__ import annotations

import functools
from typing import Any, Callable, Dict, NamedTuple

import torch

from repro_torch.config import ModelConfig, ShapeConfig
from repro_torch.device import resolve_device
from repro_torch.launch.mesh import current_mesh
from repro_torch.models import rwkv6, transformer, whisper, zamba2
from repro_torch.models.layers import meta_specs, torch_dtype


class Model(NamedTuple):
    cfg: ModelConfig
    init: Callable[..., Any]
    loss: Callable[..., Any]
    prefill: Callable[..., Any]
    decode: Callable[..., Any]
    init_cache: Callable[..., Any]
    cache_specs: Callable[..., Any]


_MODULES = {"dense": transformer, "moe": transformer, "vlm": transformer,
            "ssm": rwkv6, "hybrid": zamba2, "encdec": whisper}


def _loss(mod, cfg: ModelConfig, params, batch):
    mesh = current_mesh()
    if mesh is None:
        return mod.loss_fn(params, cfg, batch)
    return mod.sharded_loss_fn(params, cfg, batch, mesh)


def _prefill(mod, cfg: ModelConfig, params, batch, max_len: int):
    mesh = current_mesh()
    if mesh is None:
        return mod.prefill(params, cfg, batch, max_len)
    return mod.sharded_prefill(params, cfg, batch, max_len, mesh)


def _decode(mod, cfg: ModelConfig, params, batch, cache):
    mesh = current_mesh()
    if mesh is None:
        return mod.decode_step(params, cfg, batch, cache)
    return mod.sharded_decode_step(params, cfg, batch, cache, mesh)


def get_model(cfg: ModelConfig) -> Model:
    if cfg.family not in _MODULES:
        raise ValueError(cfg.family)
    mod = _MODULES[cfg.family]
    return Model(
        cfg=cfg,
        init=functools.partial(mod.init_params, cfg),
        loss=functools.partial(_loss, mod, cfg),
        prefill=functools.partial(_prefill, mod, cfg),
        decode=functools.partial(_decode, mod, cfg),
        init_cache=functools.partial(mod.init_cache, cfg),
        cache_specs=lambda batch, max_len: meta_specs(
            lambda: mod.init_cache(cfg, batch, max_len, device="cpu")),
    )


def param_specs(cfg: ModelConfig) -> Any:
    """The parameter tree, each leaf an empty ``meta`` tensor of its shape
    and type: no allocation (the reference's ``jax.eval_shape`` of
    ``init``)."""
    model = get_model(cfg)
    return meta_specs(lambda: model.init(0, device="cpu"))


def input_specs(cfg: ModelConfig, shape: ShapeConfig) -> Dict[str, Any]:
    """The batch of one benchmark cell as empty ``meta`` tensors, the
    reference's cases: a decode step's ``tokens`` (B,); whisper's
    ``frames`` (B, encoder_seq_len, D) beside S tokens; the VLM's S - P
    tokens beside its P ``patch_embeds``; else (B, S) tokens. Token ids are
    int32, as the reference's; ``labels`` (like the tokens) for a train
    cell."""
    B, S = shape.global_batch, shape.seq_len
    dt = torch_dtype(cfg.dtype)

    def sds(*dims, dtype=torch.int32):
        return torch.empty(dims, dtype=dtype, device="meta")

    if shape.kind == "decode":
        return {"tokens": sds(B)}
    if cfg.family == "encdec":
        out = {"frames": sds(B, cfg.encoder_seq_len, cfg.d_model, dtype=dt),
               "tokens": sds(B, S)}
    elif cfg.family == "vlm":
        P = cfg.num_patches
        S = S - P
        out = {"tokens": sds(B, S),
               "patch_embeds": sds(B, P, cfg.d_model, dtype=dt)}
    else:
        out = {"tokens": sds(B, S)}
    if shape.is_train:
        out["labels"] = sds(B, S)
    return out


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
