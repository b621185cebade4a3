"""Zamba2 hybrid: a Mamba2 backbone and one SHARED attention + MLP block
applied after every ``attn_every`` Mamba2 layers.

Counterpart of the JAX package's ``models/zamba2.py``. For L layers and
period A: G = L // A groups of A Mamba2 layers, each group followed by one
application of the shared block (the same weights every time, a KV cache of
its own per application); the L - G*A remaining layers run last. The JAX
package scans grouped, stacked parameters; here Python loops walk the list.

Parameters: ``embed``, ``layers`` (one dict per layer: ``ln``, ``mamba``),
``shared_attn`` (``ln1``, ``ln2``, ``attn``, ``mlp``; one dict),
``final_norm``, ``unembed``.

``loss_fn`` trains it: on a card the Mamba2 layers' scans run the
``mamba2_ssd`` kernels forward and backward, the shared block's attention
the ``flash_attention`` kernels.

The cache keeps the reference's keys and shapes: ``ssd`` (L, B, H, P, N)
float32, ``conv`` (L, B, W-1, conv_dim), ``kv_k`` and ``kv_v`` (G, B, Smax,
Hkv, Dh) in cfg.dtype, ``lengths`` (B,) int32. ``decode_step`` updates
``ssd``, ``conv``, ``kv_k`` and ``kv_v`` IN PLACE and returns a dict with the
same tensors and new ``lengths``; a caller that keeps an older cache dict
must clone it.
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.config import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import layers as L
from repro_torch.models import mamba2 as M


def _group_counts(cfg: ModelConfig):
    A = cfg.attn_every
    G = cfg.num_layers // A
    return G, A, cfg.num_layers - G * A


def init_params(cfg: ModelConfig, seed: int = 0, *,
                device=None) -> Dict[str, Any]:
    """Random weights from a seeded ``torch.Generator`` on ``device`` (None
    means the CUDA card), with the reference's distributions."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    dtype = L.torch_dtype(cfg.param_dtype)
    D = cfg.d_model
    ones = lambda: torch.ones((D,), dtype=dtype, device=dev)  # noqa: E731
    return {
        "embed": L.embed_init(gen, cfg.vocab_size, D, dtype),
        "layers": [{"ln": ones(), "mamba": M.mamba2_init(gen, cfg, dtype)}
                   for _ in range(cfg.num_layers)],
        "shared_attn": {
            "ln1": ones(),
            "ln2": ones(),
            "attn": L.attn_init(gen, cfg, dtype),
            "mlp": L.mlp_init(gen, cfg, dtype),
        },
        "final_norm": ones(),
        "unembed": L.dense_init(gen, D, cfg.vocab_size, dtype),
    }


def _layer_order(cfg: ModelConfig):
    """(layer index or None, group index): the Mamba2 layers in order, a
    ``None`` where the shared block applies after group ``g``."""
    G, A, rem = _group_counts(cfg)
    for g in range(G):
        for a in range(A):
            yield g * A + a, g
        yield None, g
    for i in range(G * A, G * A + rem):
        yield i, None


def _shared_attn_seq(cfg, sp, x, positions, return_kv=True):
    h = L.rms_norm(x, sp["ln1"], cfg.norm_eps)
    att = L.attention_prefill(sp["attn"], h, cfg, positions,
                              return_kv=return_kv)
    if return_kv:
        att, kv = att
    x = x + att
    h = L.rms_norm(x, sp["ln2"], cfg.norm_eps)
    x = x + L.mlp_block(sp["mlp"], h, cfg)
    return (x, kv) if return_kv else x


def _run_seq(params, cfg: ModelConfig, x: torch.Tensor, states):
    """x: (B, T, D). ``states``: {"ssd", "conv"} stacked over layers,
    updated in place. Returns (x, [(k, v) per application of the shared
    block])."""
    T = x.shape[1]
    positions = torch.arange(T, device=x.device)[None, :]
    sp = params["shared_attn"]
    kvs = []
    for i, _g in _layer_order(cfg):
        if i is None:
            x, kv = _shared_attn_seq(cfg, sp, x, positions)
            kvs.append(kv)
            continue
        x, states["ssd"][i], states["conv"][i] = _mamba_layer(
            cfg, params["layers"][i], x, states["ssd"][i], states["conv"][i])
    return x, kvs


def _mamba_layer(cfg: ModelConfig, p, x, ssd_state, conv_state):
    """One Mamba2 layer: (x + mamba2(rms_norm(x)), new ssd state, new conv
    state)."""
    h = L.rms_norm(x, p["ln"], cfg.norm_eps)
    y, s_new, c_new = M.mamba2_seq(p["mamba"], h, cfg, ssd_state, conv_state)
    return x + y, s_new, c_new


def loss_fn(params, cfg: ModelConfig, batch: Dict[str, torch.Tensor]):
    """(loss, {"xent"}): the token cross-entropy over ``labels`` (B, T) (and
    ``loss_mask``), as the reference's ``loss_fn``. Every layer starts from
    zero states, which nothing writes (autograd keeps the tensors it saved
    intact) and which the loss drops. ``cfg.remat`` recomputes each Mamba2
    layer in the backward pass; the shared block is kept, as the reference
    checkpoints the Mamba2 layers only."""
    tokens = batch["tokens"]
    B, T = tokens.shape
    x = params["embed"][tokens]
    ssd_shape, conv_shape = M.state_shapes(cfg, B)
    ssd0 = torch.zeros(ssd_shape, dtype=torch.float32, device=x.device)
    conv0 = torch.zeros(conv_shape, dtype=L.torch_dtype(cfg.dtype),
                        device=x.device)
    positions = torch.arange(T, device=x.device)[None, :]
    for i, _g in _layer_order(cfg):
        if i is None:
            x = _shared_attn_seq(cfg, params["shared_attn"], x, positions,
                                 return_kv=False)
        else:
            x = L.remat(_mamba_layer, cfg.remat, cfg, params["layers"][i], x,
                        ssd0, conv0)[0]
    h = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    loss = L.softmax_xent(h @ params["unembed"], batch["labels"],
                          batch.get("loss_mask"))
    return loss, {"xent": loss}


def init_state(cfg: ModelConfig, batch: int, *,
               device=None) -> Dict[str, torch.Tensor]:
    dev = resolve_device(device)
    ssd_shape, conv_shape = M.state_shapes(cfg, batch)
    Lnum = cfg.num_layers
    return {
        "ssd": torch.zeros((Lnum,) + ssd_shape, dtype=torch.float32,
                           device=dev),
        "conv": torch.zeros((Lnum,) + conv_shape,
                            dtype=L.torch_dtype(cfg.dtype), device=dev),
    }


def init_cache(cfg: ModelConfig, batch: int, max_len: int, *,
               device=None) -> Dict[str, torch.Tensor]:
    dev = resolve_device(device)
    G, _, _ = _group_counts(cfg)
    kv_shape = (G, batch, max_len, cfg.num_kv_heads, cfg.head_dim)
    dtype = L.torch_dtype(cfg.dtype)
    return {
        **init_state(cfg, batch, device=dev),
        "kv_k": torch.zeros(kv_shape, dtype=dtype, device=dev),
        "kv_v": torch.zeros(kv_shape, dtype=dtype, device=dev),
        "lengths": torch.zeros((batch,), dtype=torch.int32, device=dev),
    }



def prefill(params, cfg: ModelConfig, batch: Dict[str, torch.Tensor],
            max_len: int):
    """Full-sequence forward; returns (last logits (B, V), cache). The KV
    caches are ``max_len`` wide (``T`` if the prompt is longer)."""
    tokens = batch["tokens"]
    B, T = tokens.shape
    x = params["embed"][tokens]
    cache = init_cache(cfg, B, max(max_len, T), device=x.device)
    x, kvs = _run_seq(params, cfg, x, cache)
    for g, (k, v) in enumerate(kvs):
        cache["kv_k"][g, :, :T] = k
        cache["kv_v"][g, :, :T] = v
    h = L.rms_norm(x[:, -1], params["final_norm"], cfg.norm_eps)
    cache["lengths"].fill_(T)
    return h @ params["unembed"], cache


def decode_step(params, cfg: ModelConfig, batch: Dict[str, torch.Tensor],
                cache: Dict[str, torch.Tensor]):
    """One-token decode. batch: {"tokens": (B,) int}. Returns (logits (B,
    V), cache updated in place with lengths + 1)."""
    x = params["embed"][batch["tokens"]]           # (B, D)
    lengths = cache["lengths"]
    sp = params["shared_attn"]
    for i, g in _layer_order(cfg):
        if i is None:
            h = L.rms_norm(x, sp["ln1"], cfg.norm_eps)
            att, _, _ = L.attention_decode(sp["attn"], h, cfg,
                                           cache["kv_k"][g], cache["kv_v"][g],
                                           lengths)
            x = x + att
            h = L.rms_norm(x, sp["ln2"], cfg.norm_eps)
            x = x + L.mlp_block(sp["mlp"], h, cfg)
            continue
        p = params["layers"][i]
        h = L.rms_norm(x, p["ln"], cfg.norm_eps)
        y, s_new, c_new = M.mamba2_step(p["mamba"], h, cfg, cache["ssd"][i],
                                        cache["conv"][i])
        x = x + y
        cache["ssd"][i] = s_new
        cache["conv"][i] = c_new
    h = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    return h @ params["unembed"], {**cache, "lengths": lengths + 1}
