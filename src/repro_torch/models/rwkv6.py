"""RWKV6 "Finch": an attention-free LM with data-dependent decay.

Counterpart of the JAX package's ``models/rwkv6.py``: token-shift lerps for
r/k/v/g, a LoRA tower giving the per-token decay w, a per-head bonus u, the
WKV recurrence, a per-head group norm on its output and a squared-ReLU
channel mix. Decode carries (wkv state, time-mix shift, channel-mix shift)
per layer: constant memory in the context length.

The sequence form runs the ``rwkv6_scan`` kernel through ``kernels.ops``
(its plain version on CPU tensors). The single-token step is plain PyTorch
on either device, as the reference's ``rwkv6_decode_step`` is plain jnp
outside any Pallas kernel.

Parameters: ``embed``, ``ln_in``, ``layers`` (one dict per layer),
``final_norm``, ``unembed``. The state (the serve engine's cache) keeps the
reference's keys and shapes: ``wkv`` (L, B, H, K, K) float32, ``shift_t``
and ``shift_c`` (L, B, D) in cfg.dtype, ``lengths`` (B,) int32.
``decode_step`` updates ``wkv``, ``shift_t`` and ``shift_c`` IN PLACE and
returns a dict with the same tensors and new ``lengths``.

``loss_fn`` trains it: on a card the scans run the ``rwkv6_scan`` kernels
forward and backward.
"""
from __future__ import annotations

from typing import Any, Dict

import torch
import torch.nn.functional as F

from repro_torch.config import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.kernels import ops
from repro_torch.models import layers as L

LORA_DIM = 64


def init_params(cfg: ModelConfig, seed: int = 0, *,
                device=None) -> Dict[str, Any]:
    """Random weights from a seeded ``torch.Generator`` on ``device`` (None
    means the CUDA card), with the reference's distributions."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    dtype = L.torch_dtype(cfg.param_dtype)
    D = cfg.d_model
    H = D // cfg.rwkv_head_size

    def full(v):
        return torch.full((D,), v, dtype=torch.float32, device=dev).to(dtype)

    def normal(shape, scale):
        return (torch.randn(shape, generator=gen, dtype=torch.float32,
                            device=dev) * scale).to(dtype)

    def layer():
        return {
            "ln1": full(1.0), "ln2": full(1.0),
            # time-mix
            "mu_r": full(0.5), "mu_k": full(0.5), "mu_v": full(0.5),
            "mu_w": full(0.5), "mu_g": full(0.5),
            "wr": L.dense_init(gen, D, D, dtype),
            "wk_t": L.dense_init(gen, D, D, dtype),
            "wv_t": L.dense_init(gen, D, D, dtype),
            "wg": L.dense_init(gen, D, D, dtype),
            "wo_t": L.dense_init(gen, D, D, dtype),
            # data-dependent decay LoRA: w = base + tanh(x @ A) @ B
            "w_base": full(-0.5),
            "w_lora_a": L.dense_init(gen, D, LORA_DIM, dtype),
            "w_lora_b": normal((LORA_DIM, D), 0.01),
            "u": normal((H, cfg.rwkv_head_size), 0.1),
            "ln_x": full(1.0),
            # channel-mix
            "mu_cm": full(0.5),
            "w_cm_k": L.dense_init(gen, D, cfg.d_ff, dtype),
            "w_cm_v": L.dense_init(gen, cfg.d_ff, D, dtype),
        }

    return {
        "embed": L.embed_init(gen, cfg.vocab_size, D, dtype),
        "ln_in": full(1.0),
        "layers": [layer() for _ in range(cfg.num_layers)],
        "final_norm": full(1.0),
        "unembed": L.dense_init(gen, D, cfg.vocab_size, dtype),
    }


def _tmix_rkvwg(p, x, shifted, cfg: ModelConfig):
    """r, k, v, w (float32), g from the token-shift lerps; r/k/v/w split
    into heads (..., H, hs)."""
    H = cfg.d_model // cfg.rwkv_head_size
    hs = cfg.rwkv_head_size

    def lerp(mu):
        return x + (shifted - x) * mu

    r = lerp(p["mu_r"]) @ p["wr"]
    k = lerp(p["mu_k"]) @ p["wk_t"]
    v = lerp(p["mu_v"]) @ p["wv_t"]
    g = F.silu(lerp(p["mu_g"]) @ p["wg"])
    xw = lerp(p["mu_w"])
    w = p["w_base"].to(torch.float32) + (
        torch.tanh(xw @ p["w_lora_a"]) @ p["w_lora_b"]).to(torch.float32)

    def split(t):
        return t.reshape(*t.shape[:-1], H, hs)

    return split(r), split(k), split(v), split(w), g


def _time_mix_seq(p, x, cfg: ModelConfig, state, shift_in):
    """x: (B, T, D); state: (B, H, K, V); shift_in: (B, D). Returns (out,
    new_state, new_shift)."""
    B, T, D = x.shape
    H = D // cfg.rwkv_head_size
    shifted = torch.cat([shift_in[:, None, :], x[:, :-1]], dim=1)
    r, k, v, w, g = _tmix_rkvwg(p, x, shifted, cfg)
    wkv, s_new = ops.rwkv6_scan(r, k, v, w, p["u"], state)
    wkv = wkv.reshape(B, T, D)
    out = (L.group_rms_norm(wkv, p["ln_x"], H) * g) @ p["wo_t"]
    return out, s_new, x[:, -1]


def rwkv6_decode_step(r, k, v, w, u, state):
    """One-token WKV6 step, the counterpart of the reference's
    ``ref.rwkv6_decode_step``. r, k, w (B, H, K), v (B, H, V), u (H, K),
    state (B, H, K, V) -> (o in r's type, new state in state's type)."""
    f32 = torch.float32
    rf, kf, vf, wf = (a.to(f32) for a in (r, k, v, w))
    uf = u.to(f32)
    sf = state.to(f32)
    kv = kf[..., :, None] * vf[..., None, :]
    o = torch.einsum("bhk,bhkv->bhv", rf, sf + uf[None, :, :, None] * kv)
    s_new = torch.exp(-torch.exp(wf))[..., None] * sf + kv
    return o.to(r.dtype), s_new.to(state.dtype)


def _time_mix_step(p, x, cfg: ModelConfig, state, shift_in):
    """x: (B, D), one token."""
    B, D = x.shape
    H = D // cfg.rwkv_head_size
    r, k, v, w, g = _tmix_rkvwg(p, x, shift_in, cfg)
    wkv, s_new = rwkv6_decode_step(r, k, v, w, p["u"], state)
    out = (L.group_rms_norm(wkv.reshape(B, D), p["ln_x"], H) * g) @ p["wo_t"]
    return out, s_new, x


def _channel_mix(p, x, shifted):
    lerped = x + (shifted - x) * p["mu_cm"]
    k = torch.square(F.relu(lerped @ p["w_cm_k"]))
    return k @ p["w_cm_v"]


def _layer_seq(cfg, p, x, state, shift_t, shift_c):
    h = L.rms_norm(x, p["ln1"], cfg.norm_eps)
    att, s_new, new_shift_t = _time_mix_seq(p, h, cfg, state, shift_t)
    x = x + att
    h = L.rms_norm(x, p["ln2"], cfg.norm_eps)
    shifted = torch.cat([shift_c[:, None, :], h[:, :-1]], dim=1)
    x = x + _channel_mix(p, h, shifted)
    return x, s_new, new_shift_t, h[:, -1]


def loss_fn(params, cfg: ModelConfig, batch: Dict[str, torch.Tensor]):
    """(loss, {"xent"}): the token cross-entropy over ``labels`` (B, T) (and
    ``loss_mask``), as the reference's ``loss_fn``. Every layer starts from
    zero states, which nothing writes (autograd keeps the tensors it saved
    intact) and which the loss drops. ``cfg.remat`` recomputes each layer
    in the backward pass."""
    tokens = batch["tokens"]
    B, T = tokens.shape
    x = L.rms_norm(params["embed"][tokens], params["ln_in"], cfg.norm_eps)
    D, hs = cfg.d_model, cfg.rwkv_head_size
    wkv0 = torch.zeros((B, D // hs, hs, hs), dtype=torch.float32,
                       device=x.device)
    shift0 = torch.zeros((B, D), dtype=L.torch_dtype(cfg.dtype),
                         device=x.device)
    for p in params["layers"]:
        x = L.remat(_layer_seq, cfg.remat, cfg, p, x, wkv0, shift0, shift0)[0]
    h = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    loss = L.softmax_xent(h @ params["unembed"], batch["labels"],
                          batch.get("loss_mask"))
    return loss, {"xent": loss}


def init_state(cfg: ModelConfig, batch: int, *,
               device=None) -> Dict[str, torch.Tensor]:
    dev = resolve_device(device)
    D = cfg.d_model
    hs = cfg.rwkv_head_size
    dtype = L.torch_dtype(cfg.dtype)
    return {
        "wkv": torch.zeros((cfg.num_layers, batch, D // hs, hs, hs),
                           dtype=torch.float32, device=dev),
        "shift_t": torch.zeros((cfg.num_layers, batch, D), dtype=dtype,
                               device=dev),
        "shift_c": torch.zeros((cfg.num_layers, batch, D), dtype=dtype,
                               device=dev),
        "lengths": torch.zeros((batch,), dtype=torch.int32, device=dev),
    }


def init_cache(cfg: ModelConfig, batch: int, max_len: int, *,
               device=None) -> Dict[str, torch.Tensor]:
    """The state stands in for the KV cache: its size does not depend on
    ``max_len``."""
    return init_state(cfg, batch, device=device)



def prefill(params, cfg: ModelConfig, batch: Dict[str, torch.Tensor],
            max_len: int):
    """Full-sequence forward; returns (last logits (B, V), state)."""
    tokens = batch["tokens"]
    B, T = tokens.shape
    x = L.rms_norm(params["embed"][tokens], params["ln_in"], cfg.norm_eps)
    state = init_state(cfg, B, device=x.device)
    for i, p in enumerate(params["layers"]):
        x, s_new, sh_t, sh_c = _layer_seq(cfg, p, x, state["wkv"][i],
                                          state["shift_t"][i],
                                          state["shift_c"][i])
        state["wkv"][i] = s_new
        state["shift_t"][i] = sh_t
        state["shift_c"][i] = sh_c
    state["lengths"] += T
    h = L.rms_norm(x[:, -1], params["final_norm"], cfg.norm_eps)
    return h @ params["unembed"], state


def decode_step(params, cfg: ModelConfig, batch: Dict[str, torch.Tensor],
                cache: Dict[str, torch.Tensor]):
    """One-token decode. batch: {"tokens": (B,) int}. Returns (logits (B,
    V), state updated in place with lengths + 1)."""
    x = L.rms_norm(params["embed"][batch["tokens"]], params["ln_in"],
                   cfg.norm_eps)
    for i, p in enumerate(params["layers"]):
        h = L.rms_norm(x, p["ln1"], cfg.norm_eps)
        att, s_new, sh_t = _time_mix_step(p, h, cfg, cache["wkv"][i],
                                          cache["shift_t"][i])
        x = x + att
        h = L.rms_norm(x, p["ln2"], cfg.norm_eps)
        x = x + _channel_mix(p, h, cache["shift_c"][i])
        cache["wkv"][i] = s_new
        cache["shift_t"][i] = sh_t
        cache["shift_c"][i] = h
    h = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    return h @ params["unembed"], {**cache, "lengths": cache["lengths"] + 1}
