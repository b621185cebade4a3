"""Building blocks of the models: init, norms, RoPE, attention, MLP.

Counterpart of the JAX package's ``models/layers.py`` (its dense subset and
``group_rms_norm``; zamba2's shared block is built from the same pieces).
Parameters are plain dicts of tensors with the JAX layout: a projection is
stored (d_in, d_out) and applied as ``x @ w``. Every cast follows the
reference: norms and RoPE compute in float32 and return the input's type,
attention computes in float32 and returns q's type.

Attention goes through ``kernels.ops``: on a CUDA tensor prefill runs the
``flash_attention`` kernel and decode the ``decode_attention`` kernel; on a
CPU tensor their plain versions run.
"""
from __future__ import annotations

import math
from typing import Dict, Optional

import torch
import torch.nn.functional as F

from repro_torch.config import ModelConfig
from repro_torch.kernels import ops

Params = Dict[str, torch.Tensor]


def torch_dtype(name: str) -> torch.dtype:
    return {"bfloat16": torch.bfloat16, "float32": torch.float32}[name]


# ---------------------------------------------------------------------------
# initialization: the JAX package's distributions, from a torch.Generator
# ---------------------------------------------------------------------------
def dense_init(gen: torch.Generator, d_in: int, d_out: int,
               dtype: torch.dtype) -> torch.Tensor:
    """normal * 1/sqrt(d_in), (d_in, d_out), on the generator's device."""
    w = torch.randn((d_in, d_out), generator=gen, dtype=torch.float32,
                    device=gen.device)
    return (w * (1.0 / math.sqrt(d_in))).to(dtype)


def embed_init(gen: torch.Generator, vocab: int, d: int,
               dtype: torch.dtype) -> torch.Tensor:
    """normal * 0.02, (vocab, d)."""
    w = torch.randn((vocab, d), generator=gen, dtype=torch.float32,
                    device=gen.device)
    return (w * 0.02).to(dtype)


# ---------------------------------------------------------------------------
# norms and rotary position embedding
# ---------------------------------------------------------------------------
def rms_norm(x: torch.Tensor, gamma: torch.Tensor,
             eps: float = 1e-5) -> torch.Tensor:
    xf = x.to(torch.float32)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * gamma.to(torch.float32)).to(x.dtype)


def group_rms_norm(x: torch.Tensor, gamma: torch.Tensor, num_heads: int,
                   eps: float = 1e-5) -> torch.Tensor:
    """RMS norm per head over the trailing dim split into ``num_heads``
    (rwkv6's WKV output), then the gain; float32 inside, x's type out."""
    *lead, D = x.shape
    xh = x.reshape(*lead, num_heads, D // num_heads).to(torch.float32)
    var = torch.mean(xh * xh, dim=-1, keepdim=True)
    y = (xh * torch.rsqrt(var + eps)).reshape(*lead, D)
    return (y * gamma.to(torch.float32)).to(x.dtype)


def rope(x: torch.Tensor, positions: torch.Tensor,
         theta: float) -> torch.Tensor:
    """x: (..., S, H, D) or (..., H, D) with positions (..., S) or (...,).
    The frequencies follow the reference formula, exp(-log(theta) * i /
    half) in float32."""
    D = x.shape[-1]
    half = D // 2
    freqs = torch.exp(-math.log(theta)
                      * torch.arange(0, half, dtype=torch.float32,
                                     device=x.device) / half)
    ang = positions.to(device=x.device, dtype=torch.float32)[..., None] * freqs
    cos = torch.cos(ang)[..., None, :]          # broadcast over heads
    sin = torch.sin(ang)[..., None, :]
    x1 = x[..., :half].to(torch.float32)
    x2 = x[..., half:].to(torch.float32)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------
def attn_init(gen: torch.Generator, cfg: ModelConfig,
              dtype: torch.dtype) -> Params:
    return {
        "wq": dense_init(gen, cfg.d_model, cfg.q_dim, dtype),
        "wk": dense_init(gen, cfg.d_model, cfg.kv_dim, dtype),
        "wv": dense_init(gen, cfg.d_model, cfg.kv_dim, dtype),
        "wo": dense_init(gen, cfg.q_dim, cfg.d_model, dtype),
    }


def attention_prefill(p: Params, x: torch.Tensor, cfg: ModelConfig,
                      positions: torch.Tensor, *, causal: bool = True,
                      return_kv: bool = False):
    """x: (B, S, D). Returns out, and (k, v) after RoPE if ``return_kv``."""
    B, S, _ = x.shape
    q = (x @ p["wq"]).reshape(B, S, cfg.num_heads, cfg.head_dim)
    k = (x @ p["wk"]).reshape(B, S, cfg.num_kv_heads, cfg.head_dim)
    v = (x @ p["wv"]).reshape(B, S, cfg.num_kv_heads, cfg.head_dim)
    if cfg.rope_theta > 0:
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
    o = ops.attention(q, k, v, causal=causal)
    out = o.reshape(B, S, cfg.q_dim) @ p["wo"]
    if return_kv:
        return out, (k, v)
    return out


def attention_decode(p: Params, x: torch.Tensor, cfg: ModelConfig,
                     k_cache: torch.Tensor, v_cache: torch.Tensor,
                     lengths: torch.Tensor):
    """One-token decode. x: (B, D); caches (B, Smax, Hkv, Dh); lengths (B,)
    int32 on the caches' device. Returns (out (B, D), k_cache, v_cache).

    The new K/V row is written IN PLACE at ``lengths[b]``, clamped to
    Smax - 1 as the reference's ``dynamic_update_slice`` clamps its start:
    a sequence that runs past Smax keeps overwriting the last row. Attention
    then covers ``lengths + 1`` positions (all Smax once past the end)."""
    B, _ = x.shape
    q = (x @ p["wq"]).reshape(B, cfg.num_heads, cfg.head_dim)
    k = (x @ p["wk"]).reshape(B, cfg.num_kv_heads, cfg.head_dim)
    v = (x @ p["wv"]).reshape(B, cfg.num_kv_heads, cfg.head_dim)
    if cfg.rope_theta > 0:
        q = rope(q, lengths, cfg.rope_theta)
        k = rope(k, lengths, cfg.rope_theta)
    rows = torch.arange(B, device=k_cache.device)
    at = torch.clamp(lengths, max=k_cache.shape[1] - 1).long()
    k_cache[rows, at] = k.to(k_cache.dtype)
    v_cache[rows, at] = v.to(v_cache.dtype)
    o = ops.decode_attention(q, k_cache, v_cache, lengths + 1)
    out = o.reshape(B, cfg.q_dim) @ p["wo"]
    return out, k_cache, v_cache


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------
def mlp_init(gen: torch.Generator, cfg: ModelConfig, dtype: torch.dtype,
             d_ff: Optional[int] = None) -> Params:
    Fd = d_ff or cfg.d_ff
    if cfg.mlp_activation == "swiglu":
        return {
            "w_gate": dense_init(gen, cfg.d_model, Fd, dtype),
            "w_up": dense_init(gen, cfg.d_model, Fd, dtype),
            "w_down": dense_init(gen, Fd, cfg.d_model, dtype),
        }
    return {
        "wi": dense_init(gen, cfg.d_model, Fd, dtype),
        "wd": dense_init(gen, Fd, cfg.d_model, dtype),
    }


def mlp_block(p: Params, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """SwiGLU; else GeLU (the tanh form, as ``jax.nn.gelu``'s default) for
    ``"gelu"`` and relu^2 for any other activation, as the reference."""
    if cfg.mlp_activation == "swiglu":
        h = F.silu(x @ p["w_gate"]) * (x @ p["w_up"])
        return h @ p["w_down"]
    h = x @ p["wi"]
    if cfg.mlp_activation == "gelu":
        h = F.gelu(h, approximate="tanh")
    else:
        h = torch.square(F.relu(h))
    return h @ p["wd"]
