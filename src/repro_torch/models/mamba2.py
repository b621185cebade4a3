"""Mamba2 block (SSD), the backbone of the zamba2 hybrid.

Counterpart of the JAX package's ``models/mamba2.py``. in_proj -> [z | x | B
| C | dt]; a causal depthwise convolution over [x | B | C]; the SSD
recurrence; a gated RMSNorm; out_proj. Decode carries (conv_state,
ssd_state).

The sequence form runs the ``mamba2_ssd`` kernel through ``kernels.ops`` (its
plain version on CPU tensors). The single-token step is plain PyTorch on
either device, as the reference's ``mamba2_decode_step`` is plain jnp outside
any Pallas kernel; it lives here and not in ``kernels/ref.py``, which holds
only the plain versions of kernels.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.config import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models import layers as L


def mamba2_dims(cfg: ModelConfig) -> Tuple[int, int, int, int]:
    """(d_inner, num_heads, head_dim, conv_dim)."""
    Din = cfg.d_inner
    P = cfg.ssm_head_dim
    H = Din // P
    conv_dim = Din + 2 * cfg.ssm_state_dim
    return Din, H, P, conv_dim


def mamba2_init(gen: torch.Generator, cfg: ModelConfig,
                dtype: torch.dtype) -> Dict[str, torch.Tensor]:
    """The reference's distributions; ``A_log``, ``dt_bias`` and ``D_skip``
    are float32 whatever ``dtype`` is, as in the reference."""
    D = cfg.d_model
    Din, H, P, conv_dim = mamba2_dims(cfg)
    N = cfg.ssm_state_dim
    dev = gen.device
    f32 = torch.float32
    d_proj = 2 * Din + 2 * N + H  # z, x, B, C, dt
    conv_w = torch.randn((cfg.ssm_conv_width, conv_dim), generator=gen,
                         dtype=f32, device=dev) * 0.2
    return {
        "w_in": L.dense_init(gen, D, d_proj, dtype),
        "w_out": L.dense_init(gen, Din, D, dtype),
        "conv_w": conv_w.to(dtype),
        "conv_b": torch.zeros((conv_dim,), dtype=dtype, device=dev),
        "A_log": torch.log(torch.linspace(1.0, 16.0, H, dtype=f32,
                                          device=dev)),
        "dt_bias": torch.zeros((H,), dtype=f32, device=dev),
        "D_skip": torch.ones((H,), dtype=f32, device=dev),
        "norm_g": torch.ones((Din,), dtype=dtype, device=dev),
    }


def _split_proj(proj: torch.Tensor, cfg: ModelConfig):
    Din, H, P, _ = mamba2_dims(cfg)
    N = cfg.ssm_state_dim
    z = proj[..., :Din]
    xbc = proj[..., Din:Din + Din + 2 * N]
    dt = proj[..., Din + Din + 2 * N:]
    return z, xbc, dt


def _causal_conv_seq(xbc, conv_w, conv_b, conv_state):
    """xbc: (B, T, C); conv_state: (B, W-1, C) carried from earlier tokens.
    The taps are summed in the reference's order, in the activation type."""
    W = conv_w.shape[0]
    T = xbc.shape[1]
    full = torch.cat([conv_state.to(xbc.dtype), xbc], dim=1)
    out = torch.zeros_like(xbc)
    for i in range(W):
        out = out + full[:, i:i + T] * conv_w[i]
    new_state = full[:, -(W - 1):] if W > 1 else conv_state
    return F.silu(out + conv_b), new_state


def _causal_conv_step(xbc, conv_w, conv_b, conv_state):
    """xbc: (B, C), one token."""
    window = torch.cat([conv_state.to(xbc.dtype), xbc[:, None]], dim=1)
    out = torch.einsum("bwc,wc->bc", window, conv_w.to(xbc.dtype)) + conv_b
    return F.silu(out), window[:, 1:]


def _dt_and_A(p, dt: torch.Tensor):
    dt = F.softplus(dt.to(torch.float32) + p["dt_bias"])
    return dt, -torch.exp(p["A_log"])


def mamba2_seq(p, x: torch.Tensor, cfg: ModelConfig, ssd_state: torch.Tensor,
               conv_state: torch.Tensor):
    """x: (B, T, D). Returns (out, new_ssd_state, new_conv_state)."""
    B, T, _ = x.shape
    Din, H, P, _ = mamba2_dims(cfg)
    N = cfg.ssm_state_dim
    z, xbc, dt = _split_proj(x @ p["w_in"], cfg)
    xbc, new_conv = _causal_conv_seq(xbc, p["conv_w"], p["conv_b"], conv_state)
    # the kernel takes contiguous tensors: x, B and C are column slices
    xs = xbc[..., :Din].reshape(B, T, H, P).contiguous()
    Bm = xbc[..., Din:Din + N].contiguous()
    C = xbc[..., Din + N:].contiguous()
    dt, A = _dt_and_A(p, dt)
    y, s_new = ops.mamba2_ssd(xs, dt.contiguous(), A, Bm, C,
                              ssd_state.contiguous())
    y = y + xs * p["D_skip"].to(y.dtype)[None, None, :, None]
    y = y.reshape(B, T, Din)
    y = L.rms_norm(y * F.silu(z), p["norm_g"], cfg.norm_eps)
    return y @ p["w_out"], s_new, new_conv


def mamba2_decode_step(x, dt, A, Bm, C, state):
    """One-token SSD step, the counterpart of the reference's
    ``ref.mamba2_decode_step``. x (B, H, P), dt (B, H), A (H,), Bm and C (B,
    N), state (B, H, P, N) -> (y in x's type, new state in state's type)."""
    f32 = torch.float32
    xf, dtf, Bf, Cf = (a.to(f32) for a in (x, dt, Bm, C))
    sf = state.to(f32)
    decay = torch.exp(dtf * A.to(f32)[None, :])
    upd = (dtf[..., None] * xf)[..., None] * Bf[:, None, None, :]
    s_new = decay[..., None, None] * sf + upd
    y = torch.einsum("bhpn,bn->bhp", s_new, Cf)
    return y.to(x.dtype), s_new.to(state.dtype)


def mamba2_step(p, x: torch.Tensor, cfg: ModelConfig, ssd_state: torch.Tensor,
                conv_state: torch.Tensor):
    """x: (B, D), one token. Returns (out, new_ssd_state, new_conv_state)."""
    B, _ = x.shape
    Din, H, P, _ = mamba2_dims(cfg)
    N = cfg.ssm_state_dim
    z, xbc, dt = _split_proj(x @ p["w_in"], cfg)
    xbc, new_conv = _causal_conv_step(xbc, p["conv_w"], p["conv_b"],
                                      conv_state)
    xs = xbc[..., :Din].reshape(B, H, P)
    Bm = xbc[..., Din:Din + N]
    C = xbc[..., Din + N:]
    dt, A = _dt_and_A(p, dt)
    y, s_new = mamba2_decode_step(xs, dt, A, Bm, C, ssd_state)
    y = y + xs * p["D_skip"].to(y.dtype)[None, :, None]
    y = y.reshape(B, Din)
    y = L.rms_norm(y * F.silu(z), p["norm_g"], cfg.norm_eps)
    return y @ p["w_out"], s_new, new_conv


def state_shapes(cfg: ModelConfig, batch: int):
    """((B, H, P, N) SSD state, float32), ((B, W-1, conv_dim) conv state)."""
    Din, H, P, conv_dim = mamba2_dims(cfg)
    N = cfg.ssm_state_dim
    W = cfg.ssm_conv_width
    return (batch, H, P, N), (batch, W - 1, conv_dim)
