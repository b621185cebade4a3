"""Chunked RWKV6 (Finch) WKV scan (rwkv6's prefill): wrapper of the CUDA
kernel.

Counterpart of the JAX package's ``kernels/rwkv6_scan.py``. r, k (B, T, H,
K), v (B, T, H, V), w (B, T, H, K) float32 (raw: the decay is
exp(-exp(w))), u (H, K) (the bonus), state (B, H, K, V) float32 -> (o (B, T,
H, V) in r's type, final state float32). r, k, v and u are bf16 or float32,
one type for the four. ``T`` must be at most ``chunk`` or a multiple of it,
as the reference requires. The kernel is ``csrc/rwkv6_scan.cu``; CPU tensors
take the plain version, ``ref.rwkv6_chunked``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import SCAN_CHUNK, rwkv6_chunked, scan_chunk

COUNT = _build.LaunchCount("rwkv6_scan")
DTYPES = (torch.float32, torch.bfloat16)
MAX_DIM = 128               # K and V: the state and the tiles in shared memory


def rwkv6_scan(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               w: torch.Tensor, u: torch.Tensor, state: torch.Tensor, *,
               chunk: int = SCAN_CHUNK):
    if r.dim() != 4 or v.dim() != 4:
        raise ValueError("rwkv6_scan: expected r, k, w (B, T, H, K) and v (B, "
                         f"T, H, V), got {tuple(r.shape)}, {tuple(v.shape)}")
    B, T, H, K = r.shape
    V = v.shape[-1]
    if (k.shape != r.shape or w.shape != r.shape or v.shape != (B, T, H, V)
            or u.shape != (H, K) or state.shape != (B, H, K, V)):
        raise ValueError("rwkv6_scan: expected r, k, w (B, T, H, K), v (B, "
                         "T, H, V), u (H, K), state (B, H, K, V), got "
                         f"{tuple(r.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}, {tuple(w.shape)}, "
                         f"{tuple(u.shape)}, {tuple(state.shape)}")
    chunk = scan_chunk("rwkv6_scan", T, chunk)
    if _build.is_plain("rwkv6_scan", r, k, v, w, u, state):
        COUNT.plain_calls += 1
        return rwkv6_chunked(r, k, v, w, u, state, chunk=chunk)
    dev = _build.check_cuda_inputs("rwkv6_scan", r, k, v, u, dtypes=DTYPES)
    _build.check_cuda_inputs("rwkv6_scan", w, state, dtypes=(torch.float32,))
    if not (w.device == state.device == dev):
        raise ValueError("rwkv6_scan: inputs must all lie on one CUDA device")
    if not r.dtype == k.dtype == v.dtype == u.dtype:
        raise TypeError("rwkv6_scan: r, k, v and u must share one type, got "
                        f"{r.dtype}, {k.dtype}, {v.dtype}, {u.dtype}")
    if chunk > SCAN_CHUNK or K > MAX_DIM or V > MAX_DIM:
        raise ValueError(f"rwkv6_scan: the kernel takes chunk <= {SCAN_CHUNK} "
                         f"and K, V <= {MAX_DIM}, got chunk={chunk}, K={K}, "
                         f"V={V}")
    o = r.new_empty((B, T, H, V))
    s_out = torch.empty_like(state)
    _build.launch("rwkv6_scan", "memforest_rwkv6_scan", dev,
                  r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
                  u.data_ptr(), state.data_ptr(), o.data_ptr(),
                  s_out.data_ptr(), B, T, H, K, V, chunk,
                  int(r.dtype == torch.bfloat16))
    COUNT.launches += 1
    return o, s_out
