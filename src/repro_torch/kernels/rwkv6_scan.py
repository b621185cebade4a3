"""Chunked RWKV6 (Finch) WKV scan (rwkv6's prefill): wrapper of the CUDA
kernel.

Counterpart of the JAX package's ``kernels/rwkv6_scan.py``. r, k (B, T, H,
K), v (B, T, H, V), w (B, T, H, K) float32 (raw: the decay is
exp(-exp(w))), u (H, K) (the bonus), state (B, H, K, V) float32 -> (o (B, T,
H, V) in r's type, final state float32). r, k, v and u are bf16 or float32,
one type for the four. ``T`` must be at most ``chunk`` or a multiple of it,
as the reference requires. The kernel is ``csrc/rwkv6_scan.cu``; CPU tensors
take the plain version, ``ref.rwkv6_chunked``.

On a card the wrapper dispatches on r's type: bf16 launches the
tensor-core kernel (``mma.sync`` on three-term bf16 splits of the f32
operands, 16-token sub-chunks, a block per (head, slice of 32 or 64
columns of V, batch), 64 only where K <= 64, as shared memory allows; K and
V zero-padded to a multiple of 8 where they are not), float32 the
CUDA-core kernel. Either launches or raises: nothing falls back.
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
    _build.refuse_grad("rwkv6_scan", r, k, v, w, u, state)
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
    bf16 = r.dtype == torch.bfloat16
    width = 0                   # the float32 kernel takes no slice
    if bf16:                    # 16-byte rows for the asynchronous copies
        r, k, v, w, u = (_build.tma_ready(t) for t in (r, k, v, w, u))
        state = _build.tma_ready(state, 2)
        width = _build.scan_slice(B * H, v.shape[-1], _build.sm_count(dev),
                                  widest=64 if K <= 64 else 32, narrowest=32)
    o = r.new_empty(v.shape)
    s_out = torch.empty_like(state)
    _build.launch("rwkv6_scan", "memforest_rwkv6_scan", dev,
                  r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
                  u.data_ptr(), state.data_ptr(), o.data_ptr(),
                  s_out.data_ptr(), B, T, H, r.shape[-1], v.shape[-1], chunk,
                  int(bf16), width)
    COUNT.launched()
    if o.shape[-1] != V or s_out.shape[-2] != K:
        o, s_out = o[..., :V].contiguous(), s_out[..., :K, :V].contiguous()
    return o, s_out
