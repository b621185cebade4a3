"""GQA attention over one sequence (prefill, encoder): wrapper of the CUDA
kernel.

Counterpart of the JAX package's ``kernels/flash_attention.py``. q (B, S,
Hq, D), k and v (B, S, Hkv, D), bf16 or float32, causal or full -> (B, S,
Hq, D) in q's type, with the softmax in float32. Unlike the Pallas wrapper
it takes any S: the kernel masks the ragged tail itself. The kernel is
``csrc/flash_attention.cu`` (bf16 on the tensor cores, float32 on the CUDA
cores); CPU tensors take the plain version in ``ref.py``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import attention_ref

COUNT = _build.LaunchCount("flash_attention")
MAX_HEAD_DIM = 128          # the kernel's head-dim registers and tiles
DTYPES = (torch.float32, torch.bfloat16)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True) -> torch.Tensor:
    if (q.dim() != 4 or k.shape != v.shape or k.dim() != 4
            or k.shape[:2] != q.shape[:2] or k.shape[3] != q.shape[3]
            or k.shape[2] < 1 or q.shape[2] % k.shape[2] != 0):
        raise ValueError("flash_attention: expected q (B, S, Hq, D) and k, v "
                         "(B, S, Hkv, D) with Hq a multiple of Hkv, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    if _build.is_plain("flash_attention", q, k, v):
        COUNT.plain_calls += 1
        return attention_ref(q, k, v, causal=causal)
    dev = _build.check_cuda_inputs("flash_attention", q, k, v, dtypes=DTYPES)
    if not q.dtype == k.dtype == v.dtype:
        raise TypeError("flash_attention: q, k and v must share one type, got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    B, S, Hq, D = q.shape
    if D > MAX_HEAD_DIM:
        raise ValueError(f"flash_attention: head_dim {D} > {MAX_HEAD_DIM}")
    bf16 = q.dtype == torch.bfloat16
    if bf16:
        q, k, v = _build.tma_ready(q), _build.tma_ready(k), _build.tma_ready(v)
    out = torch.empty_like(q)
    _build.launch("flash_attention", "memforest_flash_attention", dev,
                  q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                  B, S, Hq, k.shape[2], q.shape[3], D, int(causal), int(bf16))
    COUNT.launches += 1
    return out if out.shape[3] == D else out[..., :D].contiguous()
