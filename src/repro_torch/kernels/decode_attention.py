"""One-token GQA attention over a KV cache (the decode step): wrapper of the
CUDA kernel.

Counterpart of the JAX package's ``kernels/decode_attention.py``. q (B, Hq,
D), caches (B, Smax, Hkv, D), lengths (B,) int32 on the device -> (B, Hq, D)
in q's type. Positions at or past ``lengths[b]`` are masked and never read;
a length of 0 gives zeros, as the Pallas kernel gives. The kernel is
``csrc/decode_attention.cu``; CPU tensors take the plain version in
``ref.py``.
"""
from __future__ import annotations

import functools

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import decode_attention_ref

COUNT = _build.LaunchCount("decode_attention")
MAX_HEAD_DIM = 128
DTYPES = (torch.float32, torch.bfloat16)
MIN_CHUNK = 512             # positions a split owns at least
CHUNK_ALIGN = 32


def plan_splits(B: int, Hkv: int, Smax: int, sms: int):
    """(splits, chunk) for the KV range. One block per (batch, KV head)
    when those fill the card's ``sms`` SMs or the cache is short; otherwise
    about two blocks per SM, each owning at least ``MIN_CHUNK`` positions.
    Chosen from Smax, never from the lengths, which stay on the device."""
    blocks = max(B * Hkv, 1)
    if blocks >= sms or Smax <= MIN_CHUNK:
        return 1, max(Smax, 1)
    splits = min(-(-2 * sms // blocks), -(-Smax // MIN_CHUNK))
    chunk = -(-Smax // splits)
    chunk = -(-chunk // CHUNK_ALIGN) * CHUNK_ALIGN
    return -(-Smax // chunk), chunk


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor,
                     lengths: torch.Tensor) -> torch.Tensor:
    if (q.dim() != 3 or k_cache.dim() != 4 or k_cache.shape != v_cache.shape
            or k_cache.shape[0] != q.shape[0] or k_cache.shape[3] != q.shape[2]
            or k_cache.shape[2] < 1 or q.shape[1] % k_cache.shape[2] != 0
            or lengths.shape != (q.shape[0],)):
        raise ValueError("decode_attention: expected q (B, Hq, D), caches "
                         "(B, Smax, Hkv, D) and lengths (B,), got "
                         f"{tuple(q.shape)}, {tuple(k_cache.shape)}, "
                         f"{tuple(v_cache.shape)}, {tuple(lengths.shape)}")
    if _build.is_plain("decode_attention", q, k_cache, v_cache, lengths):
        COUNT.plain_calls += 1
        return decode_attention_ref(q, k_cache, v_cache, lengths)
    dev = _build.check_cuda_inputs("decode_attention", q, k_cache, v_cache,
                                   dtypes=DTYPES)
    _build.check_cuda_inputs("decode_attention", lengths,
                             dtypes=(torch.int32,))
    if lengths.device != dev:
        raise ValueError("decode_attention: lengths must lie on the device of "
                         "the caches")
    if not q.dtype == k_cache.dtype == v_cache.dtype:
        raise TypeError("decode_attention: q and the caches must share one "
                        f"type, got {q.dtype}, {k_cache.dtype}, "
                        f"{v_cache.dtype}")
    B, Hq, D = q.shape
    Smax, Hkv = k_cache.shape[1], k_cache.shape[2]
    if D > MAX_HEAD_DIM:
        raise ValueError(f"decode_attention: head_dim {D} > {MAX_HEAD_DIM}")
    splits, chunk = plan_splits(B, Hkv, Smax, _sm_count(dev.index or 0))
    out = torch.empty_like(q)
    part_acc = part_ml = None
    if splits > 1:
        part_acc = torch.empty((B, Hq, splits, D), dtype=torch.float32,
                               device=dev)
        part_ml = torch.empty((B, Hq, splits, 2), dtype=torch.float32,
                              device=dev)
    _build.launch("decode_attention", "memforest_decode_attention", dev,
                  q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
                  lengths.data_ptr(), out.data_ptr(),
                  None if part_acc is None else part_acc.data_ptr(),
                  None if part_ml is None else part_ml.data_ptr(),
                  B, Smax, Hq, Hkv, D, chunk, splits,
                  int(q.dtype == torch.bfloat16))
    COUNT.launches += 1
    return out
