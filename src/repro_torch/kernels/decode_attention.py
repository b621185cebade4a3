"""One-token GQA attention over a KV cache (the decode step): wrapper of the
CUDA kernel.

Counterpart of the JAX package's ``kernels/decode_attention.py``. q (B, Hq,
D), caches (B, Smax, Hkv, D), lengths (B,) int32 on the device -> (B, Hq, D)
in q's type. Positions at or past ``lengths[b]`` are masked and never read;
a length of 0 gives zeros, as the Pallas kernel gives. The kernel is
``csrc/decode_attention.cu``, one launch per call; CPU tensors take the
plain version in ``ref.py``.

``decode_attention_lse`` also returns each query head's log-sum-exp, (B,
Hq) float32 in log2 units (``flash_attention_lse``'s domain: the natural
log-sum-exp of the scaled scores times log2(e)), -inf at a length of 0: the
same launch, writing it from its final (m, l). A shard of a cache split
over the sequence merges its partial output with the others' by it
(``models.layers.attention_decode_shards``).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import (decode_attention_lse_ref,
                                     decode_attention_ref)

COUNT = _build.LaunchCount("decode_attention")
MAX_HEAD_DIM = 128
DTYPES = (torch.float32, torch.bfloat16)
TILE = 64                   # cache rows per K/V tile in shared memory
CHUNK = 2 * TILE            # cache rows a block owns: two tiles, both in flight
FAN_IN = 16                 # partials per merge, in two levels
BLOCK_HEADS = 16            # bf16: query heads per block at most


def plan_splits(Smax: int):
    """(splits, chunk): the positions cut into fixed chunks of ``CHUNK``
    rows, one block each per (batch, KV head), at every Smax. Made from Smax
    alone: the lengths stay on the device, where a block whose chunk starts
    at or past its length exits at once. The live splits of a sequence are
    merged in split-index order inside the same launch."""
    return max(1, -(-Smax // CHUNK)), CHUNK


def scratch_sizes(B: int, Hq: int, Hkv: int, D: int, splits: int,
                  bf16: bool):
    """(partial floats, counters) to allocate for the kernel's merge with
    ``splits`` > 1: per (batch, KV head, chunk of at most 16 query heads in
    bf16) one slot per split and one per group of ``FAN_IN`` splits, each
    slot (head dim rounded up to 16, then m, l, padding) per query head; a
    counter per group and one for the groups. The kernel's ``Scratch``
    defines the layout; its entry point refuses sizes smaller than that."""
    G = Hq // Hkv
    per_block = min(G, BLOCK_HEADS) if bf16 else G
    blocks = B * Hkv * -(-G // per_block)
    groups = -(-splits // FAN_IN)
    return (blocks * (splits + groups) * per_block * (-(-D // 16) * 16 + 4),
            blocks * (1 + groups))


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor,
                     lengths: torch.Tensor) -> torch.Tensor:
    return _decode(q, k_cache, v_cache, lengths, False)[0]


def decode_attention_lse(q: torch.Tensor, k_cache: torch.Tensor,
                         v_cache: torch.Tensor, lengths: torch.Tensor):
    """``decode_attention`` -> (out (B, Hq, D) in q's type, lse (B, Hq)
    float32 in log2 units, -inf where the length is 0): one launch of the
    kernel on CUDA tensors, ``ref.decode_attention_lse_ref`` on CPU
    tensors."""
    return _decode(q, k_cache, v_cache, lengths, True)


def _decode(q, k_cache, v_cache, lengths, with_lse: bool):
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
        if with_lse:
            return decode_attention_lse_ref(q, k_cache, v_cache, lengths)
        return decode_attention_ref(q, k_cache, v_cache, lengths), None
    _build.refuse_grad("decode_attention", q, k_cache, v_cache)
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
    splits, chunk = plan_splits(Smax)
    # the tensor maps' rule; no published config pads (it copies the caches)
    q, k_cache, v_cache = (_build.tma_ready(x) for x in (q, k_cache, v_cache))
    Dk = q.shape[2]
    out = torch.empty_like(q)
    lse = (torch.empty((B, Hq), dtype=torch.float32, device=dev)
           if with_lse else None)
    part = counters = None          # the merge's scratch, with splits > 1
    n_part = n_counters = 0
    if splits > 1:
        n_part, n_counters = scratch_sizes(B, Hq, Hkv, Dk, splits,
                                           q.dtype == torch.bfloat16)
        part = torch.empty(n_part, dtype=torch.float32, device=dev)
        counters = _build.counters(dev, n_counters)
        n_counters = counters.numel()
    _build.launch("decode_attention", "memforest_decode_attention", dev,
                  q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
                  lengths.data_ptr(), out.data_ptr(),
                  None if lse is None else lse.data_ptr(),
                  None if part is None else part.data_ptr(),
                  None if counters is None else counters.data_ptr(),
                  n_part, n_counters, B, Smax, Hq, Hkv, Dk, D, chunk, splits,
                  int(q.dtype == torch.bfloat16))
    COUNT.launched()
    return (out if Dk == D else out[..., :D].contiguous()), lse
