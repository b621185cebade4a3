"""Fused cosine similarity + top-k: wrapper of the CUDA kernel.

Counterpart of the JAX package's ``kernels/topk_sim.py``, MemForest's
recall scan over the fact and root indexes. (Q, D) queries x (N, D) keys ->
(Q, k) float32 scores and int32 key indices, ordered by (score desc, key index
asc); keys at or past ``num_valid`` are masked out, and a slot no valid key
fills holds -1e30 and index -1.

The kernel (``csrc/topk_sim.cu``) splits the keys across blocks, each keeping
a sorted top-k per query, and a second pass merges the splits' lists in the
same two-key order as ``merge_topk``. Normalization, when asked for, happens here
with the ``normalize_rows`` formula, as the JAX wrapper does it outside its
kernel. CPU tensors take the plain version in ``ref.py``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import normalize_rows, topk_sim_ref

COUNT = _build.LaunchCount("topk_sim")

MAX_K = 32
KEY_TILE = 64          # keys per tile of the kernel's first pass
QUERY_BLOCK = 64       # queries per block of the kernel's first pass
BLOCKS_PER_SM = 4      # first-pass blocks to aim for on each SM
MAX_SPLITS = 256       # the merge pass holds one list head per thread


def plan_splits(Q: int, N: int, sm_count: int):
    """(keys per split, number of splits) for the first pass: enough blocks
    to fill the card, each split a whole number of key tiles, at most
    ``MAX_SPLITS`` splits."""
    tiles = max(1, -(-N // KEY_TILE))
    q_blocks = max(1, -(-Q // QUERY_BLOCK))
    want = max(1, min(tiles, (BLOCKS_PER_SM * sm_count) // q_blocks,
                      MAX_SPLITS))
    tiles_per_split = -(-tiles // want)
    return tiles_per_split * KEY_TILE, -(-tiles // tiles_per_split)


def topk_sim(queries: torch.Tensor, keys: torch.Tensor, k: int, *,
             normalize: bool = True, num_valid=None):
    if queries.dim() != 2 or keys.dim() != 2 or queries.shape[1] != keys.shape[1]:
        raise ValueError("topk_sim: expected queries (Q, D) and keys (N, D), "
                         f"got {tuple(queries.shape)} and {tuple(keys.shape)}")
    if not 1 <= k <= MAX_K:
        raise ValueError(f"topk_sim: k must lie in [1, {MAX_K}], got {k}")
    N = keys.shape[0]
    nv = N if num_valid is None else int(num_valid)
    if not 0 <= nv <= N:
        raise ValueError(f"topk_sim: num_valid must lie in [0, {N}], got {nv}")
    if _build.is_plain("topk_sim", queries, keys):
        COUNT.plain_calls += 1
        return topk_sim_ref(queries, keys, k, normalize=normalize,
                            num_valid=num_valid)
    if normalize:
        queries, keys = normalize_rows(queries), normalize_rows(keys)
    dev = _build.check_cuda_inputs("topk_sim", queries, keys)
    Q, D = queries.shape
    sm_count = torch.cuda.get_device_properties(dev).multi_processor_count
    keys_per_split, splits = plan_splits(Q, N, sm_count)
    cand_v = torch.empty((Q, splits, k), dtype=torch.float32, device=dev)
    cand_i = torch.empty((Q, splits, k), dtype=torch.int32, device=dev)
    vals = torch.empty((Q, k), dtype=torch.float32, device=dev)
    idx = torch.empty((Q, k), dtype=torch.int32, device=dev)
    _build.launch("topk_sim", "memforest_topk_sim", dev,
                  queries.data_ptr(), keys.data_ptr(), cand_v.data_ptr(),
                  cand_i.data_ptr(), vals.data_ptr(), idx.data_ptr(),
                  Q, N, D, nv, k, keys_per_split, splits)
    COUNT.launches += 1
    return vals, idx
