"""Level-parallel MemTree summary refresh: wrapper of the CUDA kernel.

Counterpart of the JAX package's ``kernels/tree_refresh.py``. For every dirty
parent of one tree level, the masked mean of its (<= K) children's
embeddings, L2-normalized: (P, K, D) + (P, K) -> (P, D). The kernel is
``csrc/tree_refresh.cu``, one launch per call: a warp per parent up to
``WARP_MAX_D``, above it a cluster of blocks per parent over slices of D
(``plan``). CPU tensors take the plain version in ``ref.py``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import tree_refresh_ref

COUNT = _build.LaunchCount("tree_refresh")

WARP_MAX_D = 256       # a warp covers a row up to this width (two float4 a lane)
BLOCK_COLS = 1024      # floats one block of a cluster covers: a float4 a thread
MAX_CLUSTER = 8        # blocks per cluster (the portable limit)


def plan(D: int):
    """(cluster, slice) for rows of D floats (a multiple of 4): a warp per
    parent (1, D) up to ``WARP_MAX_D``; above it the least power of two of
    blocks per parent that gives each at most ``BLOCK_COLS`` floats, at
    most ``MAX_CLUSTER``, each a slice of D that is a multiple of 4 floats,
    none empty. A wider slice the kernel walks in passes."""
    if D <= WARP_MAX_D:
        return 1, D
    cluster = 1
    while cluster < MAX_CLUSTER and cluster * BLOCK_COLS < D:
        cluster *= 2
    return cluster, -(-D // (4 * cluster)) * 4


def tree_refresh(child_emb: torch.Tensor,
                 child_mask: torch.Tensor) -> torch.Tensor:
    if child_emb.dim() != 3 or child_mask.shape != child_emb.shape[:2]:
        raise ValueError("tree_refresh: expected child_emb (P, K, D) and "
                         f"child_mask (P, K), got {tuple(child_emb.shape)} "
                         f"and {tuple(child_mask.shape)}")
    if _build.is_plain("tree_refresh", child_emb, child_mask):
        COUNT.plain_calls += 1
        return tree_refresh_ref(child_emb, child_mask)
    _build.refuse_grad("tree_refresh", child_emb, child_mask)
    dev = _build.check_cuda_inputs("tree_refresh", child_emb, child_mask)
    P, K, D = child_emb.shape
    # rows of whole 16-byte chunks (zero columns change neither the mean nor
    # the norm)
    child_emb = _build.tma_ready(child_emb, align=4)
    Dp = child_emb.shape[2]
    cluster, slice_ = plan(Dp)
    out = torch.empty((P, Dp), dtype=torch.float32, device=dev)
    _build.launch("tree_refresh", "memforest_tree_refresh", dev,
                  child_emb.data_ptr(), child_mask.data_ptr(), out.data_ptr(),
                  P, K, Dp, cluster, slice_)
    COUNT.launched()
    return out if Dp == D else out[:, :D].contiguous()
