"""Level-parallel MemTree summary refresh: wrapper of the CUDA kernel.

Counterpart of the JAX package's ``kernels/tree_refresh.py``. For every dirty
parent of one tree level, the masked mean of its (<= K) children's
embeddings, L2-normalized: (P, K, D) + (P, K) -> (P, D). The kernel is
``csrc/tree_refresh.cu``; CPU tensors take the plain version in ``ref.py``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import tree_refresh_ref

COUNT = _build.LaunchCount("tree_refresh")


def tree_refresh(child_emb: torch.Tensor,
                 child_mask: torch.Tensor) -> torch.Tensor:
    if child_emb.dim() != 3 or child_mask.shape != child_emb.shape[:2]:
        raise ValueError("tree_refresh: expected child_emb (P, K, D) and "
                         f"child_mask (P, K), got {tuple(child_emb.shape)} "
                         f"and {tuple(child_mask.shape)}")
    if _build.is_plain("tree_refresh", child_emb, child_mask):
        COUNT.plain_calls += 1
        return tree_refresh_ref(child_emb, child_mask)
    dev = _build.check_cuda_inputs("tree_refresh", child_emb, child_mask)
    P, K, D = child_emb.shape
    out = torch.empty((P, D), dtype=torch.float32, device=dev)
    _build.launch("tree_refresh", "memforest_tree_refresh", dev,
                  child_emb.data_ptr(), child_mask.data_ptr(), out.data_ptr(),
                  P, K, D)
    COUNT.launches += 1
    return out
