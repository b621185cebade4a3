"""Level-synchronous browse scoring: wrapper of the CUDA kernel.

Counterpart of the JAX package's ``kernels/browse_scores.py``. One depth
level of the batched tree browse: every frontier entry scores its (<= K)
packed child embeddings against its own query vector, times the child mask:
(F, K, D), (F, D), (F, K) -> (F, K). The kernel is ``csrc/browse_scores.cu``;
CPU tensors take the plain version in ``ref.py``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import browse_scores_ref

COUNT = _build.LaunchCount("browse_scores")


def browse_scores(child_emb: torch.Tensor, q_emb: torch.Tensor,
                  child_mask: torch.Tensor) -> torch.Tensor:
    if (child_emb.dim() != 3 or q_emb.shape != (child_emb.shape[0],
                                                 child_emb.shape[2])
            or child_mask.shape != child_emb.shape[:2]):
        raise ValueError("browse_scores: expected child_emb (F, K, D), q_emb "
                         f"(F, D) and child_mask (F, K), got "
                         f"{tuple(child_emb.shape)}, {tuple(q_emb.shape)} and "
                         f"{tuple(child_mask.shape)}")
    if _build.is_plain("browse_scores", child_emb, q_emb, child_mask):
        COUNT.plain_calls += 1
        return browse_scores_ref(child_emb, q_emb, child_mask)
    dev = _build.check_cuda_inputs("browse_scores", child_emb, q_emb,
                                   child_mask)
    F, K, D = child_emb.shape
    out = torch.empty((F, K), dtype=torch.float32, device=dev)
    _build.launch("browse_scores", "memforest_browse_scores", dev,
                  child_emb.data_ptr(), q_emb.data_ptr(), child_mask.data_ptr(),
                  out.data_ptr(), F, K, D)
    COUNT.launches += 1
    return out
