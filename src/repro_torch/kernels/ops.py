"""Entry points the forest, the retriever and the models call.

The kernels dispatch on the device of their inputs: a CUDA tensor
launches the hand-written kernel, a CPU tensor runs the plain PyTorch
version. The device-index ops below are plain PyTorch on either device, as
they are plain jnp in the JAX package.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.browse_scores import browse_scores, browse_scores_rows
from repro_torch.kernels.decode_attention import (decode_attention,
                                                 decode_attention_lse)
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.mamba2_ssd import mamba2_ssd
from repro_torch.kernels.ref import (grow_rows, normalize_rows,
                                     scatter_normalize_rows, scatter_rows)
from repro_torch.kernels.rwkv6_scan import rwkv6_scan
from repro_torch.kernels.topk_sim import topk_sim
from repro_torch.kernels.tree_refresh import tree_refresh

__all__ = ["attention", "browse_scores", "browse_scores_rows",
           "decode_attention", "decode_attention_lse", "grow_rows",
           "mamba2_ssd", "normalize_rows", "release_rows", "rwkv6_scan", "scatter_normalize_rows",
           "scatter_rows", "topk_sim", "tree_refresh"]


def release_rows(arr: Optional[torch.Tensor],
                 keep: int = 0) -> Optional[torch.Tensor]:
    """Inverse of ``grow_rows``. ``keep=0`` returns None: once the caller
    drops its reference, the memory goes back to PyTorch's allocator.
    ``keep=n`` returns rows [0, n) in a fresh, smaller tensor."""
    if arr is None or keep <= 0:
        return None
    return arr[:keep].clone()


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              causal: bool = True) -> torch.Tensor:
    """GQA attention over one sequence, in the JAX package's layout: q (B, S,
    Hq, D), k and v (B, S, Hkv, D) -> (B, S, Hq, D)."""
    return flash_attention(q, k, v, causal=causal)
