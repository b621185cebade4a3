"""Entry points the forest and the retriever call.

The three kernels dispatch on the device of their inputs: a CUDA tensor
launches the hand-written kernel, a CPU tensor runs the plain PyTorch
version. The device-index ops below are plain PyTorch on either device, as
they are plain jnp in the JAX package.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.browse_scores import browse_scores
from repro_torch.kernels.ref import (grow_rows, normalize_rows,
                                     scatter_normalize_rows)
from repro_torch.kernels.topk_sim import topk_sim
from repro_torch.kernels.tree_refresh import tree_refresh

__all__ = ["browse_scores", "grow_rows", "normalize_rows", "release_rows",
           "scatter_normalize_rows", "topk_sim", "tree_refresh"]


def release_rows(arr: Optional[torch.Tensor],
                 keep: int = 0) -> Optional[torch.Tensor]:
    """Inverse of ``grow_rows``. ``keep=0`` returns None: once the caller
    drops its reference, the memory goes back to PyTorch's allocator.
    ``keep=n`` returns rows [0, n) in a fresh, smaller tensor."""
    if arr is None or keep <= 0:
        return None
    return arr[:keep].clone()
