"""The main path's three kernels (CUDA C++ for Hopper, in ``csrc/``), their
plain PyTorch versions (``ref.py``) and the device-index ops (``ops.py``)."""
from typing import Dict

from repro_torch.kernels import browse_scores, topk_sim, tree_refresh
from repro_torch.kernels._build import LaunchCount

COUNTS: Dict[str, LaunchCount] = {
    "tree_refresh": tree_refresh.COUNT,
    "topk_sim": topk_sim.COUNT,
    "browse_scores": browse_scores.COUNT,
}


def reset_counts() -> None:
    for c in COUNTS.values():
        c.reset()
