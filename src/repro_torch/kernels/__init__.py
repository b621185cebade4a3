"""The port's kernels (CUDA C++ for Hopper, in ``csrc/``), their plain
PyTorch versions (``ref.py``) and the device-index ops (``ops.py``)."""
from typing import Dict

from repro_torch.kernels import (browse_scores, decode_attention,
                                 flash_attention, mamba2_ssd, rwkv6_scan,
                                 topk_sim, tree_refresh)
from repro_torch.kernels._build import LaunchCount

COUNTS: Dict[str, LaunchCount] = {
    "tree_refresh": tree_refresh.COUNT,
    "topk_sim": topk_sim.COUNT,
    "browse_scores": browse_scores.COUNT,
    "flash_attention": flash_attention.COUNT,
    "flash_attention_bwd": flash_attention.BWD_COUNT,
    "decode_attention": decode_attention.COUNT,
    "mamba2_ssd": mamba2_ssd.COUNT,
    "mamba2_ssd_bwd": mamba2_ssd.BWD_COUNT,
    "rwkv6_scan": rwkv6_scan.COUNT,
    "rwkv6_scan_bwd": rwkv6_scan.BWD_COUNT,
}


def reset_counts() -> None:
    for c in COUNTS.values():
        c.reset()
