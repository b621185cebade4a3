"""MemForest configuration for the PyTorch port.

A copy of the JAX package's ``MemForestConfig`` with the same defaults, so
both packages build the same forest from the same settings.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple


@dataclass(frozen=True)
class MemForestConfig:
    """Paper defaults (Sections 4, 6; Appendix C)."""

    chunk_turns: int = 2            # b = 2 (Appendix C operating point)
    branching_factor: int = 8       # k; Fig. 6d/e knee is moderate (<=16)
    embed_dim: int = 256
    canonical_sim_threshold: float = 0.92
    scene_sim_threshold: float = 0.60
    forest_recall_topk: int = 8     # trees recalled per query
    fact_recall_topk: int = 16      # facts for fact->tree recall
    final_topk: int = 10            # paper: final retrieval budget top-10
    browse_beam: int = 2            # children expanded per level
    browse_mode: str = "llm+planner"  # flat | root-only | emb | emb+planner | llm | llm+planner
    tree_families: Tuple[str, ...] = ("entity", "scene", "session")
    lazy_refresh: bool = True
    level_parallel: bool = True
    # defer the dirty-path flush past ingestion entirely: summaries refresh
    # on the first query that needs them (LSM-style read-triggered
    # compaction). Minimizes write latency; first-read pays the flush.
    read_triggered_refresh: bool = False
    max_nodes_per_tree: int = 4096
    encoder: str = "hashing"        # hashing | model
