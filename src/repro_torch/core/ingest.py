"""Batched multi-session ingestion engine (cross-tenant write batching).

``MemForestSystem.ingest_session`` processes one session at a time, so the
batched encoder forward and the level-parallel ``tree_refresh`` kernel only
ever see one session's worth of work. Real deployments ingest many tenants'
sessions concurrently; the :class:`IngestBatcher` turns that concurrency
into batch dimensions:

  1. **extract**   — every session is chunked, and the union of all chunk
     texts + candidate texts across the whole batch is embedded in ONE
     encoder forward (``ParallelExtractor.extract_sessions``);
  2. **canonicalize** — one single pass over all sessions' candidates with
     the existing-key map built once and a vectorized (gemm) near-duplicate
     similarity gate (``canonical.canonicalize_batch``);
  3. **route/materialize** — leaves land in per-scope trees in session
     arrival order (scene clustering is order-dependent state, so this
     stays a loop — it is host-side numpy and cheap);
  4. **flush**     — ONE lazy ``Forest.flush()`` whose per-level
     ``tree_refresh`` batches span every dirty tree across every session in
     the batch: the paper's same-level/cross-tree parallelism becomes
     cross-*tenant* parallelism.

The resulting forest state is equivalent to sequentially ingesting the same
sessions in the same order (same facts, same tree structure, same query
answers) while encoder forwards
and refresh kernel launches stop scaling with the number of sessions.

Multi-device serve: when the Forest carries a mesh (``Forest.set_mesh``),
the flush's per-level ``tree_refresh`` batches are additionally padded to a
shard multiple and sharded over the mesh's data axis inside
``Forest._refresh_batch`` — nothing changes here, and the refreshed
embeddings are bitwise identical to the mesh=None flush (per-parent math is
row-local; see kernels/shard_ops.py).
"""
from __future__ import annotations

import time
from typing import List, Sequence

from repro_torch.core import canonical, routing
from repro_torch.core.types import Session, WriteStats


class IngestBatcher:
    """Batches whole-session writes against one Forest.

    Stateless between calls apart from counters; safe to reuse. The batcher
    requires an extractor with ``extract_sessions`` (ParallelExtractor and
    SequentialExtractor both provide it — the latter degrades to per-chunk
    encoder calls but still shares canonicalization and the single flush).
    """

    def __init__(self, forest, extractor, config):
        self.forest = forest
        self.extractor = extractor
        self.config = config
        self.batches = 0
        self.sessions_ingested = 0

    def ingest(self, sessions: Sequence[Session], *,
               flush: bool = True) -> List[WriteStats]:
        """Ingest a batch of sessions; returns per-session WriteStats.

        ``flush=False`` leaves the forest dirty (read-triggered refresh
        deployments let the first reader pay the deferred flush)."""
        if not sessions:
            return []
        encoder = self.extractor.encoder
        t0 = time.perf_counter()
        tok0 = encoder.stats.tokens
        call0 = encoder.stats.calls
        refresh0 = self.forest.summary_refreshes

        obs = self.forest.obs
        with obs.span("ingest.extract", sessions=len(sessions)):
            extractions, ex_stats = self.extractor.extract_sessions(sessions)
        with obs.span("ingest.canonicalize"):
            per_session_facts = canonical.canonicalize_batch(
                [(e.candidates, e.fact_embs) for e in extractions],
                self.forest,
                sim_threshold=self.config.canonical_sim_threshold,
            )
        with obs.span("ingest.route"):
            for ext, facts in zip(extractions, per_session_facts):
                for cell in ext.cells:
                    self.forest.add_cell(cell)
                    routing.materialize_cell(cell, self.forest)
                for f in facts:
                    routing.materialize_fact(f, self.forest)

        levels = 0
        if flush:
            levels = self.forest.flush()["levels"]

        self.batches += 1
        self.sessions_ingested += len(sessions)

        # batch-level costs (wall clock, encoder forwards, flush depth) are
        # amortized: attributed to the batch's first stats object, zero on
        # the rest — summing per-session stats reproduces batch totals
        wall = time.perf_counter() - t0
        out: List[WriteStats] = []
        for i, facts in enumerate(per_session_facts):
            out.append(WriteStats(
                wall_s=wall if i == 0 else 0.0,
                encoder_tokens=(encoder.stats.tokens - tok0) if i == 0 else 0,
                encoder_calls=(encoder.stats.calls - call0) if i == 0 else 0,
                llm_dependency_depth=ex_stats.llm_dependency_depth + levels,
                summary_refreshes=(self.forest.summary_refreshes - refresh0)
                if i == 0 else 0,
                facts_written=len(facts),
            ))
        return out
