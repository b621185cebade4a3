"""MemForest system facade: the paper's serve-and-update lifecycle.

    mf = MemForestSystem()               # on the CUDA card
    mf.ingest_batch(sessions)            # write path: extract -> canonicalize
                                         # -> route -> materialize -> flush
    mf.query_batch(queries)              # read path: forest recall -> tree
                                         # browse -> rerank -> answer
    mf.merge_from(other)                 # migration merge (no session replay)
    mf.delete_session(sid)               # targeted deletion, dirty-path refresh
    mf.save(path); MemForestSystem.load(path, device=...)

``device`` takes the place of the JAX package's ``kernel_impl``: on a CUDA
device the main path runs the hand-written kernels, on ``"cpu"`` their plain
PyTorch versions. ``device=None`` means the CUDA card and raises if none is
visible.
"""
from __future__ import annotations

import time
from typing import Dict, List, Optional

from repro_torch.config import MemForestConfig
from repro_torch.core import canonical, extraction, maintenance, routing
from repro_torch.core.encoder import HashingEncoder
from repro_torch.core.forest import Forest
from repro_torch.core.ingest import IngestBatcher
from repro_torch.core.retrieval import Retriever, answer_query
from repro_torch.core.types import Query, QueryResult, Session, WriteStats
from repro_torch.device import resolve_device
from repro_torch.obs import Observability, get_obs


class MemForestSystem:
    name = "memforest"

    def __init__(self, config: Optional[MemForestConfig] = None, encoder=None,
                 *, device=None, parallel_extraction: bool = True,
                 obs: Optional[Observability] = None):
        self.device = resolve_device(device)
        self.config = config or MemForestConfig()
        self.encoder = encoder or HashingEncoder(dim=self.config.embed_dim,
                                                 device=self.device)
        self.obs = get_obs(obs)
        self.forest = Forest(self.config, self.device, obs=self.obs)
        if parallel_extraction:
            self.extractor = extraction.ParallelExtractor(
                self.encoder, chunk_turns=self.config.chunk_turns
            )
        else:
            self.extractor = extraction.SequentialExtractor(
                self.encoder, chunk_turns=self.config.chunk_turns
            )
        self.batcher = IngestBatcher(self.forest, self.extractor, self.config)
        self.retriever = Retriever(self.forest, self.encoder, self.config)
        self.write_stats = WriteStats()

    # ------------------------------------------------------------------
    # write path
    # ------------------------------------------------------------------
    def ingest_session(self, session: Session) -> WriteStats:
        t0 = time.perf_counter()
        tok0 = self.encoder.stats.tokens
        call0 = self.encoder.stats.calls

        candidates, fact_embs, cells, ex_stats = self.extractor.extract_session(session)
        facts = canonical.canonicalize(
            candidates, fact_embs, self.forest,
            sim_threshold=self.config.canonical_sim_threshold,
        )
        max_depth = 0
        for cell in cells:
            self.forest.add_cell(cell)
            routing.materialize_cell(cell, self.forest)
        for f in facts:
            routing.materialize_fact(f, self.forest)
        if not self.config.read_triggered_refresh:
            flush = self.forest.flush()
            max_depth = flush["levels"]

        stats = WriteStats(
            wall_s=time.perf_counter() - t0,
            encoder_tokens=self.encoder.stats.tokens - tok0,
            encoder_calls=self.encoder.stats.calls - call0,
            llm_dependency_depth=ex_stats.llm_dependency_depth + max_depth,
            summary_refreshes=self.forest.summary_refreshes,
            facts_written=len(facts),
        )
        self.write_stats.add(stats)
        return stats

    def ingest_batch(self, sessions: List[Session], *,
                     defer_flush: bool = False) -> List[WriteStats]:
        """Batched write path: N sessions, ONE encoder forward, ONE lazy
        flush whose tree_refresh batches span every session's dirty trees
        (cross-tenant parallelism). State-equivalent to calling
        ingest_session on each session in order.

        ``defer_flush=True`` skips the flush and leaves the dirty trees for
        the maintenance plane (core/maintenance_plane.py) or the next
        reader — the serve engine uses this so ingest drains never block on
        refresh kernels."""
        stats = self.batcher.ingest(
            sessions,
            flush=not (defer_flush or self.config.read_triggered_refresh))
        for s in stats:
            self.write_stats.add(s)
        return stats

    # ------------------------------------------------------------------
    # read path
    # ------------------------------------------------------------------
    def query(self, q: Query, mode: Optional[str] = None,
              final_topk: Optional[int] = None) -> QueryResult:
        t0 = time.perf_counter()
        if self.forest.dirty_trees:
            # read-triggered refresh: first reader pays the deferred flush
            self.forest.flush()
        facts, evidence, rstats = self.retriever.retrieve(
            q.text, mode=mode, final_topk=final_topk
        )
        t1 = time.perf_counter()
        ans = answer_query(q, facts)
        return QueryResult(
            answer=ans,
            evidence=evidence,
            retrieval_s=rstats["retrieval_s"],
            answer_s=time.perf_counter() - t1,
            encoder_calls=rstats["encoder_calls"],
        )

    def query_batch(self, qs: List[Query], mode: Optional[str] = None,
                    final_topk: Optional[int] = None) -> List[QueryResult]:
        """Batched serving path: one encoder forward, one fused topk_sim per
        device-resident index across all queries (kernel Q-dimension), one
        planner forward, and a level-synchronous browse that scores each
        depth level of every (query, tree) lane in a single kernel launch.
        Result-identical to calling query() per element."""
        if self.forest.dirty_trees:
            self.forest.flush()
        results = self.retriever.retrieve_batch(
            [q.text for q in qs], mode=mode, final_topk=final_topk)
        out = []
        for q, (facts, evidence, rstats) in zip(qs, results):
            t1 = time.perf_counter()
            ans = answer_query(q, facts)
            out.append(QueryResult(
                answer=ans, evidence=evidence,
                retrieval_s=rstats["retrieval_s"] / max(len(qs), 1),
                answer_s=time.perf_counter() - t1,
                encoder_calls=rstats["encoder_calls"],
            ))
        return out

    # ------------------------------------------------------------------
    # stats and device residency
    # ------------------------------------------------------------------
    def scale_stats(self) -> Dict[str, int]:
        return self.forest.scale_stats()

    def device_bytes(self) -> int:
        """Bytes currently held by the device-resident index caches."""
        return self.forest.device_bytes()

    def detach_device(self) -> int:
        """Release the device index caches; the next query transparently
        re-uploads. Returns bytes freed."""
        return self.forest.detach_device()

    def state_digest(self) -> str:
        """Content hash of persistent state (persistence.forest_state_digest)
        — the state-identity relation recovery tests compare against. The
        fact and cell embeddings are part of it: a digest taken on the card
        compares with another taken on the card (the CPU's encoder agrees
        within 1e-6, not bitwise)."""
        from repro_torch.core import persistence
        return persistence.forest_state_digest(self.forest)

    # ------------------------------------------------------------------
    # lifecycle
    # ------------------------------------------------------------------
    def merge_from(self, other: "MemForestSystem", *,
                   idempotency_key: Optional[str] = None) -> Dict[str, int]:
        # in-memory facade: DurableMemForest overrides this with the
        # journaled op; callers holding a durable handle never reach here
        # memlint: ignore[journaled-mutation]
        return maintenance.migrate_merge(self.forest, other.forest,
                                         idempotency_key=idempotency_key)

    def delete_session(self, session_id: str) -> Dict[str, int]:
        # in-memory facade: journaled counterpart lives on DurableMemForest
        # memlint: ignore[journaled-mutation]
        return maintenance.delete_session(self.forest, session_id)

    # ------------------------------------------------------------------
    # durability
    # ------------------------------------------------------------------
    def save(self, path: str, *, with_derived: bool = True) -> str:
        from repro_torch.core import persistence
        return persistence.save_forest(self.forest, path,
                                       with_derived=with_derived)

    @classmethod
    def load(cls, path: str, config=None, encoder=None, *,
             rematerialize_derived: bool = False,
             device=None) -> "MemForestSystem":
        """A system on ``device`` (None: the CUDA card) from a snapshot
        written by either package."""
        from repro_torch.core import persistence
        dev = resolve_device(device)
        forest = persistence.load_forest(
            path, config, rematerialize_derived=rematerialize_derived,
            device=dev)
        sys_ = cls(forest.config, encoder, device=dev)
        sys_.adopt(forest)
        return sys_

    def adopt(self, forest: Forest) -> None:
        """Serve ``forest`` (restored from a document with this system's
        config) in place of this system's own; it reports to this system's
        registry."""
        forest.obs = self.obs
        self.forest = forest
        self.retriever.forest = forest
        self.batcher.forest = forest
