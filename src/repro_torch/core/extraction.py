"""Write path stage 1: parallel chunk extraction + cell materialization
(paper §4.1).

Sessions are partitioned into fixed-size b-turn chunks (Eq. 5; default b=2,
the Appendix-C operating point). Chunks are *independent*: the whole
session's chunks are embedded in ONE batched encoder forward — the batched
form of the paper's concurrent extraction calls. The
dependency depth of extraction is therefore 1, vs O(M) for serialized
baselines.

An LLM output-budget constraint is modeled: each extraction call returns at
most `max_facts_per_call` candidates (surplus statements in oversized chunks
are dropped) — this is what degrades Ent-GR at large chunk sizes in the
paper's Table 8.
"""
from __future__ import annotations

import time
from typing import List, Sequence, Tuple

from repro_torch.core.types import DialogueCell, RawCandidate, Session, WriteStats
from repro_torch.data import templates as T

DEFAULT_MAX_FACTS_PER_CALL = 6


def chunk_session(session: Session, b: int) -> List[Tuple[int, str, float]]:
    """Partition into ceil(n/b) chunks of b turns: (chunk_idx, text, ts)."""
    chunks = []
    turns = session.turns
    for j in range(0, len(turns), b):
        grp = turns[j:j + b]
        text = " ".join(f"[{t.role}] {t.text}" for t in grp)
        chunks.append((j // b, text, grp[0].ts))
    return chunks


def extract_candidates(
    chunk_text: str,
    source: Tuple[str, int],
    max_facts: int = DEFAULT_MAX_FACTS_PER_CALL,
) -> List[RawCandidate]:
    """One extraction call (deterministic LLM stand-in). Output budget capped
    at `max_facts` candidates — surplus is dropped (recency-last)."""
    cands = T.parse_statement(chunk_text, source)
    return cands[:max_facts]


class SessionExtraction:
    """Per-session extraction output (one element of an extract_sessions
    batch): mirrors the extract_session tuple, plus the session itself."""

    __slots__ = ("session", "candidates", "fact_embs", "cells")

    def __init__(self, session, candidates, fact_embs, cells):
        self.session = session
        self.candidates = candidates
        self.fact_embs = fact_embs
        self.cells = cells


class ParallelExtractor:
    """Batched (= parallel) chunk extraction."""

    def __init__(self, encoder, chunk_turns: int = 2,
                 max_facts_per_call: int = DEFAULT_MAX_FACTS_PER_CALL,
                 concurrency: int = 64):
        self.encoder = encoder
        self.b = chunk_turns
        self.max_facts = max_facts_per_call
        self.concurrency = concurrency

    def extract_session(self, session: Session):
        """Returns (candidates, cells, stats). One batched encode for chunk
        cells + one for candidate texts: dependency depth 1."""
        t0 = time.perf_counter()
        chunks = chunk_session(session, self.b)
        texts = [c[1] for c in chunks]
        embs = self.encoder.encode(texts)             # parallel: one batch
        cells = [
            DialogueCell(-1, session.session_id, idx, text, ts, embs[i])
            for i, (idx, text, ts) in enumerate(chunks)
        ]
        candidates: List[RawCandidate] = []
        for idx, text, ts in chunks:
            candidates.extend(
                extract_candidates(text, (session.session_id, idx), self.max_facts)
            )
        fact_embs = (
            self.encoder.encode([c.text for c in candidates])
            if candidates else None
        )
        stats = WriteStats(
            wall_s=time.perf_counter() - t0,
            llm_dependency_depth=1,
            facts_written=len(candidates),
        )
        return candidates, fact_embs, cells, stats

    def extract_sessions(self, sessions: Sequence[Session]):
        """Cross-session batched extraction: the union of every session's
        chunk texts AND candidate texts is embedded in ONE encoder forward
        (chunks are independent across sessions just as within one, and
        candidate parsing is host-side, so nothing serializes on the model).
        Dependency depth stays 1 regardless of batch size.

        Returns ([SessionExtraction, ...], WriteStats)."""
        t0 = time.perf_counter()
        per_chunks: List[List[Tuple[int, str, float]]] = []
        per_cands: List[List[RawCandidate]] = []
        texts: List[str] = []
        for session in sessions:
            chunks = chunk_session(session, self.b)
            per_chunks.append(chunks)
            texts.extend(c[1] for c in chunks)
            cands: List[RawCandidate] = []
            for idx, text, ts in chunks:
                cands.extend(
                    extract_candidates(text, (session.session_id, idx), self.max_facts)
                )
            per_cands.append(cands)
        for cands in per_cands:
            texts.extend(c.text for c in cands)
        embs = self.encoder.encode(texts)             # ONE cross-session batch

        out: List[SessionExtraction] = []
        pos = 0
        for session, chunks in zip(sessions, per_chunks):
            cells = [
                DialogueCell(-1, session.session_id, idx, text, ts, embs[pos + i])
                for i, (idx, text, ts) in enumerate(chunks)
            ]
            pos += len(chunks)
            out.append(SessionExtraction(session, None, None, cells))
        for ext, cands in zip(out, per_cands):
            ext.candidates = cands
            ext.fact_embs = embs[pos:pos + len(cands)] if cands else None
            pos += len(cands)

        stats = WriteStats(
            wall_s=time.perf_counter() - t0,
            llm_dependency_depth=1 if texts else 0,
            facts_written=sum(len(c) for c in per_cands),
        )
        return out, stats


class SequentialExtractor:
    """Serialized extraction (what a single LLM pass over the session looks
    like) — used as the ablation/baseline cost model."""

    def __init__(self, encoder, chunk_turns: int = 2,
                 max_facts_per_call: int = DEFAULT_MAX_FACTS_PER_CALL):
        self.encoder = encoder
        self.b = chunk_turns
        self.max_facts = max_facts_per_call

    def extract_session(self, session: Session):
        t0 = time.perf_counter()
        chunks = chunk_session(session, self.b)
        cells, candidates = [], []
        for idx, text, ts in chunks:
            emb = self.encoder.encode([text], sequential=True)[0]  # one-by-one
            cells.append(DialogueCell(-1, session.session_id, idx, text, ts, emb))
            candidates.extend(
                extract_candidates(text, (session.session_id, idx), self.max_facts)
            )
        fact_embs = (
            self.encoder.encode([c.text for c in candidates])
            if candidates else None
        )
        stats = WriteStats(
            wall_s=time.perf_counter() - t0,
            llm_dependency_depth=len(chunks),
            facts_written=len(candidates),
        )
        return candidates, fact_embs, cells, stats

    def extract_sessions(self, sessions: Sequence[Session]):
        """Serialized fallback: per-session extraction in a loop (the cost
        model stays honest — no cross-session batching)."""
        out: List[SessionExtraction] = []
        agg = WriteStats()
        for session in sessions:
            candidates, fact_embs, cells, st = self.extract_session(session)
            out.append(SessionExtraction(session, candidates, fact_embs, cells))
            agg.add(st)
        return out, agg
