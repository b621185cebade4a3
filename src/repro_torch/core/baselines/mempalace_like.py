"""MemPalace-class baseline (Appendix B.6): append-oriented raw history.

O(1) write path, fully parallelizable, NO write-time semantic maintenance —
abstraction deferred to query time. Strong fidelity on local lookups, weak on
temporal composition (no structured temporal state)."""
from __future__ import annotations

from typing import List, Tuple

from repro_torch.core.baselines.base import FactStore, MemoryBackend
from repro_torch.core.extraction import chunk_session
from repro_torch.core.retrieval import answer_query
from repro_torch.core.types import CanonicalFact, Query, QueryResult, Session, WriteStats
from repro_torch.data import templates as T


class MemPalaceLike(MemoryBackend):
    name = "mempalace"

    def __init__(self, encoder, chunk_turns: int = 2, *, device=None):
        super().__init__(encoder, device=device)
        self.chunks: List[Tuple[str, str, int]] = []   # (text, session, idx)
        self.store = FactStore(encoder.dim, self.device)
        self.b = chunk_turns

    def ingest_session(self, session: Session) -> WriteStats:
        t0, tok0, call0 = self._begin()
        chunks = chunk_session(session, self.b)
        texts = [c[1] for c in chunks]
        embs = self.encoder.encode(texts)              # one batch, depth 1
        for (idx, text, ts), e in zip(chunks, embs):
            self.chunks.append((text, session.session_id, idx))
            self.store.add(CanonicalFact(
                fact_id=-1, text=text[:300], subject="", attribute="chunk",
                value="", ts=ts, sources=[(session.session_id, idx)], emb=None,
            ), e)
        return self._end(t0, tok0, call0, 1, 0)

    def query(self, q: Query, final_topk: int = 10) -> QueryResult:
        import time
        t0 = time.perf_counter()
        q_emb = self.encoder.encode([q.text])[0]
        # the store's top-k is topk_sim's: score desc, then row asc
        # memlint: ignore[topk-tiebreak]
        raw = self.store.topk(q_emb, final_topk)
        # query-time extraction from raw chunks
        facts: List[CanonicalFact] = []
        for r in raw:
            src = r.sources[0] if r.sources else ("", 0)
            for cand in T.parse_statement(r.text, src):
                facts.append(CanonicalFact(
                    fact_id=-1, text=cand.text, subject=cand.subject,
                    attribute=cand.attribute, value=cand.value, ts=cand.ts,
                    prev_value=cand.prev_value, sources=[cand.source], emb=None))
        t1 = time.perf_counter()
        ans = answer_query(q, facts)
        return QueryResult(answer=ans, evidence=[r.text[:120] for r in raw],
                           retrieval_s=t1 - t0, answer_s=time.perf_counter() - t1)
