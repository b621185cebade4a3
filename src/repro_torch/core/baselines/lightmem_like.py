"""LightMem-class baseline (Appendix B.5): buffer accumulation + triggered
extraction + global consolidation.

Buffer updates are ordered; when consolidation triggers, candidates are
compared against a GLOBAL memory snapshot — O(N) touched state per trigger.
Compression (short summaries) loses detail on assistant-side/temporal
evidence (the paper's Table 4 pattern)."""
from __future__ import annotations

from typing import List

from repro_torch.core.baselines.base import FactStore, MemoryBackend, turns_to_candidates
from repro_torch.core.retrieval import answer_query
from repro_torch.core.types import CanonicalFact, Query, QueryResult, Session, WriteStats

BUFFER_TRIGGER = 6


class LightMemLike(MemoryBackend):
    name = "lightmem"

    def __init__(self, encoder, *, device=None):
        super().__init__(encoder, device=device)
        self.store = FactStore(encoder.dim, self.device)
        self.buffer: List = []
        self.consolidations = 0

    def _consolidate(self) -> int:
        """Global consolidation: compare buffered candidates against the whole
        store (O(N) encoder work over the snapshot)."""
        depth = 0
        texts = [c.text for c in self.buffer]
        if not texts:
            return 0
        embs = self.encoder.encode(texts)            # batched extraction
        depth += 1
        # global pass: reread existing memory (compressed snapshot)
        snapshot = " ".join(
            f.text for f, a in zip(self.store.facts, self.store.alive) if a
        )[:4000]
        if snapshot:
            self.encoder.encode([snapshot], sequential=True)
            depth += 1
        for c, e in zip(self.buffer, embs):
            dup = False
            for f, a in zip(self.store.facts, self.store.alive):
                if a and f.subject == c.subject and f.attribute == c.attribute \
                        and f.value == c.value:
                    dup = True
                    break
            if not dup:
                self.store.add(CanonicalFact(
                    fact_id=-1, text=c.text, subject=c.subject,
                    attribute=c.attribute, value=c.value, ts=c.ts,
                    prev_value=c.prev_value, sources=[c.source], emb=None), e)
        self.buffer = []
        self.consolidations += 1
        return depth

    def ingest_session(self, session: Session) -> WriteStats:
        t0, tok0, call0 = self._begin()
        depth = 0
        n0 = self.store.size
        for _idx, text, ts, cands in turns_to_candidates(session):
            self.buffer.extend(cands)                # ordered buffer update
            if len(self.buffer) >= BUFFER_TRIGGER:
                depth += self._consolidate()
        depth += self._consolidate()
        return self._end(t0, tok0, call0, depth, self.store.size - n0)

    def query(self, q: Query, final_topk: int = 10) -> QueryResult:
        import time
        t0 = time.perf_counter()
        q_emb = self.encoder.encode([q.text])[0]
        facts = self.store.topk(q_emb, final_topk)
        t1 = time.perf_counter()
        ans = answer_query(q, facts)
        return QueryResult(answer=ans, evidence=[f.text for f in facts],
                           retrieval_s=t1 - t0, answer_s=time.perf_counter() - t1)
