"""MemoryOS-class baseline (Appendix B.3): short/mid/long-term tiers with
ordered promotion and hot profile rewrites.

Write path: AppendQueue -> PageUpdate -> ProfileUpdate. The profile is a
mutable text state; each triggered update REREADS AND REWRITES the whole
profile (O(N) touched state) and the chain is ordered. The profile keeps
only latest values (compression discards transitions), which is the paper's
accuracy failure on historical/temporal queries.
"""
from __future__ import annotations

from collections import deque
from typing import Deque, Dict, List, Tuple

from repro_torch.core.baselines.base import FactStore, MemoryBackend, turns_to_candidates
from repro_torch.core.retrieval import answer_query
from repro_torch.core.types import CanonicalFact, Query, QueryResult, Session, WriteStats

QUEUE_CAP = 8
PAGE_SIZE = 4


class MemoryOSLike(MemoryBackend):
    name = "memoryos"

    def __init__(self, encoder, *, device=None):
        super().__init__(encoder, device=device)
        self.queue: Deque[Tuple[str, float]] = deque(maxlen=QUEUE_CAP)
        self.pages: List[str] = []                       # mid-term
        self.profile: Dict[Tuple[str, str], CanonicalFact] = {}  # long-term latest-state
        self.profile_text = ""
        self.recent_store = FactStore(encoder.dim, self.device)       # queue+pages index

    def ingest_session(self, session: Session) -> WriteStats:
        t0, tok0, call0 = self._begin()
        depth = 0
        nfacts = 0
        pending: List[str] = []
        for _idx, text, ts, cands in turns_to_candidates(session):
            self.queue.append((text, ts))
            pending.append(text)
            if len(pending) >= PAGE_SIZE:
                # PageUpdate: ordered summarization of the page
                page = " ".join(pending)
                self.encoder.encode([page], sequential=True)
                depth += 1
                self.pages.append(page)
                pending = []
            for c in cands:
                # ProfileUpdate: reread + rewrite the WHOLE profile text
                self.profile[(c.subject, c.attribute)] = CanonicalFact(
                    fact_id=-1, text=c.text, subject=c.subject,
                    attribute=c.attribute, value=c.value, ts=c.ts,
                    prev_value=c.prev_value, sources=[c.source], emb=None,
                )
                self.profile_text = " ".join(
                    f.text for f in self.profile.values()
                )
                self.encoder.encode([self.profile_text], sequential=True)  # O(N)
                depth += 1
                nfacts += 1
                emb = self.encoder.encode([c.text])[0]
                self.recent_store.add(CanonicalFact(
                    fact_id=-1, text=c.text, subject=c.subject,
                    attribute=c.attribute, value=c.value, ts=c.ts,
                    prev_value=c.prev_value, sources=[c.source], emb=None,
                ), emb)
        if pending:
            self.encoder.encode([" ".join(pending)], sequential=True)
            depth += 1
            self.pages.append(" ".join(pending))
        return self._end(t0, tok0, call0, depth, nfacts)

    def query(self, q: Query, final_topk: int = 10) -> QueryResult:
        import time
        t0 = time.perf_counter()
        # profile answers current-state; recent store adds top-k recency
        facts = [f for (s, a), f in self.profile.items()
                 if s.lower() == q.subject.lower() and a == q.attribute]
        q_emb = self.encoder.encode([q.text])[0]
        facts += self.recent_store.topk(q_emb, max(final_topk - len(facts), 0))
        t1 = time.perf_counter()
        ans = answer_query(q, facts)
        return QueryResult(answer=ans, evidence=[f.text for f in facts],
                           retrieval_s=t1 - t0, answer_s=time.perf_counter() - t1)
