"""Mem0-class baseline (paper §2.3.2, Appendix B.2): mutable memory records
with embedding retrieval and per-record LLM update adjudication.

Write path per new record: Search(r, K) -> LLMUpdate(r, retrieved) ->
Mutate(S, action). The update call is STATE-DEPENDENT (decisions change with
order), so records are processed sequentially — O(M) dependency depth.
Update semantics overwrite same-(subject, attribute) records (the paper's
historical-evidence loss failure mode).
"""
from __future__ import annotations

from repro_torch.core.baselines.base import FactStore, MemoryBackend, turns_to_candidates
from repro_torch.core.retrieval import answer_query
from repro_torch.core.types import CanonicalFact, Query, QueryResult, Session, WriteStats

RETRIEVE_K = 8


class Mem0Like(MemoryBackend):
    name = "mem0"

    def __init__(self, encoder, *, infer: bool = True, device=None):
        super().__init__(encoder, device=device)
        self.store = FactStore(encoder.dim, self.device)
        self.infer = infer

    def ingest_session(self, session: Session) -> WriteStats:
        t0, tok0, call0 = self._begin()
        depth = 0
        nfacts = 0
        for _idx, text, ts, cands in turns_to_candidates(session):
            for c in cands:
                # Search: embed the new record (independent) ...
                emb = self.encoder.encode([c.text])[0]
                cand_facts = self.store.topk(emb, RETRIEVE_K)
                # ... LLMUpdate: sequential, reads current memory state
                ctx = c.text + " || " + " | ".join(f.text for f in cand_facts)
                self.encoder.encode([ctx], sequential=True)
                depth += 1
                # Mutate: update-in-place if same key exists (loses history)
                action = "add"
                for f in cand_facts:
                    if f.subject == c.subject and f.attribute == c.attribute:
                        action = "update"
                        f.text = c.text
                        f.value = c.value
                        f.ts = c.ts
                        f.prev_value = c.prev_value
                        self.store.set_emb(f.fact_id, emb)
                        f.emb = emb
                        break
                if action == "add":
                    self.store.add(CanonicalFact(
                        fact_id=-1, text=c.text, subject=c.subject,
                        attribute=c.attribute, value=c.value, ts=c.ts,
                        prev_value=c.prev_value, sources=[c.source], emb=None,
                    ), emb)
                    nfacts += 1
        return self._end(t0, tok0, call0, depth, nfacts)

    def query(self, q: Query, final_topk: int = 10) -> QueryResult:
        import time
        t0 = time.perf_counter()
        q_emb = self.encoder.encode([q.text])[0]
        facts = self.store.topk(q_emb, final_topk)
        t1 = time.perf_counter()
        ans = answer_query(q, facts)
        return QueryResult(answer=ans, evidence=[f.text for f in facts],
                           retrieval_s=t1 - t0, answer_s=time.perf_counter() - t1)
