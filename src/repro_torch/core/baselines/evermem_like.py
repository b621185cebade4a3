"""EverMemOS-class baseline (Appendix B.4): streaming MemCell formation.

Boundary detection is an ORDERED stream step (b_i depends on H_{i-1}) — one
sequential encoder call per turn. Post-boundary extraction + embedding is
parallel (batched). Per-record O(1) vs memory size but O(M) ordered depth
within a session: accurate but slow writes (the paper's Table 2)."""
from __future__ import annotations

from typing import List

from repro_torch.core.baselines.base import FactStore, MemoryBackend, turns_to_candidates
from repro_torch.core.retrieval import answer_query
from repro_torch.core.types import CanonicalFact, Query, QueryResult, Session, WriteStats

CELL_TARGET = 4  # turns per MemCell (boundary heuristic)


class EverMemLike(MemoryBackend):
    name = "evermem"

    def __init__(self, encoder, *, device=None):
        super().__init__(encoder, device=device)
        self.store = FactStore(encoder.dim, self.device)
        self.cells: List[str] = []
        self.cell_store = FactStore(encoder.dim, self.device)

    def ingest_session(self, session: Session) -> WriteStats:
        t0, tok0, call0 = self._begin()
        depth = 0
        nfacts = 0
        turns = turns_to_candidates(session)
        # 1) ordered boundary pass (sequential, one call per turn)
        cells: List[List] = [[]]
        for i, (idx, text, ts, cands) in enumerate(turns):
            self.encoder.encode([text], sequential=True)  # Boundary(H_{i-1}, r_i)
            depth += 1
            cells[-1].append((text, ts, cands))
            if len(cells[-1]) >= CELL_TARGET:
                cells.append([])
        cells = [c for c in cells if c]
        # 2) per-cell extraction + consolidation (parallel: one batch)
        cell_texts = [" ".join(t for t, _, _ in c) for c in cells]
        if cell_texts:
            cell_embs = self.encoder.encode(cell_texts)
            for ct, ce in zip(cell_texts, cell_embs):
                self.cells.append(ct)
                self.cell_store.add(CanonicalFact(
                    fact_id=-1, text=ct[:200], subject="", attribute="cell",
                    value="", ts=0.0, sources=[], emb=None), ce)
        fact_texts = []
        fact_meta = []
        for c in cells:
            for _t, _ts, cands in c:
                for cand in cands:
                    fact_texts.append(cand.text)
                    fact_meta.append(cand)
        if fact_texts:
            embs = self.encoder.encode(fact_texts)
            depth += 1
            for cand, e in zip(fact_meta, embs):
                self.store.add(CanonicalFact(
                    fact_id=-1, text=cand.text, subject=cand.subject,
                    attribute=cand.attribute, value=cand.value, ts=cand.ts,
                    prev_value=cand.prev_value, sources=[cand.source], emb=None,
                ), e)
                nfacts += 1
        return self._end(t0, tok0, call0, depth, nfacts)

    def query(self, q: Query, final_topk: int = 10) -> QueryResult:
        import time
        t0 = time.perf_counter()
        # agentic pipeline: retrieve facts, check sufficiency, reformulate once
        q_emb = self.encoder.encode([q.text])[0]
        # the store's top-k is topk_sim's: score desc, then row asc
        # memlint: ignore[topk-tiebreak]
        facts = self.store.topk(q_emb, final_topk)
        ans = answer_query(q, facts)
        if not ans and q.anchor_value:
            q2 = self.encoder.encode([q.text + " " + q.anchor_value])[0]
            # the store's top-k is topk_sim's: score desc, then row asc
            # memlint: ignore[topk-tiebreak]
            facts = self.store.topk(q2, final_topk)
        t1 = time.perf_counter()
        ans = answer_query(q, facts)
        return QueryResult(answer=ans, evidence=[f.text for f in facts],
                           retrieval_s=t1 - t0, answer_s=time.perf_counter() - t1)
