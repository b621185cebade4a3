"""Write path stage 2: canonical fact consolidation (paper §4.1).

Parallel chunk extraction fragments evidence (overlapping chunks re-state the
same fact); canonicalization repairs that WITHOUT reading accumulated memory
state: candidates are normalized, exact-key duplicates merged, and near-
duplicates collapsed by embedding similarity within the batch and against
the existing fact store (same subject+attribute only, via topk_sim).
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

from repro_torch.core.forest import Forest
from repro_torch.core.types import CanonicalFact, RawCandidate


def _norm(s: str) -> str:
    return " ".join(s.strip().lower().split())


def canonicalize(
    candidates: List[RawCandidate],
    embs: Optional[np.ndarray],
    forest: Forest,
    sim_threshold: float = 0.92,
) -> List[CanonicalFact]:
    """Returns the NEW canonical facts (already registered in the forest's
    fact store). Duplicates merge their source references instead.

    One-group form of :func:`canonicalize_batch` — a single definition of
    the dedup rules keeps the batched/sequential state-equivalence contract
    unbreakable by one-sided edits."""
    return canonicalize_batch([(candidates, embs)], forest, sim_threshold)[0]


def canonicalize_batch(
    groups: List[Tuple[List[RawCandidate], Optional[np.ndarray]]],
    forest: Forest,
    sim_threshold: float = 0.92,
) -> List[List[CanonicalFact]]:
    """Multi-session canonicalization in a SINGLE pass (one group per
    session, in arrival order). Semantics match calling :func:`canonicalize`
    once per group in order — same facts, same ids, same merged sources —
    but the two hot costs are batch-amortized:

      * the existing-key map over the fact store is built ONCE per batch
        instead of once per session (the per-session rebuild is O(|facts|),
        which made a sequential ingest loop quadratic in stored facts);
      * the near-duplicate similarity scan inside each group is one gemm
        over the group's fact-index rows (``embs @ embs.T``) instead of a
        python pair loop — the vectorized similarity gate.

    Returns the per-group lists of NEW canonical facts (registered in the
    forest's fact store, in group order)."""
    existing = {}
    for f in forest.facts:
        if forest.fact_alive[f.fact_id]:
            existing[(_norm(f.subject), _norm(f.attribute), _norm(f.value),
                      round(f.ts, 1))] = f

    out: List[List[CanonicalFact]] = []
    for candidates, embs in groups:
        new_facts: List[CanonicalFact] = []
        new_idx: List[int] = []            # candidate index of each new fact
        batch_seen = {}
        sims = embs @ embs.T if embs is not None and len(candidates) else None

        for i, c in enumerate(candidates):
            key = (_norm(c.subject), _norm(c.attribute), _norm(c.value), round(c.ts, 1))
            if key in batch_seen:
                batch_seen[key].sources.append(c.source)
                continue
            if key in existing:
                existing[key].sources.append(c.source)
                continue
            dup = None
            if sims is not None:
                for nf, j in zip(new_facts, new_idx):
                    if (_norm(nf.subject), _norm(nf.attribute)) == key[:2] and \
                            float(sims[i, j]) >= sim_threshold and \
                            _norm(nf.value) == key[2]:
                        dup = nf
                        break
            if dup is not None:
                dup.sources.append(c.source)
                continue
            fact = CanonicalFact(
                fact_id=-1,
                text=c.text,
                subject=c.subject.strip(),
                attribute=c.attribute.strip(),
                value=c.value.strip(),
                ts=c.ts,
                prev_value=c.prev_value,
                sources=[c.source],
                emb=embs[i] if embs is not None else None,
            )
            batch_seen[key] = fact
            new_facts.append(fact)
            new_idx.append(i)

        for f in new_facts:
            forest.add_fact(f)
            # later groups must see this group's facts as existing state,
            # exactly as sequential per-session canonicalize calls would
            existing[(_norm(f.subject), _norm(f.attribute), _norm(f.value),
                      round(f.ts, 1))] = f
        out.append(new_facts)
    return out
