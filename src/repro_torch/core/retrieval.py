"""Query path: forest recall + tree browse (paper §4.3), batched.

Forest recall (Eq. 7): union of root recall (tree-level relevance) and
fact-to-tree recall (evidence-level relevance mapped back through placement),
scored with the fused `topk_sim` kernel against the Forest's DEVICE-RESIDENT
normalized indexes (no per-query host->device transfer or re-normalization).

Browse modes (paper Table 7 ablation):
  * flat        — top-k facts from the flat index, no tree structure
  * root-only   — recalled trees' root summaries as evidence, no descent
  * emb         — embedding-similarity beam descent
  * emb+planner — embedding descent with the planner's rewritten query vector
                  (the paper finds this HURTS: vector similarity can't carry
                  structured browse intent — reproduced here)
  * llm         — guided descent: child scores combine embedding similarity
                  with structured temporal intent (before/after/first/when +
                  anchor matching), the deterministic stand-in for LLM branch
                  selection
  * llm+planner — llm browse + per-tree subqueries from root summaries
                  (anchor terms weighted, tree time-range aware)

The tree browse is LEVEL-SYNCHRONOUS and batched: every (query, tree) pair is
a browse *lane*, and each descent round scores all lanes' expandable beam
nodes in a single ``browse_scores_rows`` kernel launch — the read-path twin
of the flush kernel's cross-tree batch dimension. The kernel gathers the
children by row id from the Forest's node arena on the device, and the
queries from one row per lane uploaded once per browse: a level uploads a
padded (F, K) row-id matrix, its mask and (F,) lane ids, not the (F, K, D)
children the JAX package packs. Intent/anchor bonuses stay on host as
vectorized numpy over the frontier (with per-node content-word sets memoized
on the TreeArena). ``retrieve`` and ``retrieve_batch`` share this engine, so
batched results are identical to the single-query path by construction.

The answerer is SHARED across all memory systems benchmarked (baselines
included): given retrieved canonical facts it applies query semantics
(current/before/when/first). Accuracy therefore measures retrieval quality —
the paper's framing.
"""
from __future__ import annotations

import re
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.config import MemForestConfig
from repro_torch.core.forest import Forest
from repro_torch.core.memtree import TreeArena, content_words as _content_words
from repro_torch.core.types import CanonicalFact, Query
from repro_torch.data import templates as T
from repro_torch.kernels import ops

_BEFORE_RE = re.compile(r"before (?:moving to |becoming |project )?([A-Za-z ]+?)\?")
_WHEN_RE = re.compile(r"^When did")
_FIRST_RE = re.compile(r"first")
_NOW_RE = re.compile(r"now\?$")


class TemporalIntent:
    __slots__ = ("relation", "anchor", "attribute")

    def __init__(self, relation: str, anchor: Optional[str], attribute: str = ""):
        self.relation = relation      # before | when | first | current | none
        self.anchor = anchor
        self.attribute = attribute    # inferred topical family (may be "")

    @staticmethod
    def parse(text: str) -> "TemporalIntent":
        attr = T.infer_attribute(text)
        m = _BEFORE_RE.search(text)
        if m:
            return TemporalIntent("before", m.group(1).strip(), attr)
        if _WHEN_RE.search(text):
            m2 = re.search(r"(?:move to|become|switch to project|preferring) ([A-Za-z ]+?)\?", text)
            return TemporalIntent("when", m2.group(1).strip() if m2 else None, attr)
        if _FIRST_RE.search(text):
            return TemporalIntent("first", None, attr)
        if _NOW_RE.search(text):
            return TemporalIntent("current", None, attr)
        return TemporalIntent("none", None, attr)

    def matches_attr(self, text: str) -> bool:
        if not self.attribute:
            return False
        kws = T.ATTR_KEYWORDS[self.attribute]
        return bool(set(re.findall(r"[a-z]+", text.lower())) & kws)


class _Lane:
    """One (query, tree) pair of the level-synchronous batched browse."""

    __slots__ = ("qi", "tree", "q", "intent", "q_words", "beam", "next_beam",
                 "collected", "index")

    def __init__(self, qi: int, tree: TreeArena, q: np.ndarray,
                 intent: Optional[TemporalIntent], q_words):
        self.qi = qi
        self.tree = tree
        self.q = q                    # browse query vector (planner may mix)
        self.intent = intent          # None for emb browse
        self.q_words = q_words
        self.beam: List[Tuple[int, float]] = []
        self.next_beam: List[Tuple[int, float]] = []
        self.collected: Dict[int, float] = {}
        self.index = 0                # row of the browse's query matrix


class Retriever:
    def __init__(self, forest: Forest, encoder, config: MemForestConfig):
        self.forest = forest
        self.encoder = encoder
        self.config = config
        self.browse_launches = 0      # benchmarks read this

    # ------------------------------------------------------------------
    def retrieve(self, text: str, mode: Optional[str] = None,
                 final_topk: Optional[int] = None) -> Tuple[List[CanonicalFact], List[str], Dict]:
        """Single-query path. Returns (facts, evidence_texts, stats). Shares
        the lane engine with retrieve_batch (a batch of one), so batching is
        result-invariant by construction."""
        return self.retrieve_batch([text], mode=mode, final_topk=final_topk)[0]

    def _stats(self, t0, calls0) -> Dict:
        return {
            "retrieval_s": time.perf_counter() - t0,
            "encoder_calls": self.encoder.stats.calls - calls0,
        }

    # ------------------------------------------------------------------
    def retrieve_batch(self, texts: List[str], mode: Optional[str] = None,
                       final_topk: Optional[int] = None):
        """Batched retrieval for serving throughput: ONE encoder forward, ONE
        fused topk_sim per index over the device-resident normalized fact and
        root matrices for all queries (the kernel's Q dimension), ONE planner
        forward across every (query, tree) lane, and a level-synchronous
        browse that scores each depth level of every lane in a single
        ``browse_scores`` launch. Returns a list of (facts, evidence, stats)
        like retrieve()."""
        cfg = self.config
        mode = mode or cfg.browse_mode
        topk = final_topk or cfg.final_topk
        t0 = time.perf_counter()
        calls0 = self.encoder.stats.calls
        if not texts:
            return []

        obs = self.forest.obs
        with obs.span("retrieve.encode", queries=len(texts)):
            q_embs = self.encoder.encode(texts)              # one batch
        with obs.span("retrieve.recall"):
            fact_dev, n_facts = self.forest.fact_index_device()
            root_dev, n_trees, order = self.forest.root_index_device()
            qd = ops.normalize_rows(
                torch.from_numpy(q_embs).to(self.forest.device))

            flat_idx = None
            if n_facts:
                k_facts = min(max(topk, cfg.fact_recall_topk), n_facts)
                _, flat_idx = ops.topk_sim(qd, fact_dev, k_facts,
                                           normalize=False, num_valid=n_facts)
                flat_idx = flat_idx.cpu().numpy()
            root_vals = root_idx = None
            if n_trees:
                root_vals, root_idx = ops.topk_sim(
                    qd, root_dev, min(cfg.forest_recall_topk * 3, n_trees),
                    normalize=False, num_valid=n_trees)
                root_vals = root_vals.cpu().numpy()
                root_idx = root_idx.cpu().numpy()

        per_q_flat: List[List[CanonicalFact]] = []
        for qi in range(len(texts)):
            flat: List[CanonicalFact] = []
            if flat_idx is not None:
                for i in flat_idx[qi]:
                    if i >= 0 and self.forest.fact_alive[int(i)]:
                        flat.append(self.forest.facts[int(i)])
            per_q_flat.append(flat)

        if mode == "flat":
            pairs = [(flat[:topk], [f.text for f in flat[:topk]])
                     for flat in per_q_flat]
            stats = self._stats(t0, calls0)
            return [(f, e, stats) for f, e in pairs]

        intents = [TemporalIntent.parse(t) for t in texts]
        per_q_trees = [
            self._recall_from_scores(
                q_embs[qi], per_q_flat[qi],
                root_vals[qi] if root_vals is not None else None,
                root_idx[qi] if root_idx is not None else None, order)
            for qi in range(len(texts))
        ]

        if mode == "root-only":
            pairs = []
            for trees in per_q_trees:
                ev = [t.text[t.root][:200] if t.root >= 0 else "" for t in trees]
                pairs.append((self._facts_from_summaries(trees, topk), ev))
            stats = self._stats(t0, calls0)
            return [(f, e, stats) for f, e in pairs]

        use_intent = mode.startswith("llm")
        lanes: List[_Lane] = []
        per_q_lanes: List[List[_Lane]] = [[] for _ in texts]
        for qi, trees in enumerate(per_q_trees):
            q_words = _content_words(texts[qi]) if use_intent else frozenset()
            for tree in trees:
                lane = _Lane(qi, tree, q_embs[qi],
                             intents[qi] if use_intent else None, q_words)
                lanes.append(lane)
                per_q_lanes[qi].append(lane)

        if mode.endswith("+planner") and lanes:
            with obs.span("retrieve.plan", lanes=len(lanes)):
                self._plan_lanes(lanes, texts, mode)

        with obs.span("retrieve.browse", lanes=len(lanes)):
            self._browse_lanes(lanes)

        pairs = []
        for qi in range(len(texts)):
            leaves: List[Tuple[TreeArena, int, float]] = []
            for lane in per_q_lanes[qi]:
                best = sorted(lane.collected.items(), key=lambda kv: -kv[1])[:16]
                leaves.extend((lane.tree, n, s) for n, s in best)
                if use_intent:
                    leaves.extend(self._temporal_navigate(
                        lane.tree, intents[qi], lane.q_words))
            pairs.append(self._resolve(leaves, q_embs[qi], intents[qi], topk,
                                       use_intent=use_intent))
        stats = self._stats(t0, calls0)
        return [(facts, ev, stats) for facts, ev in pairs]

    # ------------------------------------------------------------------
    def _recall_from_scores(self, q_emb, flat_facts, root_vals_row,
                            root_idx_row, order) -> List[TreeArena]:
        """Forest recall from the precomputed fused topk_sim results: root
        scores come straight from the kernel's values (no re-dotting), and
        the tree order is resolved once per batch (hoisted by the caller)."""
        cfg = self.config
        allowed = set(cfg.tree_families)
        scores: Dict[str, float] = {}
        if root_idx_row is not None:
            for v, i in zip(root_vals_row, root_idx_row):
                if i >= 0:
                    key = order[int(i)]
                    scores[key] = max(scores.get(key, -1e9), float(v))
        for f in flat_facts[: cfg.fact_recall_topk]:
            sim = float(f.emb @ q_emb)
            for scope_key, _leaf in self.forest.placement.get(("fact", f.fact_id), []):
                scores[scope_key] = max(scores.get(scope_key, -1e9), 0.95 * sim)
            # fact -> source-session recall (session trees host cells; the
            # facts' source refs map them back — keeps the fallback channel
            # recallable)
            if "session" in allowed:
                for sid, _ in f.sources[:2]:
                    key = f"session:{sid}"
                    if key in self.forest.trees:
                        scores[key] = max(scores.get(key, -1e9), 0.9 * sim)
        # family filter BEFORE ranking (tree-family ablation must not starve)
        scores = {k: v for k, v in scores.items()
                  if self.forest.trees[k].kind in allowed}
        ranked = sorted(scores.items(), key=lambda kv: -kv[1])[: cfg.forest_recall_topk]
        return [self.forest.trees[k] for k, _ in ranked
                if self.forest.trees[k].root >= 0]

    # ------------------------------------------------------------------
    def _plan_lanes(self, lanes: List[_Lane], texts: List[str], mode: str) -> None:
        """Planner: one targeted subquery per (query, tree) lane, encoded in
        ONE batched forward across every lane of every query. For llm browse
        it sharpens the intent with the anchor term; for emb browse the
        rewrite is reduced to a vector mix (which is why emb+planner loses
        signal — paper §6.2)."""
        subs = []
        for lane in lanes:
            root_summary = lane.tree.text[lane.tree.root] if lane.tree.root >= 0 else ""
            subs.append(f"{texts[lane.qi]} [tree] {root_summary[:120]}")
        sub_embs = self.encoder.encode(subs)    # planner cost: 1 batched call
        if mode.startswith("emb"):
            for lane, sub_emb in zip(lanes, sub_embs):
                mix = 0.5 * lane.q + 0.5 * sub_emb
                mix /= (np.linalg.norm(mix) + 1e-6)
                lane.q = mix
        # llm: keep query vectors, the sharpened intent rides on the lane

    # ------------------------------------------------------------------
    def _browse_lanes(self, lanes: List[_Lane]) -> None:
        """Level-synchronous coarse-to-fine descent over every lane at once.
        Per round, all lanes' expandable beam nodes form ONE frontier scored
        by a single ``browse_scores_rows`` launch; leaf hits collect into
        each lane's candidate set. Fills ``lane.collected``. The node arena
        is synced and the lanes' query rows uploaded once, at the first
        frontier."""
        budget = self.config.browse_beam
        for lane in lanes:
            if lane.tree.root >= 0:
                lane.beam = [(lane.tree.root, 1.0)]
        active = [lane for lane in lanes if lane.beam]
        device_side = None
        while active:
            frontier: List[Tuple[_Lane, int]] = []
            for lane in active:
                for node, _s in lane.beam:
                    if lane.tree.level[node] == 0:
                        s = float(lane.tree.emb[node] @ lane.q)
                        if lane.intent is not None:
                            s += self._leaf_bonus(lane.tree, node, lane.intent,
                                                  lane.q_words)
                        lane.collected[node] = max(
                            lane.collected.get(node, -1e9), s)
                    else:
                        frontier.append((lane, node))
            if not frontier:
                break
            if device_side is None:
                arena, row_maps = self.forest.node_arena()
                for i, lane in enumerate(lanes):
                    lane.index = i
                q_rows = torch.from_numpy(np.stack(
                    [lane.q for lane in lanes]).astype(np.float32)).to(
                        arena.device)
                device_side = (arena, row_maps, q_rows)
            sims_rows = self._score_frontier(frontier, *device_side)
            for (lane, node), sims in zip(frontier, sims_rows):
                kids = lane.tree.children[node]
                if lane.intent is not None:
                    sims = sims + self._intent_bonus(lane.tree, kids,
                                                     lane.intent, lane.q_words)
                top = np.argsort(-sims, kind="stable")[:budget]
                lane.next_beam.extend((kids[i], float(sims[i])) for i in top)
            for lane in active:
                agg: Dict[int, float] = {}
                for n, s in lane.next_beam:
                    agg[n] = max(agg.get(n, -1e9), s)
                lane.beam = sorted(agg.items(), key=lambda kv: -kv[1])[: max(budget * 2, 6)]
                lane.next_beam = []
            active = [lane for lane in active if lane.beam]

    def _score_frontier(self, frontier: List[Tuple[_Lane, int]],
                        arena: torch.Tensor, row_maps: Dict[int, np.ndarray],
                        q_rows: torch.Tensor) -> List[np.ndarray]:
        """Score every (entry, child) pair of the frontier in a single kernel
        launch that gathers the children from the node arena. Shapes are
        bucketed to powers of two (F >= 8, K >= 4) as in the JAX package;
        padded slots carry row -1 (score 0). One host buffer holds the row
        ids, the mask and the lane ids: one upload of F*K*8 + F*4 bytes."""
        F = len(frontier)
        kmax = max(len(lane.tree.children[n]) for lane, n in frontier)
        k_pad = 4
        while k_pad < kmax:
            k_pad *= 2
        cap = 8
        while cap < F:
            cap *= 2
        fk = cap * k_pad
        buf = np.zeros(2 * fk + cap, np.int32)
        rows = buf[:fk].reshape(cap, k_pad)
        rows[:] = -1
        mask = buf[fk:2 * fk].view(np.float32).reshape(cap, k_pad)
        lane_of = buf[2 * fk:]
        for i, (lane, n) in enumerate(frontier):
            kids = lane.tree.children[n]
            rows[i, :len(kids)] = row_maps[lane.tree.tree_id][kids]
            mask[i, :len(kids)] = 1.0
            lane_of[i] = lane.index
        self.browse_launches += 1
        with self.forest.obs.span("retrieve.browse_scores", frontier=F,
                                  padded=cap):
            up = torch.from_numpy(buf).to(arena.device)
            sims = ops.browse_scores_rows(
                arena, up[:fk].view(cap, k_pad), q_rows, up[2 * fk:],
                up[fk:2 * fk].view(torch.float32).view(cap, k_pad))
            sims = sims.cpu().numpy()
        return [sims[i, : len(lane.tree.children[n])]
                for i, (lane, n) in enumerate(frontier)]

    def _intent_bonus(self, tree: TreeArena, kids: Sequence[int],
                      intent: TemporalIntent, q_words) -> np.ndarray:
        """The 'LLM reads child summaries' advantage: anchor-term + content-
        word matching and temporal-relation preferences that a bare vector
        score cannot carry. Node text views are memoized on the arena."""
        bonus = np.zeros(len(kids), np.float32)
        anchor = intent.anchor.lower() if intent.anchor else None
        for i, c in enumerate(kids):
            if anchor and anchor in tree.node_text_lower(c):
                bonus[i] += 0.30
            if q_words:
                overlap = len(q_words & tree.node_words(c))
                bonus[i] += min(0.05 * overlap, 0.20)
        if intent.relation == "first":
            bonus[0] += 0.15          # earliest interval
        elif intent.relation == "current":
            bonus[-1] += 0.15         # latest interval
        return bonus

    def _leaf_bonus(self, tree: TreeArena, leaf: int,
                    intent: TemporalIntent, q_words) -> float:
        b = 0.0
        if intent.anchor and intent.anchor.lower() in tree.node_text_lower(leaf):
            b += 0.30
        if q_words:
            b += min(0.05 * len(q_words & tree.node_words(leaf)), 0.20)
        return b

    def _temporal_navigate(self, tree: TreeArena, intent: TemporalIntent,
                           q_words) -> List[Tuple[TreeArena, int, float]]:
        """Explicit temporal navigation over the leaf order — what MemTree
        makes possible and flat stores cannot do (paper §4.3):
          * before/when: the anchor transition leaf + its predecessor,
          * current: the LAST topically-matching leaf,
          * first: the FIRST topically-matching leaf."""
        leaves = tree.leaves_in_order()
        out: List[Tuple[TreeArena, int, float]] = []
        if intent.relation in ("before", "when") and intent.anchor:
            anchor = intent.anchor.lower()
            for j, leaf in enumerate(leaves):
                if anchor in tree.node_text_lower(leaf):
                    out.append((tree, leaf, 1.0))
                    if j > 0:
                        out.append((tree, leaves[j - 1], 0.99))
                    break
        elif intent.relation == "current":
            for leaf in reversed(leaves):
                if intent.matches_attr(tree.text[leaf]) or (
                    q_words and len(q_words & tree.node_words(leaf)) >= 2
                ):
                    out.append((tree, leaf, 1.0))
                    break
        elif intent.relation == "first":
            for leaf in leaves:
                if intent.matches_attr(tree.text[leaf]) or (
                    q_words and len(q_words & tree.node_words(leaf)) >= 2
                ):
                    out.append((tree, leaf, 1.0))
                    break
        return out

    # ------------------------------------------------------------------
    def _resolve(self, leaves, q_emb, intent, topk, *, use_intent: bool):
        seen = set()
        scored: List[Tuple[float, CanonicalFact, str]] = []
        for tree, leaf, score in leaves:
            pay = tree.payload[leaf]
            if pay is None or not tree.alive[leaf]:
                continue
            if pay >= 0:  # fact
                f = self.forest.facts[pay]
                if not self.forest.fact_alive[f.fact_id] or ("f", pay) in seen:
                    continue
                seen.add(("f", pay))
                # navigation hits (score ~1.0) must survive the rerank: they
                # are the LLM browser's explicit selections
                s = float(f.emb @ q_emb) + (score * (0.5 if use_intent else 0.1))
                if use_intent and intent:
                    if intent.anchor and intent.anchor.lower() in f.text.lower():
                        s += 0.3
                    if intent.matches_attr(f.text):
                        s += 0.15
                scored.append((s, f, f.text))
            else:        # dialogue cell — re-extract facts (fallback channel)
                cell = self.forest.cells[-pay - 1]
                if ("c", cell.cell_id) in seen:
                    continue
                seen.add(("c", cell.cell_id))
                for cand in T.parse_statement(cell.text, (cell.session_id, cell.chunk_idx)):
                    ftmp = CanonicalFact(
                        fact_id=-1, text=cand.text, subject=cand.subject,
                        attribute=cand.attribute, value=cand.value, ts=cand.ts,
                        prev_value=cand.prev_value, sources=[cand.source],
                        emb=q_emb * 0,
                    )
                    scored.append((score * 0.5, ftmp, cell.text[:160]))
        scored.sort(key=lambda x: -x[0])
        top = scored[:topk]
        return [f for _, f, _ in top], [e for _, _, e in top]

    def _facts_from_summaries(self, trees: List[TreeArena], topk: int) -> List[CanonicalFact]:
        """root-only mode: parse what survives in root summaries (compressed,
        lossy — the paper's point)."""
        out = []
        for t in trees:
            if t.root < 0:
                continue
            for cand in T.parse_statement(t.text[t.root], ("root", 0)):
                out.append(CanonicalFact(
                    fact_id=-1, text=cand.text, subject=cand.subject,
                    attribute=cand.attribute, value=cand.value, ts=cand.ts,
                    prev_value=cand.prev_value, sources=[cand.source], emb=None,
                ))
        return out[:topk]


# ---------------------------------------------------------------------------
# shared answerer (all systems)
# ---------------------------------------------------------------------------
def answer_query(query: Query, facts: List[CanonicalFact]) -> str:
    """Apply query semantics over the retrieved fact set."""
    rel = [
        f for f in facts
        if f.subject.lower() == query.subject.lower()
        and f.attribute == query.attribute
    ]
    if not rel:
        return ""
    rel.sort(key=lambda f: f.ts)
    if query.qtype == "current":
        return rel[-1].value
    if query.qtype == "historical":
        anchor = (query.anchor_value or "").lower()
        for f in rel:
            if f.value.lower() == anchor and f.prev_value:
                return f.prev_value
        before = [f for f in rel if f.value.lower() != anchor]
        anchor_ts = next((f.ts for f in rel if f.value.lower() == anchor), None)
        if anchor_ts is not None:
            before = [f for f in before if f.ts < anchor_ts]
        return before[-1].value if before else ""
    if query.qtype == "transition_time":
        anchor = (query.anchor_value or "").lower()
        for f in rel:
            if f.value.lower() == anchor:
                return T.ts_to_date(f.ts)
        return ""
    if query.qtype in ("multi_session", "single_session"):
        return rel[0].value
    return rel[-1].value
