"""MemTree: balanced k-ary temporal index over one scope (paper §3.2, §4.2).

Structure lives on the host (a production serving stack keeps index metadata
host-side); embedding math runs on device via kernels (`tree_refresh`,
`topk_sim`). The tree is a B-tree over the time axis:

  * leaves (level 0) hold evidence items in temporal order,
  * internal nodes summarize contiguous time intervals,
  * inserts descend to the covering level-1 node and split upward when a node
    exceeds the branching factor k — structural inserts touch one
    leaf-to-root path: O(log_k N) dependent depth,
  * semantic refresh is LAZY: inserts only mark ancestor paths dirty
    (coalesced); `Forest.flush` regenerates dirty summaries bottom-up,
    level-parallel, batched across trees.

Time-ordered appends (the common case for an online session stream) take the
rightmost-path fast path — the same reason LSM/B+ bulk loads are cheap.
"""
from __future__ import annotations

import bisect
import math
import re
from typing import Dict, FrozenSet, List, Optional, Set, Tuple

import numpy as np

SUMMARY_CHAR_BUDGET = 320

# content-word tokenizer shared by browse intent matching (retrieval) and the
# per-node word-set caches below — one definition so cached node sets and
# query sets are always comparable
_WORD_RE = re.compile(r"[a-z]+")
STOPWORDS = frozenset(
    "what where when did does do is was the a an to of in on as now first "
    "before after moving become becoming switch switched start started who "
    "which place over since".split()
)


def content_words(text: str) -> FrozenSet[str]:
    return frozenset(
        w for w in _WORD_RE.findall(text.lower()) if w not in STOPWORDS
    )


class TreeArena:
    """One MemTree. Node storage is struct-of-lists indexed by node id."""

    __slots__ = (
        "tree_id", "scope_key", "kind", "k", "dim",
        "parent", "children", "level", "start_ts", "end_ts",
        "payload", "text", "alive", "emb", "dirty", "root", "_n",
        "_deleted_any", "_node_words", "_node_lower",
    )

    def __init__(self, tree_id: int, scope_key: str, kind: str, k: int, dim: int):
        # k >= 3 so that splitting k+1 children yields min-fill 2 on both
        # sides — the classic B-tree order requirement. k = 2 admits 1-child
        # chains with adversarial (out-of-order) inserts and loses the
        # O(log N) height bound (found by hypothesis).
        assert k >= 3, f"branching factor must be >= 3, got {k}"
        self.tree_id = tree_id
        self.scope_key = scope_key
        self.kind = kind          # "entity" | "scene" | "session"
        self.k = k
        self.dim = dim
        self.parent: List[int] = []
        self.children: List[List[int]] = []
        self.level: List[int] = []
        self.start_ts: List[float] = []
        self.end_ts: List[float] = []
        self.payload: List[Optional[int]] = []   # leaf -> item id
        self.text: List[str] = []
        self.alive: List[bool] = []
        self.emb = np.zeros((8, dim), np.float32)
        self.dirty: Set[int] = set()
        self.root: int = -1
        self._n = 0
        self._deleted_any = False
        # memoized per-node text views (browse intent matching re-reads the
        # same node texts for every query); invalidated by refresh_text
        self._node_words: Dict[int, FrozenSet[str]] = {}
        self._node_lower: Dict[int, str] = {}

    # ------------------------------------------------------------------
    # node allocation
    # ------------------------------------------------------------------
    def _alloc(self, level: int, ts: Tuple[float, float], text: str = "",
               payload: Optional[int] = None, emb: Optional[np.ndarray] = None) -> int:
        nid = self._n
        self._n += 1
        self.parent.append(-1)
        self.children.append([])
        self.level.append(level)
        self.start_ts.append(ts[0])
        self.end_ts.append(ts[1])
        self.payload.append(payload)
        self.text.append(text)
        self.alive.append(True)
        if nid >= self.emb.shape[0]:
            self.emb = np.concatenate(
                [self.emb, np.zeros_like(self.emb)], axis=0
            )
        if emb is not None:
            self.emb[nid] = emb
        return nid

    # ------------------------------------------------------------------
    # queries
    # ------------------------------------------------------------------
    @property
    def num_nodes(self) -> int:
        return sum(self.alive)

    @property
    def num_leaves(self) -> int:
        return sum(1 for i in range(self._n) if self.alive[i] and self.level[i] == 0)

    @property
    def height(self) -> int:
        return self.level[self.root] if self.root >= 0 else 0

    def leaves_in_order(self, node: Optional[int] = None) -> List[int]:
        if self.root < 0:
            return []
        node = self.root if node is None else node
        if self.level[node] == 0:
            return [node]
        out: List[int] = []
        for c in self.children[node]:
            out.extend(self.leaves_in_order(c))
        return out

    def root_emb(self) -> np.ndarray:
        return self.emb[self.root] if self.root >= 0 else np.zeros(self.dim, np.float32)

    # ------------------------------------------------------------------
    # browse support: memoized text views + packed child gathers
    # ------------------------------------------------------------------
    def node_words(self, node: int) -> FrozenSet[str]:
        """Memoized content-word set of a node's summary/leaf text."""
        w = self._node_words.get(node)
        if w is None:
            w = content_words(self.text[node])
            self._node_words[node] = w
        return w

    def node_text_lower(self, node: int) -> str:
        """Memoized lowercased node text (anchor substring matching)."""
        t = self._node_lower.get(node)
        if t is None:
            t = self.text[node].lower()
            self._node_lower[node] = t
        return t

    def pack_children(self, nodes: List[int], k_pad: int
                      ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Contiguous child-index arrays for the level-synchronous browse:
        (idx (F, k_pad) int32, mask (F, k_pad) f32, emb (F, k_pad, D) f32).
        The embedding gather is ONE fancy-index over the arena (padding slots
        reuse index 0 and are masked), so packing cost scales with the
        frontier, not with per-child Python calls."""
        F = len(nodes)
        idx = np.zeros((F, k_pad), np.int32)
        mask = np.zeros((F, k_pad), np.float32)
        for i, n in enumerate(nodes):
            kids = self.children[n]
            c = min(len(kids), k_pad)
            idx[i, :c] = kids[:c]
            mask[i, :c] = 1.0
        return idx, mask, self.emb[idx]

    # ------------------------------------------------------------------
    # insertion
    # ------------------------------------------------------------------
    def insert_leaf(self, item_id: int, ts: float, emb: np.ndarray, text: str) -> int:
        """Structural insert + dirty-path marking. Returns the leaf id.
        Dependent depth: one leaf-to-root path = O(log_k N)."""
        leaf = self._alloc(0, (ts, ts), text=text, payload=item_id, emb=emb)
        if self.root < 0:
            self.root = leaf
            self.dirty.add(leaf)
            return leaf
        if self.level[self.root] == 0:
            # second item: grow an internal root above the two leaves
            old = self.root
            new_root = self._alloc(1, (min(self.start_ts[old], ts), max(self.end_ts[old], ts)))
            kids = sorted([old, leaf], key=lambda n: self.start_ts[n])
            self.children[new_root] = kids
            for c in kids:
                self.parent[c] = new_root
            self.root = new_root
            self._mark_dirty_path(new_root)
            return leaf

        target = self._find_level1(ts)
        self._attach(target, leaf)
        self._split_up(target)
        self._mark_dirty_path(self.parent[leaf])
        return leaf

    def _find_level1(self, ts: float) -> int:
        """Descend to the level-1 node covering ts (rightmost fast path for
        appends)."""
        node = self.root
        while self.level[node] > 1:
            kids = self.children[node]
            # pick the last child whose start <= ts, else the first
            chosen = kids[0]
            for c in kids:
                if self.start_ts[c] <= ts:
                    chosen = c
                else:
                    break
            node = chosen
        return node

    def _attach(self, parent: int, child: int) -> None:
        kids = self.children[parent]
        keys = [self.start_ts[c] for c in kids]
        pos = bisect.bisect_right(keys, self.start_ts[child])
        kids.insert(pos, child)
        self.parent[child] = parent
        self._update_range_up(parent)

    def _update_range_up(self, node: int) -> None:
        while node != -1:
            kids = self.children[node]
            if kids:
                self.start_ts[node] = self.start_ts[kids[0]]
                self.end_ts[node] = max(self.end_ts[c] for c in kids)
            node = self.parent[node]

    def _split_up(self, node: int) -> None:
        """B-tree split cascade: node with > k children splits in half."""
        while node != -1 and len(self.children[node]) > self.k:
            kids = self.children[node]
            half = len(kids) // 2
            left_kids, right_kids = kids[:half], kids[half:]
            right = self._alloc(self.level[node],
                                (self.start_ts[right_kids[0]],
                                 max(self.end_ts[c] for c in right_kids)))
            self.children[node] = left_kids
            self.children[right] = right_kids
            for c in right_kids:
                self.parent[c] = right
            self.end_ts[node] = max(self.end_ts[c] for c in left_kids)
            self.start_ts[node] = self.start_ts[left_kids[0]]
            # the left half keeps the old summary but lost half its
            # children — without a dirty mark it would stay stale through
            # the next flush (its ancestors are on the insert path, so the
            # dirty invariant still holds)
            self.dirty.add(node)
            p = self.parent[node]
            if p == -1:
                new_root = self._alloc(self.level[node] + 1,
                                       (self.start_ts[node], self.end_ts[right]))
                self.children[new_root] = [node, right]
                self.parent[node] = new_root
                self.parent[right] = new_root
                self.root = new_root
                self.dirty.add(right)
                self._mark_dirty_path(new_root)
                return
            kids_p = self.children[p]
            kids_p.insert(kids_p.index(node) + 1, right)
            self.parent[right] = p
            self.dirty.add(right)
            # p's child set changed; mark its path explicitly — the caller's
            # leaf-path marking would break early at the already-dirty half
            # and leave p (and its ancestors) stale
            self._mark_dirty_path(p)
            node = p

    def _mark_dirty_path(self, node: int) -> None:
        """Coalesced dirty marking: stop when an already-dirty ancestor is
        found *and* everything above it is dirty too (paper: repeated dirty
        marks on overlapping paths are coalesced)."""
        while node != -1:
            if node in self.dirty:
                # ancestors are guaranteed dirty already (invariant)
                break
            self.dirty.add(node)
            node = self.parent[node]

    # ------------------------------------------------------------------
    # deletion (lifecycle maintenance)
    # ------------------------------------------------------------------
    def delete_leaf(self, leaf: int) -> None:
        assert self.level[leaf] == 0 and self.alive[leaf]
        self._deleted_any = True
        self.alive[leaf] = False
        p = self.parent[leaf]
        if p == -1:               # tree had a single leaf
            self.root = -1
            self.dirty.discard(leaf)
            return
        self.children[p].remove(leaf)
        self.dirty.discard(leaf)
        node = p
        while node != -1 and not self.children[node]:
            self.alive[node] = False
            self.dirty.discard(node)
            q = self.parent[node]
            if q == -1:
                self.root = -1
                return
            self.children[q].remove(node)
            node = q
        # collapse a root with a single child
        while self.root != -1 and self.level[self.root] > 0 and len(self.children[self.root]) == 1:
            only = self.children[self.root][0]
            self.alive[self.root] = False
            self.dirty.discard(self.root)
            self.parent[only] = -1
            self.root = only
        if node != -1:
            self._update_range_up(node)
            self._mark_dirty_path(node)
        elif self.root != -1:
            self._mark_dirty_path(self.root)

    # ------------------------------------------------------------------
    # refresh support (called by Forest.flush)
    # ------------------------------------------------------------------
    def dirty_by_level(self) -> Dict[int, List[int]]:
        out: Dict[int, List[int]] = {}
        for n in self.dirty:
            if self.alive[n]:
                out.setdefault(self.level[n], []).append(n)
        return out

    def refresh_text(self, node: int) -> None:
        """Regenerate the interval summary text from children (token-budget
        concat — the text channel of SummarizeChildren)."""
        parts = []
        for c in self.children[node]:
            t = self.text[c]
            if t:
                parts.append(t)
        joined = " | ".join(parts)
        self.text[node] = joined[:SUMMARY_CHAR_BUDGET]
        self._node_words.pop(node, None)
        self._node_lower.pop(node, None)

    def check_invariants(self) -> None:
        """Test hook: temporal leaf order, parent ranges, balance bound."""
        if self.root < 0:
            return
        leaves = self.leaves_in_order()
        ts = [self.start_ts[l] for l in leaves]
        assert ts == sorted(ts), "leaf temporal order violated"
        n = len(leaves)
        if n >= 2 and not self._deleted_any:
            # B-tree with max fanout k and splits in half: height bound
            bound = math.ceil(math.log(max(n, 2), max(2, (self.k + 1) // 2))) + 1
            assert self.height <= bound, (self.height, bound, n)
        for i in range(self._n):
            if not self.alive[i] or self.level[i] == 0:
                continue
            kids = self.children[i]
            assert kids, f"internal node {i} with no children"
            assert len(kids) <= self.k, "fanout exceeded"
            assert self.start_ts[i] == self.start_ts[kids[0]]
            for c in kids:
                assert self.parent[c] == i
                assert self.level[c] == self.level[i] - 1, "uneven levels"
