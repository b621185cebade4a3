"""Lifecycle maintenance: merge, delete, migration, compaction (paper §4.4,
§5.6).

Counterpart of the JAX package's ``core/maintenance.py``. All operations edit
PERSISTENT state first (facts, scope assignments, tree structure, placement
maps), then regenerate only derived artifacts whose dependency paths
intersect the affected scopes — via the same lazy dirty-path flush as normal
ingestion (one ``tree_refresh`` launch per tree level).

Migration merge is the paper's Figure-5 experiment: already-materialized
memory states combine WITHOUT replaying raw sessions through extraction.
Matching scopes bulk-insert the other forest's leaves (dirty paths only);
unmatched trees are copied verbatim — their derived artifacts remain valid
and are NOT recomputed.

The node arena on the device (``Forest.node_arena``) keys its rows by tree id
and node id. A tree replaced under its tree id — compaction, or a verbatim
copy into a tree that deletions emptied — goes through
``Forest.replace_tree``, which makes the arena rewrite the tree's rows
(reusing the old tree's rows, so churn does not grow the arena).
"""
from __future__ import annotations

import copy
import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core.forest import Forest
from repro_torch.core.memtree import TreeArena
from repro_torch.core.types import CanonicalFact


def delete_session(forest: Forest, session_id: str, *,
                   flush: bool = True) -> Dict[str, int]:
    """Targeted deletion: the session registry identifies derived facts,
    cells, and tree leaves; only invalidated ancestor paths refresh.

    ``flush=False`` leaves the invalidated paths in ``forest.dirty_trees``
    for the maintenance plane (or the next reader) to refresh — persistent
    state is fully updated either way."""
    reg = forest.session_registry.get(session_id)
    if not reg:
        return {"facts_removed": 0, "leaves_removed": 0}
    leaves_removed = 0
    facts_removed = 0
    for fid in reg["facts"]:
        fact = forest.facts[fid]
        fact.sources = [s for s in fact.sources if s[0] != session_id]
        if fact.sources:
            continue  # still supported by other sessions
        forest.kill_fact(fid)        # dead rows go inert (host + device index)
        facts_removed += 1
        for scope_key, leaf in forest.placement.pop(("fact", fid), []):
            tree = forest.trees[scope_key]
            if tree.alive[leaf]:
                tree.delete_leaf(leaf)
                leaves_removed += 1
                forest.dirty_trees.add(scope_key)
    for cid in reg["cells"]:
        for scope_key, leaf in forest.placement.pop(("cell", cid), []):
            tree = forest.trees[scope_key]
            if tree.alive[leaf]:
                tree.delete_leaf(leaf)
                leaves_removed += 1
                forest.dirty_trees.add(scope_key)
    forest.session_registry.pop(session_id, None)
    if flush:
        forest.flush()
    return {"facts_removed": facts_removed, "leaves_removed": leaves_removed}


def _merge_sources(dst_sources: List[Tuple[str, int]],
                   new_sources: List[Tuple[str, int]]) -> int:
    """Union provenance on (session_id, chunk): re-running a merge (the
    journal-retry case) must not duplicate sources and skew session-registry
    deletion. Returns sources actually added."""
    seen = set(map(tuple, dst_sources))
    added = 0
    for s in new_sources:
        s = tuple(s)
        if s not in seen:
            seen.add(s)
            dst_sources.append(s)
            added += 1
    return added


def _copy_tree_into(dst: Forest, src_tree: TreeArena, scope_key: str,
                    fact_id_map: Dict[int, int], cell_id_map: Dict[int, int]) -> None:
    """Verbatim structural copy (derived artifacts stay valid — no refresh).
    The target may be a tree that deletions emptied (root < 0, nodes left):
    its node ids are overwritten, so the copy enters through
    ``Forest.replace_tree``."""
    t = dst.get_tree(scope_key, src_tree.kind)
    assert t.root < 0, "copy target must be empty"
    n = src_tree._n
    t.parent = list(src_tree.parent)
    t.children = [list(c) for c in src_tree.children]
    t.level = list(src_tree.level)
    t.start_ts = list(src_tree.start_ts)
    t.end_ts = list(src_tree.end_ts)
    t.text = list(src_tree.text)
    t.alive = list(src_tree.alive)
    t.payload = []
    for p in src_tree.payload:
        if p is None:
            t.payload.append(None)
        elif p >= 0:
            t.payload.append(fact_id_map[p])
        else:
            t.payload.append(-cell_id_map[-p - 1] - 1)
    t.emb = src_tree.emb[:max(n, 8)].copy()
    t.root = src_tree.root
    t._n = n
    # a src serialized under deferred flush carries dirty paths whose copied
    # summaries are stale — propagate the marks so they still refresh
    t.dirty = set(src_tree.dirty)
    if t.dirty:
        dst.dirty_trees.add(scope_key)
    # placement rows for the copied leaves
    for nid in range(n):
        if t.alive[nid] and t.level[nid] == 0 and t.payload[nid] is not None:
            p = t.payload[nid]
            if p >= 0:
                dst.placement.setdefault(("fact", p), []).append((scope_key, nid))
            else:
                dst.placement.setdefault(("cell", -p - 1), []).append((scope_key, nid))
    dst.replace_tree(scope_key, t)
    dst.set_root_row(t)


def migrate_merge(dst: Forest, src: Forest, *,
                  idempotency_key: Optional[str] = None,
                  flush: bool = True) -> Dict[str, int]:
    """Merge an already-materialized forest into `dst` (paper Fig. 5).

    1. Reconcile canonical facts (key-dedup; sources union on
       (session_id, chunk) — re-running a merge never duplicates
       provenance).
    2. Matching scopes: bulk time-ordered insert of src leaves -> dirty paths.
    3. Unmatched trees: verbatim copy, NO derived-artifact regeneration.
    4. One lazy flush over dirty paths (deferrable via ``flush=False``).

    ``idempotency_key``: when given, the merge is exactly-once — a key
    already in ``dst.applied_ops`` (persisted in snapshots) makes the call
    a no-op, so journal replay or a duplicated merge webhook cannot
    double-insert leaves or registry rows.
    """
    stats = {"facts_added": 0, "facts_merged": 0, "trees_copied": 0,
             "trees_merged": 0, "skipped_duplicate": 0}
    if idempotency_key is not None:
        if idempotency_key in dst.applied_ops:
            stats["skipped_duplicate"] = 1
            return stats
        dst.applied_ops.add(idempotency_key)

    def key(f: CanonicalFact):
        return (f.subject.lower(), f.attribute, f.value.lower(), round(f.ts, 1))

    existing = {key(f): f.fact_id for f in dst.facts if dst.fact_alive[f.fact_id]}
    fact_id_map: Dict[int, int] = {}
    for f in src.facts:
        if not src.fact_alive[f.fact_id]:
            continue
        k = key(f)
        if k in existing:
            _merge_sources(dst.facts[existing[k]].sources, f.sources)
            fact_id_map[f.fact_id] = existing[k]
            stats["facts_merged"] += 1
        else:
            nf = copy.copy(f)
            nf.sources = []
            _merge_sources(nf.sources, f.sources)
            nid = dst.add_fact(nf)
            fact_id_map[f.fact_id] = nid
            stats["facts_added"] += 1

    cell_id_map: Dict[int, int] = {}
    for c in src.cells:
        nc = copy.copy(c)
        cell_id_map[c.cell_id] = dst.add_cell(nc)

    # scene scopes: cluster ids are forest-local, so match src scenes to dst
    # scenes by centroid similarity (>= threshold merges into the existing
    # scene tree; below it becomes a new scene)
    scene_remap: Dict[str, str] = {}
    thr = dst.config.scene_sim_threshold
    for skey, tree in src.trees.items():
        if tree.kind != "scene":
            continue
        sid = int(skey.split(":")[1])
        cent = src.scene_centroids[sid]
        if dst.scene_centroids.shape[0]:
            sims = dst.scene_centroids @ cent
            best = int(np.argmax(sims))
            if sims[best] >= thr:
                scene_remap[skey] = f"scene:{best}"
                c = dst.scene_counts[best]
                sc = src.scene_counts[sid]
                merged = (dst.scene_centroids[best] * c + cent * sc) / (c + sc)
                dst.scene_centroids[best] = merged / (np.linalg.norm(merged) + 1e-6)
                dst.scene_counts[best] += sc
                continue
        new_id = dst.scene_centroids.shape[0]
        scene_remap[skey] = f"scene:{new_id}"
        dst.scene_centroids = np.concatenate(
            [dst.scene_centroids, cent[None]], axis=0)
        dst.scene_counts.append(src.scene_counts[sid])

    for skey, src_tree in src.trees.items():
        if src_tree.root < 0:
            continue
        dkey = scene_remap.get(skey, skey)
        if dkey in dst.trees and dst.trees[dkey].root >= 0:
            # matched scope: bulk insert src leaves (time-ordered) — dirty
            # paths; the new nodes get fresh arena rows at the next sync
            t = dst.trees[dkey]
            for leaf in src_tree.leaves_in_order():
                p = src_tree.payload[leaf]
                if p is None:
                    continue
                if p >= 0:
                    item_kind, item_id = "fact", fact_id_map[p]
                    if not dst.fact_alive[item_id]:
                        continue
                else:
                    item_kind, item_id = "cell", cell_id_map[-p - 1]
                nl = t.insert_leaf(
                    item_id if item_kind == "fact" else -item_id - 1,
                    src_tree.start_ts[leaf], src_tree.emb[leaf], src_tree.text[leaf],
                )
                dst.placement.setdefault((item_kind, item_id), []).append((dkey, nl))
            dst.dirty_trees.add(dkey)
            stats["trees_merged"] += 1
        else:
            _copy_tree_into(dst, src_tree, dkey, fact_id_map, cell_id_map)
            stats["trees_copied"] += 1

    for sid, reg in src.session_registry.items():
        d = dst.session_registry.setdefault(sid, {"facts": [], "cells": []})
        # registry rows dedup like sources: targeted deletion counts on one
        # row per (session, fact)
        have = set(d["facts"])
        for f in reg["facts"]:
            if f in fact_id_map and fact_id_map[f] not in have:
                have.add(fact_id_map[f])
                d["facts"].append(fact_id_map[f])
        d["cells"].extend(cell_id_map[c] for c in reg["cells"] if c in cell_id_map)

    if flush:
        dst.flush()
    return stats


def rematerialize(forest: Forest, *, new_branching: int) -> Forest:
    """Policy/index migration (paper §4.4): rebuild trees from persistent
    state (facts + scope assignments) under a new tree configuration —
    NO re-extraction, NO session replay; fact embeddings are reused. The
    new forest runs on the same device."""
    new_cfg = dataclasses.replace(forest.config, branching_factor=new_branching)
    out = Forest(new_cfg, forest.device, obs=forest.obs)
    # copy, never alias: facts/cells are mutable records (sources lists grow
    # on merge, cell_id is rewritten by add_cell) and fact_emb rows are
    # zeroed by kill_fact. Embedding arrays inside the records are
    # write-never, so the record copy is shallow on those.
    out.facts = [dataclasses.replace(f, sources=list(f.sources))
                 for f in forest.facts]
    out.fact_alive = list(forest.fact_alive)
    out.fact_emb = forest.fact_emb.copy()
    out.cells = [copy.copy(c) for c in forest.cells]
    out.session_registry = {k: {kk: list(vv) for kk, vv in v.items()}
                            for k, v in forest.session_registry.items()}
    out.scene_centroids = forest.scene_centroids.copy()
    out.scene_counts = list(forest.scene_counts)
    out.applied_ops = set(forest.applied_ops)
    for skey, tree in forest.trees.items():
        for leaf in tree.leaves_in_order():
            p = tree.payload[leaf]
            if p is None or not tree.alive[leaf]:
                continue
            item_kind = "fact" if p >= 0 else "cell"
            item_id = p if p >= 0 else -p - 1
            out.insert_item(skey, tree.kind, item_kind, item_id,
                            tree.start_ts[leaf], tree.emb[leaf], tree.text[leaf])
    out.flush()
    return out


# ---------------------------------------------------------------------------
# compaction (maintenance-plane work item)
# ---------------------------------------------------------------------------
def tree_dead_fraction(tree: TreeArena) -> float:
    """Fraction of arena slots occupied by tombstoned nodes."""
    if tree._n == 0:
        return 0.0
    return 1.0 - (sum(tree.alive) / tree._n)


def compact_tree(forest: Forest, scope_key: str) -> Dict[str, int]:
    """Rebuild one tree's arena without its tombstoned nodes.

    ``delete_leaf`` tombstones (alive=False) rather than reclaiming slots,
    so churned trees accumulate dead rows that every flush gather and browse
    pays for. Compaction re-inserts the live leaves (time order preserved)
    into a fresh tree under the same tree id, rewrites the affected
    placement rows, and leaves the new summaries to the normal lazy flush.
    The fresh tree enters through ``Forest.replace_tree``: the node arena on
    the device keeps rows by (tree id, node id), and the old tree's node ids
    are no longer the new tree's. The rewritten tree and placement rows ARE
    persistent state (forest_state_digest covers them) — on a durable
    store, compact through ``DurableMemForest.compact_tree`` so a crash
    replays it. The rebuild is deterministic, so replay is exact.
    """
    old = forest.trees[scope_key]
    live = [(old.payload[l], old.start_ts[l], old.emb[l].copy(), old.text[l])
            for l in old.leaves_in_order()
            if old.alive[l] and old.payload[l] is not None]
    reclaimed = old._n - len(live)

    t = TreeArena(old.tree_id, scope_key, old.kind, old.k, forest.config.embed_dim)
    forest.replace_tree(scope_key, t)
    # drop this scope's stale placement rows, then re-add from the new leaves
    for payload, _ts, _emb, _text in live:
        pkey = ("fact", payload) if payload >= 0 else ("cell", -payload - 1)
        rows = forest.placement.get(pkey)
        if rows:
            forest.placement[pkey] = [r for r in rows if r[0] != scope_key]
    for payload, ts, emb, text in live:
        leaf = t.insert_leaf(payload, ts, emb, text)
        pkey = ("fact", payload) if payload >= 0 else ("cell", -payload - 1)
        forest.placement.setdefault(pkey, []).append((scope_key, leaf))
    forest.set_root_row(t)
    if live:
        forest.dirty_trees.add(scope_key)   # summaries regenerate lazily
    else:
        forest.dirty_trees.discard(scope_key)
    return {"nodes_before": old._n, "nodes_after": t._n,
            "slots_reclaimed": reclaimed, "leaves": len(live)}


def compaction_candidates(forest: Forest, *,
                          min_dead_fraction: float = 0.3) -> List[str]:
    """Scope keys whose trees have tombstone churn worth compacting."""
    return [k for k, t in forest.trees.items()
            if t._deleted_any and tree_dead_fraction(t) >= min_dead_fraction]
