"""Forest: the shared memory substrate (paper §3.1) + batched lazy refresh
(Algorithm 1).

Persistent state (source of truth): canonical facts, dialogue cells, scope
assignments, MemTree structure, placement maps, session registry.
Derived artifacts: interval summaries, node embeddings, root-index rows,
fact-index rows — regenerated selectively from dirty paths.

`flush()` is Algorithm 1 lines 9-22: dirty nodes are collected by level
across ALL dirty trees, and each level is refreshed in ONE batched
`tree_refresh` kernel launch — the paper's same-level/cross-tree parallelism
mapped onto the kernel's parent dimension. The dependent depth is the max
dirty level (= deepest affected tree path), not the number of touched paths.

The port runs on one device, given as ``device``: the device-resident index
caches are torch tensors there, and the kernels run there. Tree structure and
node embeddings stay host numpy, as in the JAX package, and the host
``tree.emb`` stays the source of truth; the node arena (``node_arena``) keeps
a copy of every node embedding on the device, from which the browse's
``browse_scores_rows`` gathers a level's children by row id.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Set, Tuple

import numpy as np
import torch

from repro_torch.config import MemForestConfig
from repro_torch.core.memtree import TreeArena
from repro_torch.core.types import CanonicalFact, DialogueCell
from repro_torch.kernels import ops
from repro_torch.obs import Observability, get_obs


class Forest:
    def __init__(self, config: MemForestConfig, device,
                 obs: Optional[Observability] = None):
        if not config.level_parallel:
            raise NotImplementedError(
                "level_parallel=False (one tree_refresh launch per node, the "
                "paper's Fig. 6c ablation) is not ported (ROADMAP.md, queue "
                "1, item 8); the port always refreshes one batched launch "
                "per tree level")
        self.config = config
        self.device = torch.device(device)
        self.obs = get_obs(obs)
        self.trees: Dict[str, TreeArena] = {}
        self._tree_order: List[str] = []          # tree_id -> scope_key
        self.facts: List[CanonicalFact] = []
        self.fact_emb = np.zeros((0, config.embed_dim), np.float32)
        self.fact_alive: List[bool] = []
        self.cells: List[DialogueCell] = []
        # placement: ("fact"|"cell", item_id) -> [(scope_key, node_id)]
        self.placement: Dict[Tuple[str, int], List[Tuple[str, int]]] = {}
        self.session_registry: Dict[str, Dict[str, List[int]]] = {}
        # exactly-once bookkeeping: idempotency keys of applied lifecycle
        # ops (journaled ingest/delete/merge/compaction). Persisted in
        # snapshots, so a snapshot + journal-tail replay never double-applies
        # an op.
        self.applied_ops: Set[str] = set()
        # scene clustering state
        self.scene_centroids = np.zeros((0, config.embed_dim), np.float32)
        self.scene_counts: List[int] = []
        self.dirty_trees: Set[str] = set()
        # derived: root index
        self._root_matrix = np.zeros((0, config.embed_dim), np.float32)
        # device-resident L2-normalized index caches (read path): the fact
        # and root matrices live on device between queries, invalidated
        # incrementally — appends sync [synced, n), in-place edits land in a
        # dirty-row set, capacity growth appends zero rows on the device
        # (geometric, no re-upload). topk_sim then runs with normalize=False:
        # no per-query host->device transfer and no O(N*D) re-normalization.
        self._fact_dev = None
        self._fact_dev_rows = 0
        self._fact_dev_dirty: Set[int] = set()
        self._root_dev = None
        self._root_dev_rows = 0
        self._root_dev_dirty: Set[int] = set()
        # device node arena (read path): one row per node of every tree, NOT
        # normalized (the browse scores the raw tree.emb rows, as the JAX
        # package does). Per tree, a map node id -> arena row and the count
        # of nodes synced; node ids below that count whose embedding the
        # host rewrote are dirty. Synced lazily by node_arena(): new rows in
        # a block copy per tree, rewritten rows in one scatter, capacity
        # grown geometrically on the device.
        self._arena = None
        self._arena_used = 0
        self._arena_rows: Dict[int, np.ndarray] = {}
        self._arena_synced: Dict[int, int] = {}
        self._arena_dirty: Dict[int, Set[int]] = {}
        # counters
        self.summary_refreshes = 0
        self.flush_levels = 0
        self.flush_calls = 0
        self.index_uploads = 0          # full device (re-)uploads
        self.index_row_updates = 0      # incremental scatter updates
        self.index_grows = 0            # device-side capacity grows
        self.index_releases = 0         # device-cache frees (demotion)
        self.arena_syncs = 0            # node-arena syncs that moved rows

    # ------------------------------------------------------------------
    # persistent-state writes
    # ------------------------------------------------------------------
    def get_tree(self, scope_key: str, kind: str) -> TreeArena:
        t = self.trees.get(scope_key)
        if t is None:
            t = TreeArena(len(self._tree_order), scope_key, kind,
                          self.config.branching_factor, self.config.embed_dim)
            self.trees[scope_key] = t
            self._tree_order.append(scope_key)
            if len(self._tree_order) > self._root_matrix.shape[0]:
                grow = max(8, self._root_matrix.shape[0])
                self._root_matrix = np.concatenate(
                    [self._root_matrix, np.zeros((grow, self.config.embed_dim), np.float32)]
                )
                # capacity growth: _sync_device grows the device buffer in
                # place (no full re-upload)
        return t

    def add_fact(self, fact: CanonicalFact) -> int:
        fact.fact_id = len(self.facts)
        self.facts.append(fact)
        self.fact_alive.append(True)
        if fact.fact_id >= self.fact_emb.shape[0]:
            grow = max(64, self.fact_emb.shape[0])
            self.fact_emb = np.concatenate(
                [self.fact_emb, np.zeros((grow, self.config.embed_dim), np.float32)]
            )
            # capacity growth: device buffer grows in place at next sync
        self.fact_emb[fact.fact_id] = fact.emb
        sid = fact.sources[0][0] if fact.sources else ""
        self.session_registry.setdefault(sid, {"facts": [], "cells": []})["facts"].append(fact.fact_id)
        return fact.fact_id

    def kill_fact(self, fact_id: int) -> None:
        """Mark a fact dead and inert its index row (host + device)."""
        self.fact_alive[fact_id] = False
        self.fact_emb[fact_id] = 0.0
        self._fact_dev_dirty.add(fact_id)

    def add_cell(self, cell: DialogueCell) -> int:
        cell.cell_id = len(self.cells)
        self.cells.append(cell)
        self.session_registry.setdefault(cell.session_id, {"facts": [], "cells": []})["cells"].append(cell.cell_id)
        return cell.cell_id

    def insert_item(self, scope_key: str, kind: str, item_kind: str,
                    item_id: int, ts: float, emb: np.ndarray, text: str) -> int:
        tree = self.get_tree(scope_key, kind)
        leaf = tree.insert_leaf(item_id if item_kind == "fact" else -item_id - 1, ts, emb, text)
        self.placement.setdefault((item_kind, item_id), []).append((scope_key, leaf))
        self.dirty_trees.add(scope_key)
        self._arena_dirty.setdefault(tree.tree_id, set()).add(leaf)
        return leaf

    def replace_tree(self, scope_key: str, tree: TreeArena) -> None:
        """Put ``tree`` under ``scope_key`` in place of the tree there, with
        the same ``tree_id`` (compaction, a verbatim copy into an emptied
        tree). Its node ids are not the old tree's, so the node arena forgets
        what the old tree's rows hold and ``node_arena()`` writes every node
        of the new tree again: node id i takes the row that the old tree's node i
        had, and the ids past the old tree's count take fresh rows. The old
        tree's rows past the new tree's count stay reserved for the tree's
        growth, so replacing a tree again and again (compaction under churn)
        keeps the arena at the most nodes the tree has ever had."""
        self.trees[scope_key] = tree
        tid = tree.tree_id
        self._arena_synced.pop(tid, None)
        self._arena_dirty.pop(tid, None)

    # ------------------------------------------------------------------
    # lazy refresh (Algorithm 1) — level-parallel, batched across trees
    # ------------------------------------------------------------------
    def flush(self, *, only: Optional[Set[str]] = None) -> Dict[str, int]:
        """Refresh all dirty derived artifacts. Returns counters for this
        flush: {"refreshes": distinct dirty nodes, "levels": dependent depth,
        "kernel_calls": batched refresh invocations}.

        ``only`` restricts the flush to a subset of the dirty trees — the
        maintenance plane uses this to drain refresh work in bounded chunks
        between serve steps. Because dirty paths never cross trees, flushing
        the dirty set in any chunking yields the same final derived state as
        one full flush."""
        self.flush_calls += 1
        targets = set(self.dirty_trees) if only is None else \
            self.dirty_trees & set(only)
        with self.obs.span("forest.flush", trees=len(targets)) as sp:
            out = self._flush(targets)
            sp.set(refreshes=out["refreshes"], levels=out["levels"],
                   kernel_calls=out["kernel_calls"])
        return out

    def _flush(self, targets: Set[str]) -> Dict[str, int]:
        K = self.config.branching_factor
        dim = self.config.embed_dim
        per_tree = {tid: self.trees[tid].dirty_by_level() for tid in targets}
        max_level = 0
        refreshes = 0
        kernel_calls = 0
        for levels in per_tree.values():
            for lam in levels:
                max_level = max(max_level, lam)

        for lam in range(1, max_level + 1):
            batch: List[Tuple[TreeArena, int]] = []
            for tid, levels in per_tree.items():
                tree = self.trees[tid]
                for n in levels.get(lam, []):
                    batch.append((tree, n))
            if not batch:
                continue
            kernel_calls += self._refresh_batch(batch, K, dim)
            refreshes += len(batch)

        # leaves count as refreshed artifacts only for bookkeeping
        for tid, levels in per_tree.items():
            tree = self.trees[tid]
            refreshes += len(levels.get(0, []))
            tree.dirty.clear()

        # root-index rows for dirty trees (derived artifact)
        for tid in targets:
            tree = self.trees[tid]
            self._root_matrix[tree.tree_id] = tree.root_emb()
            self._root_dev_dirty.add(tree.tree_id)
        self.dirty_trees -= targets

        self.summary_refreshes += refreshes
        self.flush_levels += max_level
        return {"refreshes": refreshes, "levels": max_level, "kernel_calls": kernel_calls}

    def _refresh_batch(self, batch: List[Tuple[TreeArena, int]], K: int, dim: int) -> int:
        P = len(batch)
        # pad the parent dim to a power-of-two bucket, as the JAX package
        # does for its jit-compile set: the kernel sees the same shapes
        cap = 1
        while cap < P:
            cap *= 2
        with self.obs.span("forest.tree_refresh", parents=P, padded=cap):
            child_emb = np.zeros((cap, K, dim), np.float32)
            mask = np.zeros((cap, K), np.float32)
            for i, (tree, n) in enumerate(batch):
                kids = tree.children[n][:K]
                for j, c in enumerate(kids):
                    child_emb[i, j] = tree.emb[c]
                    mask[i, j] = 1.0
            out = ops.tree_refresh(
                torch.from_numpy(child_emb).to(self.device),
                torch.from_numpy(mask).to(self.device))
            # node embeddings live on the host: one copy back (and one wait
            # for the device) per tree level
            out = out.cpu().numpy()
            for i, (tree, n) in enumerate(batch):
                tree.emb[n] = out[i]
                tree.refresh_text(n)
                self._arena_dirty.setdefault(tree.tree_id, set()).add(n)
        return 1

    def set_root_row(self, tree: TreeArena) -> None:
        """Write a tree's root-index row (host + device invalidation) — the
        one sanctioned way to edit ``_root_matrix`` outside flush()."""
        self._root_matrix[tree.tree_id] = tree.root_emb()
        self._root_dev_dirty.add(tree.tree_id)

    # ------------------------------------------------------------------
    # residency: device-cache detach + footprint
    # ------------------------------------------------------------------
    def device_bytes(self) -> int:
        """Bytes held by the device-resident caches (the capacity-padded
        fact and root indexes and the node arena). 0 when detached / never
        materialized."""
        return sum(t.numel() * t.element_size()
                   for t in (self._fact_dev, self._root_dev, self._arena)
                   if t is not None)

    def estimated_device_bytes(self) -> int:
        """What the device caches would hold once materialized from host
        state: the capacity-padded fact and root indexes and a freshly
        synced node arena (one row per node of every tree, at least 256), in
        float32. After ``detach_device`` and one query it equals
        ``device_bytes``; before that, the arena may also hold rows of trees
        that ``replace_tree`` keeps for a shrunk tree's growth."""
        arena_rows = max(sum(t._n for t in self.trees.values()), 256)
        return 4 * self.config.embed_dim * (
            int(self.fact_emb.shape[0]) + int(self._root_matrix.shape[0])
            + arena_rows)

    def detach_device(self) -> int:
        """Release the device index caches and the node arena and return the
        bytes released (``index_releases`` counts released tensors,
        mirroring ``index_grows``).

        Reattachment is transparent — the next ``fact_index_device()`` /
        ``root_index_device()`` / ``node_arena()`` call re-uploads from host
        state. Persistent and host derived state are unaffected; results are
        identical across a detach/reattach round-trip."""
        freed = self.device_bytes()
        for arr in (self._fact_dev, self._root_dev, self._arena):
            if arr is not None:
                ops.release_rows(arr)
                self.index_releases += 1
        self._fact_dev = None
        self._fact_dev_rows = 0
        self._fact_dev_dirty.clear()
        self._root_dev = None
        self._root_dev_rows = 0
        self._root_dev_dirty.clear()
        self._arena = None
        self._arena_used = 0
        self._arena_rows.clear()
        self._arena_synced.clear()
        self._arena_dirty.clear()
        return freed

    # ------------------------------------------------------------------
    # device-resident normalized index views (retrieval hot path)
    # ------------------------------------------------------------------
    def _sync_device(self, host: np.ndarray, n: int, cached, synced_rows: int,
                     dirty: Set[int]):
        """Bring one device index cache up to date with its host matrix.
        Returns (device tensor, new synced row count).

        Capacity growth is geometric and device-side: when the host matrix
        outgrows the cached tensor, it gains zero rows (``ops.grow_rows``)
        and only new/dirty rows are scattered — steady ingest never
        re-uploads or re-normalizes the whole index. Full uploads happen only
        on first use or a dim change.

        The scatter writes the cached tensor IN PLACE (the JAX package
        returns a new array instead): a tensor returned by an earlier call
        sees the update."""
        cap = host.shape[0]
        if cached is not None and (cached.shape[1] != host.shape[1]
                                   or cached.shape[0] > cap):
            cached = None
        if cached is None:
            self.index_uploads += 1
            dirty.clear()
            return ops.normalize_rows(torch.from_numpy(host).to(self.device)), n
        if cached.shape[0] < cap:
            self.index_grows += 1
            cached = ops.grow_rows(cached, cap - cached.shape[0])
        rows = sorted(set(r for r in dirty if r < n)
                      | set(range(synced_rows, n)))
        dirty.clear()
        if not rows:
            return cached, n
        # the update is bucketed to a power of two as in the JAX package;
        # padding entries carry the out-of-bounds drop sentinel host.shape[0]
        ucap = 1
        while ucap < len(rows):
            ucap *= 2
        idx = np.full(ucap, host.shape[0], np.int64)
        idx[: len(rows)] = rows
        upd = np.zeros((ucap, host.shape[1]), np.float32)
        upd[: len(rows)] = host[rows]
        self.index_row_updates += 1
        return ops.scatter_normalize_rows(
            cached, torch.from_numpy(idx).to(self.device),
            torch.from_numpy(upd).to(self.device)), n

    def fact_index_device(self):
        """(device-resident L2-normalized fact matrix, valid count). Use with
        ``topk_sim(..., normalize=False)``; rows are normalized with the same
        formula the kernel wrapper applies."""
        n = len(self.facts)
        self._fact_dev, self._fact_dev_rows = self._sync_device(
            self.fact_emb, n, self._fact_dev, self._fact_dev_rows,
            self._fact_dev_dirty)
        return self._fact_dev, n

    def root_index_device(self):
        """(device-resident normalized root matrix, valid count, tree order).
        Same contract as fact_index_device for the tree-root index."""
        n = len(self._tree_order)
        self._root_dev, self._root_dev_rows = self._sync_device(
            self._root_matrix, n, self._root_dev, self._root_dev_rows,
            self._root_dev_dirty)
        return self._root_dev, n, list(self._tree_order)

    def node_arena(self) -> Tuple[torch.Tensor, Dict[int, np.ndarray]]:
        """(device node arena (rows_cap, D) float32, {tree_id: arena row of
        each node id}) with every node of every tree at its host value.

        Nodes past a tree's synced count take the rows that a replaced tree
        left to its id (``replace_tree``), then fresh rows, contiguous per tree,
        copied block by block straight from ``tree.emb`` (concatenating
        them on the host first costs more than the copies save); rows the
        host rewrote since the last sync
        (``insert_item``, ``_refresh_batch``) go in one scatter. An ingest
        round so costs at most one upload of the rows it changed; capacity
        grows geometrically on the device (``ops.grow_rows``). The rows are
        the raw ``tree.emb`` rows, not normalized. The arena is written IN
        PLACE."""
        blocks: List[Tuple[int, np.ndarray]] = []   # (first row, new rows)
        idx: List[np.ndarray] = []
        upd: List[np.ndarray] = []
        for tree in self.trees.values():
            tid = tree.tree_id
            n = tree._n
            synced = self._arena_synced.get(tid, 0)
            dirty = self._arena_dirty.pop(tid, ())
            if n == synced and not dirty:
                continue
            rmap = self._arena_rows.get(tid)
            if rmap is None or rmap.shape[0] < n:
                grown = np.full(max(n, 2 * (0 if rmap is None else
                                            rmap.shape[0]), 8), -1, np.int32)
                if rmap is not None:
                    grown[: rmap.shape[0]] = rmap
                rmap = self._arena_rows[tid] = grown
            old = sorted(d for d in dirty if d < synced)
            if old:
                idx.append(rmap[old])
                upd.append(tree.emb[old])
            # rows a replaced tree left to this tree id come first, in one
            # scatter; they are a prefix of the ids past ``synced``
            kept = synced + int((rmap[synced:n] >= 0).sum())
            if kept > synced:
                idx.append(rmap[synced:kept])
                upd.append(tree.emb[synced:kept])
            if n > kept:
                blocks.append((self._arena_used, tree.emb[kept:n]))
                rmap[kept:n] = np.arange(self._arena_used,
                                         self._arena_used + n - kept)
                self._arena_used += n - kept
            self._arena_synced[tid] = n
        if self._arena is None or self._arena.shape[0] < self._arena_used:
            cap = 0 if self._arena is None else self._arena.shape[0]
            new_cap = max(self._arena_used, 2 * cap, 256)
            if self._arena is None:
                self._arena = torch.zeros((new_cap, self.config.embed_dim),
                                          dtype=torch.float32,
                                          device=self.device)
            else:
                self.index_grows += 1
                self._arena = ops.grow_rows(self._arena, new_cap - cap)
        if blocks or idx:
            count = sum(b.shape[0] for _, b in blocks) + sum(map(len, idx))
            with self.obs.span("forest.node_arena", rows=count):
                self.arena_syncs += 1
                for first, block in blocks:
                    self._arena[first:first + block.shape[0]].copy_(
                        torch.from_numpy(block))
                if idx:
                    ops.scatter_rows(
                        self._arena,
                        torch.from_numpy(np.concatenate(idx)).to(self.device),
                        torch.from_numpy(np.concatenate(upd)).to(self.device))
        return self._arena, self._arena_rows

    # ------------------------------------------------------------------
    # scene routing state
    # ------------------------------------------------------------------
    def route_scene(self, emb: np.ndarray) -> int:
        """Nearest-centroid online clustering; returns scene id."""
        thr = self.config.scene_sim_threshold
        if self.scene_centroids.shape[0]:
            sims = self.scene_centroids @ emb
            best = int(np.argmax(sims))
            if sims[best] >= thr:
                c = self.scene_counts[best]
                self.scene_centroids[best] = (self.scene_centroids[best] * c + emb) / (c + 1)
                norm = np.linalg.norm(self.scene_centroids[best]) + 1e-6
                self.scene_centroids[best] /= norm
                self.scene_counts[best] += 1
                return best
        self.scene_centroids = np.concatenate([self.scene_centroids, emb[None]], axis=0)
        self.scene_counts.append(1)
        return self.scene_centroids.shape[0] - 1

    # ------------------------------------------------------------------
    # stats
    # ------------------------------------------------------------------
    def scale_stats(self) -> Dict[str, int]:
        return {
            "facts": sum(self.fact_alive),
            "trees": sum(1 for t in self.trees.values() if t.root >= 0),
            "nodes": sum(t.num_nodes for t in self.trees.values()),
            "cells": len(self.cells),
        }
