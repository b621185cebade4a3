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
node embeddings stay host numpy, as in the JAX package.
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
                "paper's Fig. 6c ablation) is not ported; the port always "
                "refreshes one batched launch per tree level")
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
        # counters
        self.summary_refreshes = 0
        self.flush_levels = 0
        self.flush_calls = 0
        self.index_uploads = 0          # full device (re-)uploads
        self.index_row_updates = 0      # incremental scatter updates
        self.index_grows = 0            # device-side capacity grows
        self.index_releases = 0         # device-cache frees (demotion)

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
        return leaf

    # ------------------------------------------------------------------
    # lazy refresh (Algorithm 1) — level-parallel, batched across trees
    # ------------------------------------------------------------------
    def flush(self) -> Dict[str, int]:
        """Refresh all dirty derived artifacts. Returns counters for this
        flush: {"refreshes": distinct dirty nodes, "levels": dependent depth,
        "kernel_calls": batched refresh invocations}."""
        self.flush_calls += 1
        targets = set(self.dirty_trees)
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
        return 1

    # ------------------------------------------------------------------
    # residency: device-cache detach + footprint
    # ------------------------------------------------------------------
    def device_bytes(self) -> int:
        """Bytes held by the device-resident index caches (the
        capacity-padded arenas). 0 when detached / never materialized."""
        return sum(t.numel() * t.element_size()
                   for t in (self._fact_dev, self._root_dev) if t is not None)

    def detach_device(self) -> int:
        """Release both device index caches and return the bytes released
        (``index_releases`` counts released arenas, mirroring
        ``index_grows``).

        Reattachment is transparent — the next ``fact_index_device()`` /
        ``root_index_device()`` call re-uploads from host state. Persistent
        and host derived state are unaffected; results are identical across
        a detach/reattach round-trip."""
        freed = self.device_bytes()
        for arr in (self._fact_dev, self._root_dev):
            if arr is not None:
                ops.release_rows(arr)
                self.index_releases += 1
        self._fact_dev = None
        self._fact_dev_rows = 0
        self._fact_dev_dirty.clear()
        self._root_dev = None
        self._root_dev_rows = 0
        self._root_dev_dirty.clear()
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
