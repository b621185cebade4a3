"""Durable persistence for the memory substrate (paper §3.1: "persistent
state is the source of truth ... derived artifacts can be regenerated").

Counterpart of the JAX package's ``core/persistence.py``, with the same
document and the same bytes: a snapshot written by either package loads in
the other, and two forests with the same persistent state digest equal in
both. The document holds no device and no package name; ``forest_from_doc``
takes the device the restored forest runs on.

Snapshot format (msgpack through ``core/codec.py`` + tagged compression —
zstd when available, stdlib zlib otherwise — single file):
  * persistent state: canonical facts, dialogue cells, scope assignments,
    tree STRUCTURE, placement maps, session registry, scene cluster state,
    applied idempotency keys (exactly-once bookkeeping for the write-ahead
    journal, core/journal.py);
  * derived artifacts (node embeddings, summaries, root rows) are stored
    too by default — restore is then instant — but ``rematerialize_derived=
    True`` drops them and regenerates everything from persistent state via
    the normal lazy flush (one ``tree_refresh`` launch per tree level).

The doc-level API (``forest_to_doc`` / ``forest_from_doc`` / ``read_doc``) is
shared by three consumers: file snapshots here, the migrate-merge payloads
the write-ahead journal must replay byte-identically, and the structural
``forest_state_digest`` the recovery tests compare crash-replayed state
against.
"""
from __future__ import annotations

import hashlib
import os
from typing import Any, Dict, Optional

import numpy as np

from repro_torch import compression
from repro_torch.config import MemForestConfig
from repro_torch.core import codec
from repro_torch.core.forest import Forest
from repro_torch.core.memtree import TreeArena
from repro_torch.core.types import CanonicalFact, DialogueCell
from repro_torch.device import resolve_device
from repro_torch.runtime.checkpoint import fsync_dir

# v2 adds "applied_ops" (journal exactly-once keys), "extra" (journal
# watermark), and — in with_derived docs — the dirty-flush bookkeeping
# ("dirty_trees" + per-tree "dirty" node sets). v3 adds the residency record
# a tenant demotion writes into "extra" (DurableMemForest.demote). "extra"
# stays out of forest_state_digest. v1/v2 docs load unchanged.
FORMAT_VERSION = 3


def _fact_rec(f: CanonicalFact) -> Dict[str, Any]:
    return {
        "id": f.fact_id, "text": f.text, "subject": f.subject,
        "attribute": f.attribute, "value": f.value, "ts": f.ts,
        "prev": f.prev_value, "sources": [list(s) for s in f.sources],
        "emb": f.emb.astype(np.float32).tobytes() if f.emb is not None else b"",
    }


def _tree_rec(t: TreeArena, with_derived: bool) -> Dict[str, Any]:
    return {
        "tree_id": t.tree_id, "scope_key": t.scope_key, "kind": t.kind,
        "k": t.k, "n": t._n, "root": t.root,
        "parent": list(t.parent), "children": [list(c) for c in t.children],
        "level": list(t.level), "start_ts": list(t.start_ts),
        "end_ts": list(t.end_ts), "payload": list(t.payload),
        "alive": list(t.alive), "deleted_any": t._deleted_any,
        "text": list(t.text) if with_derived else [""] * t._n,
        "emb": t.emb[:t._n].astype(np.float32).tobytes() if with_derived else b"",
        # dirty bookkeeping rides only with the derived state it qualifies;
        # the with_derived=False doc feeds forest_state_digest, which must
        # stay independent of flush progress
        "dirty": sorted(t.dirty) if with_derived else [],
    }


def forest_to_doc(forest: Forest, *, with_derived: bool = True,
                  extra: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
    """Serialize a forest to a plain msgpack-able document."""
    cfg = forest.config
    return {
        "version": FORMAT_VERSION,
        "config": {
            "chunk_turns": cfg.chunk_turns, "branching_factor": cfg.branching_factor,
            "embed_dim": cfg.embed_dim, "tree_families": list(cfg.tree_families),
        },
        "facts": [_fact_rec(f) for f in forest.facts],
        "fact_alive": list(forest.fact_alive),
        "cells": [
            {"id": c.cell_id, "session": c.session_id, "chunk": c.chunk_idx,
             "text": c.text, "ts": c.ts,
             "emb": c.emb.astype(np.float32).tobytes() if c.emb is not None else b""}
            for c in forest.cells
        ],
        "trees": [_tree_rec(forest.trees[k], with_derived)
                  for k in forest._tree_order],
        "tree_order": list(forest._tree_order),
        "placement": [
            [k[0], k[1], [list(v) for v in vs]]
            for k, vs in forest.placement.items()
        ],
        "session_registry": {
            k: {"facts": v["facts"], "cells": v["cells"]}
            for k, v in forest.session_registry.items()
        },
        "scene_centroids": forest.scene_centroids.astype(np.float32).tobytes(),
        "scene_counts": list(forest.scene_counts),
        "applied_ops": sorted(forest.applied_ops),
        "dirty_trees": sorted(forest.dirty_trees) if with_derived else [],
        "extra": extra or {},
        "with_derived": with_derived,
    }


def doc_to_bytes(doc: Dict[str, Any]) -> bytes:
    return compression.compress(codec.packb(doc))


def bytes_to_doc(payload: bytes) -> Dict[str, Any]:
    return codec.unpackb(compression.decompress(payload))


def save_forest(forest: Forest, path: str, *, with_derived: bool = True,
                extra: Optional[Dict[str, Any]] = None) -> str:
    """Write the forest's snapshot to ``path`` atomically. Spans on the
    forest's tracer: ``persistence.document``, ``persistence.pack`` (the
    codec), ``persistence.compress`` and ``persistence.write`` (the file,
    its fsync and the rename)."""
    obs = forest.obs
    with obs.span("persistence.document"):
        doc = forest_to_doc(forest, with_derived=with_derived, extra=extra)
    with obs.span("persistence.pack"):
        data = codec.packb(doc)
    with obs.span("persistence.compress", bytes=len(data)):
        payload = compression.compress(data)
    with obs.span("persistence.write", bytes=len(payload)):
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:
            f.write(payload)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
        fsync_dir(os.path.dirname(os.path.abspath(path)))
    return path


def read_doc(path: str) -> Dict[str, Any]:
    with open(path, "rb") as f:
        return bytes_to_doc(f.read())


def forest_from_doc(doc: Dict[str, Any], config: Optional[MemForestConfig] = None,
                    *, rematerialize_derived: bool = False,
                    device=None) -> Forest:
    """A forest on ``device`` (None: the CUDA card) from a document of
    either package. Its device caches start empty: the first index or arena
    access uploads exactly the restored host state."""
    if doc["version"] not in (1, 2, FORMAT_VERSION):
        raise ValueError(f"unsupported snapshot version {doc['version']}")
    cfg = config or MemForestConfig(
        chunk_turns=doc["config"]["chunk_turns"],
        branching_factor=doc["config"]["branching_factor"],
        embed_dim=doc["config"]["embed_dim"],
        tree_families=tuple(doc["config"]["tree_families"]),
    )
    dim = cfg.embed_dim
    forest = Forest(cfg, resolve_device(device))

    for rec in doc["facts"]:
        emb = np.frombuffer(rec["emb"], np.float32).copy() if rec["emb"] else None
        f = CanonicalFact(
            fact_id=rec["id"], text=rec["text"], subject=rec["subject"],
            attribute=rec["attribute"], value=rec["value"], ts=rec["ts"],
            prev_value=rec["prev"],
            sources=[tuple(s) for s in rec["sources"]], emb=emb,
        )
        forest.facts.append(f)
    forest.fact_alive = list(doc["fact_alive"])
    cap = max(64, 1 << max(len(forest.facts) - 1, 0).bit_length())
    forest.fact_emb = np.zeros((cap, dim), np.float32)
    for f in forest.facts:
        # dead facts keep their record (provenance) but their index row must
        # stay zeroed — restoring it would resurrect deleted facts in
        # topk_sim
        if f.emb is not None and forest.fact_alive[f.fact_id]:
            forest.fact_emb[f.fact_id] = f.emb

    for rec in doc["cells"]:
        emb = np.frombuffer(rec["emb"], np.float32).copy() if rec["emb"] else None
        forest.cells.append(DialogueCell(
            cell_id=rec["id"], session_id=rec["session"], chunk_idx=rec["chunk"],
            text=rec["text"], ts=rec["ts"], emb=emb,
        ))

    has_derived = doc["with_derived"] and not rematerialize_derived
    for rec in doc["trees"]:
        t = TreeArena(rec["tree_id"], rec["scope_key"], rec["kind"],
                      rec["k"], dim)
        n = rec["n"]
        t._n = n
        t.parent = list(rec["parent"])
        t.children = [list(c) for c in rec["children"]]
        t.level = list(rec["level"])
        t.start_ts = list(rec["start_ts"])
        t.end_ts = list(rec["end_ts"])
        t.payload = list(rec["payload"])
        t.alive = list(rec["alive"])
        t._deleted_any = rec["deleted_any"]
        t.text = list(rec["text"])
        t.emb = np.zeros((max(n, 8), dim), np.float32)
        if rec["emb"]:
            t.emb[:n] = np.frombuffer(rec["emb"], np.float32).reshape(n, dim)
        t.root = rec["root"]
        if has_derived:
            # snapshots taken under deferred flush carry their dirty paths;
            # re-marking them keeps read-triggered refresh (and the
            # maintenance plane) able to repair the stale summaries
            t.dirty = set(rec.get("dirty", []))
        forest.trees[rec["scope_key"]] = t
    forest._tree_order = list(doc["tree_order"])
    cap_t = max(8, 1 << max(len(forest._tree_order) - 1, 0).bit_length())
    forest._root_matrix = np.zeros((cap_t, dim), np.float32)

    for kind, item_id, vs in doc["placement"]:
        forest.placement[(kind, item_id)] = [(v[0], v[1]) for v in vs]
    forest.session_registry = {
        k: {"facts": list(v["facts"]), "cells": list(v["cells"])}
        for k, v in doc["session_registry"].items()
    }
    sc = np.frombuffer(doc["scene_centroids"], np.float32)
    forest.scene_centroids = sc.reshape(-1, dim).copy() if sc.size else \
        np.zeros((0, dim), np.float32)
    forest.scene_counts = list(doc["scene_counts"])
    forest.applied_ops = set(doc.get("applied_ops", []))

    if has_derived:
        forest.dirty_trees = set(doc.get("dirty_trees", []))
        for t in forest.trees.values():
            forest._root_matrix[t.tree_id] = t.root_emb()
    else:
        # regenerate ALL derived artifacts from persistent state: leaf embs
        # come from facts/cells; internal summaries from the lazy flush
        for t in forest.trees.values():
            for nid in range(t._n):
                if not t.alive[nid]:
                    continue
                if t.level[nid] == 0 and t.payload[nid] is not None:
                    p = t.payload[nid]
                    if p >= 0:
                        src = forest.facts[p]
                        t.emb[nid] = src.emb
                        t.text[nid] = src.text
                    else:
                        cell = forest.cells[-p - 1]
                        t.emb[nid] = cell.emb
                        t.text[nid] = cell.text[:200]
                    t._mark_dirty_path(nid)
            forest.dirty_trees.add(t.scope_key)
        forest.flush()
    return forest


def load_forest(path: str, config: Optional[MemForestConfig] = None,
                *, rematerialize_derived: bool = False,
                device=None) -> Forest:
    return forest_from_doc(read_doc(path), config,
                           rematerialize_derived=rematerialize_derived,
                           device=device)


def forest_state_digest(forest: Forest) -> str:
    """Content hash of the forest's PERSISTENT state (facts, cells, tree
    structure, placement, registry, scenes, applied keys) — derived
    artifacts (summaries, node embeddings, root rows, flush bookkeeping) are
    excluded, so two forests that differ only in how far their lazy flush
    has progressed digest equal. This is the state-identity relation the
    crash-recovery tests assert: snapshot + journal replay must reproduce
    the uninterrupted run's digest bit-for-bit."""
    doc = forest_to_doc(forest, with_derived=False)
    doc.pop("extra", None)
    return hashlib.sha256(codec.packb(doc)).hexdigest()
