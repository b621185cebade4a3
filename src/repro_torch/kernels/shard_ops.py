"""Mesh-sharded dispatch for the serve path's kernels (multi-device serve).

Counterpart of the JAX package's ``kernels/shard_ops.py``. The batch
dimensions of the serve path — the fact index's top-k scan, the browse
frontier and the flush's cross-tree ``tree_refresh`` batch — are
embarrassingly parallel. This module places them on a 1-D ``DataMesh``
(``launch/mesh.py``): one process, each shard a tensor on its device, each
shard's kernel launched on its device through the kernel's own wrapper (a
CUDA shard launches the hand-written kernel, a CPU shard runs the plain
version). Where the JAX package all-gathers across devices, the port copies
each shard's small result to the mesh's first device.

* ``sharded_topk_sim`` — the fact index rows are sharded; every shard runs
  ``topk_sim`` over its own rows, and a two-key merge of the (score, global
  row) candidates on the first device (``ref.merge_topk``, plain PyTorch as
  the reference's jnp) gives the exact global top-k. The merge moves S*k
  candidates a query, never the (Q, N) score matrix.
* ``upload_sharded`` / ``grow_sharded`` / ``sharded_scatter_rows`` — the
  device index cache's lifecycle under sharding (``ShardedRows``), with
  per-shard row ownership (each shard applies only the updates it owns).
* ``upload_replicated`` — the root index, one copy per distinct device
  (``Replicated``).
* ``sharded_tree_refresh`` / ``sharded_browse_scores`` /
  ``sharded_browse_scores_rows`` — data parallelism over the parent or
  frontier dimension, a contiguous block of P/S or F/S rows a shard.

Row ownership is ROUND-ROBIN: global row g lives on shard ``g % S`` at
local slot ``g // S``; the physical matrix (``ShardedRows.physical``) is the
shard-major permutation of the logical one. Capacity growth appends slots
to every shard's own block, so growth never moves a row across devices.

Exactness: the sharded results equal the single-device ones bit for bit,
ids and values. The per-row work of each kernel touches only that row, and
the launch plans keep the summation order: ``tree_refresh``'s and
``browse_scores``' plans depend on D alone, and a shard's ``topk_sim``
launches with the cluster the whole index's launch would take (the cluster
alone fixes how a score is summed). Normalization runs at the unsharded
path's shapes before rows are dealt to shards, and the plain top-k scores
keys in products of one shape (``ref.block_scores``). The two-key
(score desc, row id asc) order shared by every top-k then makes
``mesh=None`` and any mesh size give identical results.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.kernels import _build
from repro_torch.kernels import topk_sim as _topk_mod
from repro_torch.kernels.browse_scores import browse_scores, browse_scores_rows
from repro_torch.kernels.ref import (NEG_INF, grow_rows, merge_topk,
                                     normalize_rows)
from repro_torch.kernels.tree_refresh import tree_refresh
from repro_torch.launch.mesh import DataMesh


def mesh_shards(mesh: Optional[DataMesh], axis: str = "data") -> int:
    """Data-axis width of ``mesh`` (1 when mesh is None / axis absent)."""
    if mesh is None:
        return 1
    return int(mesh.shape.get(axis, 1))


def pad_rows(n: int, mult: int) -> int:
    """Round ``n`` up to a multiple of ``mult`` (shard-divisible padding)."""
    return -(-n // mult) * mult


class ShardedRows:
    """A (cap, D) matrix in the round-robin layout over a mesh of S shards:
    ``shards[s]``, on the mesh's device s, holds global rows s, s + S,
    s + 2S, ... (local slot l is global row l*S + s), cap/S rows each."""

    __slots__ = ("shards",)

    def __init__(self, shards: Sequence[torch.Tensor]):
        self.shards = tuple(shards)

    @property
    def shape(self):
        rows = sum(t.shape[0] for t in self.shards)
        return torch.Size((rows,) + tuple(self.shards[0].shape[1:]))

    def physical(self) -> torch.Tensor:
        """The shard-major (cap, D) matrix on the CPU: shard 0's rows first."""
        return torch.cat([t.cpu() for t in self.shards])


class Replicated:
    """One copy of a tensor on each distinct device of a mesh, equal in
    value; ``on(device)`` is the copy there, ``first`` the first device's."""

    __slots__ = ("copies",)

    def __init__(self, copies: Dict[torch.device, torch.Tensor]):
        self.copies = dict(copies)

    def on(self, device: torch.device) -> torch.Tensor:
        return self.copies[device]

    @property
    def first(self) -> torch.Tensor:
        return next(iter(self.copies.values()))

    @property
    def shape(self):
        return self.first.shape

    def map(self, fn) -> "Replicated":
        """``fn`` applied to each device's copy."""
        return Replicated({d: fn(t) for d, t in self.copies.items()})


def _tensor(x) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x)) \
        if isinstance(x, np.ndarray) else x


def replicate(x, mesh: DataMesh) -> Replicated:
    """``x`` (a tensor or a numpy array) copied once to each distinct device
    of ``mesh``; a tensor already on a device is that device's copy."""
    if isinstance(x, Replicated):
        return x
    t = _tensor(x)
    return Replicated({dev: t.to(dev) for dev in mesh.distinct()})


def _blocks(x, mesh: DataMesh, S: int) -> List[torch.Tensor]:
    """Shard s's contiguous block of ``x``'s leading dimension (n/S rows),
    on ``mesh.devices[s]``. Each distinct device gets one copy of the span
    of rows its shards cover: the whole of ``x`` on a one-device mesh."""
    t = _tensor(x)
    b = t.shape[0] // S
    out: List[Optional[torch.Tensor]] = [None] * S
    for dev in mesh.distinct():
        mine = [s for s in range(S) if mesh.devices[s] == dev]
        lo, hi = mine[0] * b, (mine[-1] + 1) * b
        span = t[lo:hi].to(dev)
        for s in mine:
            out[s] = span[s * b - lo:(s + 1) * b - lo]
    return out


def _gather(parts: Sequence[torch.Tensor], mesh: DataMesh) -> torch.Tensor:
    """The shards' results in shard order, on the mesh's first device."""
    first = mesh.devices[0]
    return torch.cat([p.to(first) for p in parts])


# ---------------------------------------------------------------------------
# sharded index-cache lifecycle (upload / grow / scatter)
# ---------------------------------------------------------------------------
def upload_sharded(host: np.ndarray, cap: int, mesh: DataMesh,
                   axis: str = "data") -> ShardedRows:
    """Full upload of a host matrix into the round-robin sharded layout.
    ``cap`` must be a multiple of the mesh's data-axis size and at least the
    host matrix's rows; rows beyond them are zeros (masked by num_valid
    downstream). Each distinct device normalizes the host matrix at its own
    shape, as the single-device upload does, and deals its shards' rows."""
    S = mesh_shards(mesh, axis)
    if cap % S or cap < host.shape[0]:
        raise ValueError(f"upload_sharded: cap {cap} must be a multiple of "
                         f"{S} and at least {host.shape[0]}")
    per = cap // S
    normed = {dev: normalize_rows(torch.from_numpy(host).to(dev))
              for dev in mesh.distinct()}
    shards = []
    for s, dev in enumerate(mesh.devices):
        own = normed[dev][s::S]
        shards.append(grow_rows(own, per - own.shape[0])
                      if own.shape[0] < per else own.contiguous())
    return ShardedRows(shards)


def upload_replicated(host: np.ndarray, mesh: DataMesh) -> Replicated:
    """Full upload of a host matrix replicated across the mesh (the root
    index: small, read by the recall on the first device)."""
    return Replicated({dev: normalize_rows(torch.from_numpy(
        np.ascontiguousarray(host, np.float32)).to(dev))
        for dev in mesh.distinct()})


def grow_sharded(arr: ShardedRows, new_cap: int, mesh: DataMesh,
                 axis: str = "data") -> ShardedRows:
    """Geometric device-cache growth under sharding: every shard appends
    zero rows to its own block on its own device — existing rows keep their
    owner and slot, nothing crosses devices."""
    S = mesh_shards(mesh, axis)
    add = (new_cap - arr.shape[0]) // S
    return ShardedRows([grow_rows(t, add) for t in arr.shards])


def sharded_scatter_rows(arr: ShardedRows, idx, rows, *, mesh: DataMesh,
                         axis: str = "data") -> ShardedRows:
    """Incremental sharded-index update, IN PLACE: normalized ``rows`` land
    at global row ids ``idx`` (-1 entries are padding and dropped). Each
    distinct device normalizes the live rows at the single-device scatter's
    shape; each shard applies only the rows it owns."""
    S = mesh_shards(mesh, axis)
    idx = np.asarray(idx.cpu() if isinstance(idx, torch.Tensor) else idx,
                     np.int64)
    live = np.flatnonzero(idx >= 0)
    if not live.size:
        return arr
    gids = idx[live]
    owner = gids % S
    picks = replicate(torch.from_numpy(live), mesh)
    normed = {dev: normalize_rows(_tensor(rows).to(dev).index_select(
        0, picks.on(dev))) for dev in mesh.distinct()}
    for s, (dev, shard) in enumerate(zip(mesh.devices, arr.shards)):
        mine = np.flatnonzero(owner == s)
        if mine.size:
            sel = torch.from_numpy(mine).to(dev)
            local = torch.from_numpy(gids[mine] // S).to(dev)
            shard.index_copy_(0, local, normed[dev].index_select(0, sel))
    return arr


# ---------------------------------------------------------------------------
# sharded fused top-k scan
# ---------------------------------------------------------------------------
def sharded_topk_sim(queries: torch.Tensor, keys: ShardedRows, k: int, *,
                     mesh: DataMesh, axis: str = "data", num_valid=None):
    """Fused top-k over a round-robin sharded key matrix: shard-local top-k
    + candidate merge on the first device. ``queries`` must be
    pre-normalized (the sharded cache stores normalized rows); returns
    (vals, idx) with GLOBAL row indices on the first device, exactly equal
    to the single-device ``topk_sim`` result.

    Shard s owns #{g < num_valid : g % S == s} = max(ceil((nv - s) / S), 0)
    valid rows (possibly none: its slots come back -1e30 / -1) and returns
    its best min(k, rows a shard) of them. On CUDA every shard launches with
    the cluster that one launch over the whole index would take; only the
    splits are planned for the shard's own rows."""
    S = mesh_shards(mesh, axis)
    shard_rows = keys.shape[0] // S
    k_local = min(k, shard_rows)
    nv = keys.shape[0] if num_valid is None else int(num_valid)
    q = replicate(queries, mesh)
    cluster = None
    if mesh.devices[0].type == "cuda":
        D = -(-queries.shape[1] // 4) * 4       # the wrapper's padded width
        cluster = _topk_mod.plan_cluster(queries.shape[0], nv, D,
                                         _build.sm_count(mesh.devices[0]))
    vals, gidx = [], []
    for s, (dev, shard) in enumerate(zip(mesh.devices, keys.shards)):
        local_nv = max(-(-(nv - s) // S), 0)
        v, i = _topk_mod.topk_sim(q.on(dev), shard, k_local, normalize=False,
                                  num_valid=local_nv, cluster=cluster)
        live = i >= 0
        gidx.append(torch.where(live, i * S + s, torch.full_like(i, -1)))
        vals.append(torch.where(live, v, torch.full_like(v, NEG_INF)))
    first = mesh.devices[0]
    pool_v = torch.cat([v.to(first) for v in vals], dim=1)   # (Q, S*k_local)
    pool_i = torch.cat([i.to(first) for i in gidx], dim=1)
    return merge_topk(pool_v, pool_i, k)


# ---------------------------------------------------------------------------
# sharded flush / browse batches (data parallelism over the batch dim)
# ---------------------------------------------------------------------------
def sharded_tree_refresh(child_emb, child_mask, *, mesh: DataMesh,
                         axis: str = "data") -> torch.Tensor:
    """One flush level's (P, K, D) cross-tree refresh batch, a contiguous
    block of P/S parents a shard; (P, D) on the first device. P must be a
    multiple of the data-axis size (the Forest pads its power-of-two bucket
    up to a shard multiple). The kernel's plan depends on D alone and each
    parent's mean and norm touch only its own children, so a parent's row
    is the same bits in any block."""
    S = mesh_shards(mesh, axis)
    emb, mask = _blocks(child_emb, mesh, S), _blocks(child_mask, mesh, S)
    return _gather([tree_refresh(e, m) for e, m in zip(emb, mask)], mesh)


def sharded_browse_scores(child_emb, q_emb, child_mask, *, mesh: DataMesh,
                          axis: str = "data") -> torch.Tensor:
    """One browse depth level's packed (F, K, D) frontier, a contiguous
    block of F/S entries a shard; (F, K) on the first device. F must be a
    multiple of the data-axis size (the Retriever pads its power-of-two
    bucket up to a shard multiple). The kernel's plan depends on D alone and
    an entry's scores touch only its own children and query."""
    S = mesh_shards(mesh, axis)
    parts = zip(_blocks(child_emb, mesh, S), _blocks(q_emb, mesh, S),
                _blocks(child_mask, mesh, S))
    return _gather([browse_scores(e, q, m) for e, q, m in parts], mesh)


def sharded_browse_scores_rows(arena, rows, q_rows, lane_of, child_mask, *,
                               mesh: DataMesh,
                               axis: str = "data") -> torch.Tensor:
    """The gather form over the node arena: shard s scores the contiguous
    block of F/S entries s*F/S .. (s+1)*F/S - 1, reading the arena and all
    of ``q_rows`` on its own device. Each argument is a tensor (copied once
    to each distinct device) or a ``Replicated`` that holds it there
    already; the node arena is one per distinct device
    (``Forest.node_arena``). (F, K) on the first device; F must be a
    multiple of the data-axis size."""
    S = mesh_shards(mesh, axis)
    arena, rows, q_rows, lane_of, child_mask = (
        replicate(x, mesh) for x in (arena, rows, q_rows, lane_of,
                                     child_mask))
    b = rows.shape[0] // S
    parts = []
    for s, dev in enumerate(mesh.devices):
        blk = slice(s * b, (s + 1) * b)
        parts.append(browse_scores_rows(
            arena.on(dev), rows.on(dev)[blk], q_rows.on(dev),
            lane_of.on(dev)[blk], child_mask.on(dev)[blk]))
    return _gather(parts, mesh)
