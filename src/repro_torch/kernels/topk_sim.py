"""Fused cosine similarity + top-k: wrapper of the CUDA kernel.

Counterpart of the JAX package's ``kernels/topk_sim.py``, MemForest's
recall scan over the fact and root indexes. (Q, D) queries x (N, D) keys ->
(Q, min(k, N)) float32 scores and int32 key indices, ordered by (score desc,
key index asc); keys at or past ``num_valid`` are masked out, and a slot no
valid key fills holds -1e30 and index -1.

The kernel (``csrc/topk_sim.cu``) is one launch: blocks of 32 queries over
splits of the valid keys, a cluster of blocks over slices of D where the
blocks would not fill the card otherwise, a bitonic selection network, and
the splits' lists merged by the last block to finish, in split order, in
the same two-key order as ``merge_topk``. ``plan_splits`` is its plan.
Normalization, when asked for, happens here with the ``normalize_rows``
formula, as the JAX wrapper does it outside its kernel. CPU tensors take the
plain version in ``ref.py``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build, costs
from repro_torch.kernels.ref import normalize_rows, topk_sim_ref

COUNT = _build.LaunchCount("topk_sim")

MAX_K = 32
KEY_TILE = 64          # keys per tile
QUERY_BLOCK = 32       # queries per block
SLICE = 32             # depth of one ring stage: the narrowest slice of D
MAX_CLUSTER = 8        # blocks per cluster (the portable limit)
BLOCKS_PER_SM = 2      # blocks to aim for on each SM when splitting keys
MAX_SPLITS = 256       # lists per row the merge walks
SPLIT_K_SLICE = 128    # slices at least this deep: each warp a quarter of a stage


def plan_cluster(Q: int, num_valid: int, D: int, sm_count: int) -> int:
    """Blocks per cluster: while the query blocks times the tiles times the
    cluster leave SMs without a block, the cluster doubles (up to
    ``MAX_CLUSTER``, each slice of D at least ``SLICE`` deep)."""
    tiles = max(1, -(-num_valid // KEY_TILE))
    q_blocks = max(1, -(-Q // QUERY_BLOCK))
    cluster = 1
    while (cluster < MAX_CLUSTER and cluster * q_blocks * tiles < sm_count
           and D >= 2 * cluster * SLICE):
        cluster *= 2
    return cluster


def plan_splits(Q: int, num_valid: int, D: int, sm_count: int,
                cluster=None):
    """(keys per split, splits, cluster, slice, split_k) of one launch.

    The valid keys are cut into tiles of ``KEY_TILE``; the cluster is
    ``plan_cluster``'s unless given. The splits, whole numbers of tiles,
    then aim at ``BLOCKS_PER_SM`` blocks an SM, at most ``MAX_SPLITS`` of
    them, none empty. ``slice`` is a multiple of 4 and no rank's slice is
    empty. With slices of ``SPLIT_K_SLICE`` or more, ``split_k`` cuts each
    tile over the warps by depth. The cluster alone fixes the order in
    which a score is summed (the slices, ``split_k``): a given cluster
    scores a key in the same bits whatever the splits and tiles."""
    tiles = max(1, -(-num_valid // KEY_TILE))
    q_blocks = max(1, -(-Q // QUERY_BLOCK))
    if cluster is None:
        cluster = plan_cluster(Q, num_valid, D, sm_count)
    want = max(1, min(tiles, MAX_SPLITS,
                      (BLOCKS_PER_SM * sm_count) // (q_blocks * cluster)))
    tiles_per_split = -(-tiles // want)
    slice_ = -(-D // (4 * cluster)) * 4
    return (tiles_per_split * KEY_TILE, -(-tiles // tiles_per_split), cluster,
            slice_, slice_ >= SPLIT_K_SLICE)


def topk_sim(queries: torch.Tensor, keys: torch.Tensor, k: int, *,
             normalize: bool = True, num_valid=None, cluster=None):
    """``cluster`` (CUDA only) replaces ``plan_cluster``'s: a shard of a
    sharded index launches with the cluster of the whole index's launch, so
    its scores carry the same bits (``shard_ops.sharded_topk_sim``)."""
    if queries.dim() != 2 or keys.dim() != 2 or queries.shape[1] != keys.shape[1]:
        raise ValueError("topk_sim: expected queries (Q, D) and keys (N, D), "
                         f"got {tuple(queries.shape)} and {tuple(keys.shape)}")
    if not 1 <= k <= MAX_K:
        raise ValueError(f"topk_sim: k must lie in [1, {MAX_K}], got {k}")
    N = keys.shape[0]
    nv = N if num_valid is None else int(num_valid)
    if not 0 <= nv <= N:
        raise ValueError(f"topk_sim: num_valid must lie in [0, {N}], got {nv}")
    if _build.is_plain("topk_sim", queries, keys):
        COUNT.plain_calls += 1
        return topk_sim_ref(queries, keys, k, normalize=normalize,
                            num_valid=num_valid)
    _build.refuse_grad("topk_sim", queries, keys)
    if normalize:
        queries, keys = normalize_rows(queries), normalize_rows(keys)
    dev = _build.check_cuda_inputs("topk_sim", queries, keys)
    Q = queries.shape[0]
    k = min(k, N)                 # as the plain version: no more slots than keys
    vals = torch.empty((Q, k), dtype=torch.float32, device=dev)
    idx = torch.empty((Q, k), dtype=torch.int32, device=dev)
    if k == 0:
        return vals, idx
    # rows of whole 16-byte chunks (zero columns change no score)
    queries, keys = (_build.tma_ready(x, align=4) for x in (queries, keys))
    D = queries.shape[1]
    per_split, splits, cluster, slice_, split_k = plan_splits(
        Q, nv, D, _build.sms_of(queries), cluster)
    cand_v = cand_i = counters = None   # the merge's scratch, with splits > 1
    n_counters = 0
    if splits > 1:
        cand_v = torch.empty((Q, splits, k), dtype=torch.float32, device=dev)
        cand_i = torch.empty((Q, splits, k), dtype=torch.int32, device=dev)
        if not _build.is_fake(queries):   # one buffer a stream
            counters = _build.counters(dev, -(-Q // QUERY_BLOCK) * cluster)
            n_counters = counters.numel()
    _build.launch("topk_sim", "memforest_topk_sim", dev,
                  queries, keys, cand_v, cand_i, counters, n_counters, vals,
                  idx, Q, N, D, nv, k, per_split, splits, cluster, slice_,
                  int(split_k), count=COUNT, ops=costs.topk_ops(Q, nv, D))
    return vals, idx
