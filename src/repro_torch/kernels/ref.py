"""Plain PyTorch versions of the port's kernels and the index ops.

Each function computes what its CUDA kernel computes, with ordinary tensor
operations, on any device. The kernel wrappers run these for CPU tensors (the
tests compare them with the JAX package's oracles), and ``chip_smoke.py``
holds every CUDA kernel against them on the card.

The top-k order is part of the contract: (score desc, key index asc). It is
realised here with a stable sort of the negated scores, never ``torch.topk``,
whose tie order is unspecified.
"""
from __future__ import annotations

import torch

NEG_INF = -1e30


def normalize_rows(x: torch.Tensor) -> torch.Tensor:
    """``x / (||x|| + 1e-6)`` per row, in float32: the formula ``topk_sim``
    applies when asked to normalize, so a pre-normalized index searched with
    ``normalize=False`` scores the same."""
    xf = x.to(torch.float32)
    return xf / (torch.linalg.vector_norm(xf, dim=-1, keepdim=True) + 1e-6)


def tree_refresh_ref(child_emb: torch.Tensor,
                     child_mask: torch.Tensor) -> torch.Tensor:
    """(P, K, D) children + (P, K) mask -> (P, D): masked mean over K, then
    ``mean / (||mean|| + 1e-6)``. A parent with no real child gets zeros."""
    m = child_mask.to(torch.float32)[..., None]
    s = torch.sum(child_emb.to(torch.float32) * m, dim=1)
    cnt = torch.clamp(torch.sum(m, dim=1), min=1.0)
    mean = s / cnt
    norm = torch.linalg.vector_norm(mean, dim=-1, keepdim=True) + 1e-6
    return (mean / norm).to(child_emb.dtype)


def browse_scores_ref(child_emb: torch.Tensor, q_emb: torch.Tensor,
                      child_mask: torch.Tensor) -> torch.Tensor:
    """(F, K, D) children, (F, D) queries, (F, K) mask -> (F, K) scores
    ``child[f, k] . q[f]``, times the mask."""
    s = torch.einsum("fkd,fd->fk", child_emb.to(torch.float32),
                     q_emb.to(torch.float32))
    return s * child_mask.to(torch.float32)


def merge_topk(vals: torch.Tensor, idx: torch.Tensor, k: int):
    """Top-k of a (Q, C) candidate pool by (score desc, index asc). Dead
    candidates carry ``NEG_INF`` / -1 and sort last; dead slots that survive
    get index -1."""
    # two-key order: sort by index first, then stably by descending score
    by_idx = torch.sort(idx, dim=-1, stable=True)
    v = torch.gather(vals, -1, by_idx.indices)
    order = torch.sort(-v, dim=-1, stable=True).indices[..., :k]
    out_v = torch.gather(v, -1, order)
    out_i = torch.gather(by_idx.values, -1, order)
    return out_v, torch.where(out_v > NEG_INF / 2, out_i,
                              torch.full_like(out_i, -1))


def topk_sim_ref(queries: torch.Tensor, keys: torch.Tensor, k: int, *,
                 normalize: bool = True, num_valid=None):
    """Cosine top-k: (Q, D) x (N, D) -> (Q, k) float32 values and int32 key
    indices, ordered by (score desc, index asc). Keys at or past
    ``num_valid`` score ``NEG_INF``; a slot whose value is ``NEG_INF`` gets
    index -1."""
    qf = queries.to(torch.float32)
    kf = keys.to(torch.float32)
    if normalize:
        qf = normalize_rows(qf)
        kf = normalize_rows(kf)
    scores = qf @ kf.T
    if num_valid is not None:
        cols = torch.arange(scores.shape[1], device=scores.device)[None, :]
        scores = torch.where(cols < int(num_valid), scores,
                             torch.full_like(scores, NEG_INF))
    # a stable sort keeps ascending column order among equal scores
    order = torch.sort(-scores, dim=-1, stable=True).indices[:, :k]
    vals = torch.gather(scores, 1, order)
    idx = torch.where(vals > -1e29, order, torch.full_like(order, -1))
    return vals, idx.to(torch.int32)


def scatter_normalize_rows(arr: torch.Tensor, idx: torch.Tensor,
                           rows: torch.Tensor) -> torch.Tensor:
    """Write normalized ``rows`` into ``arr`` at ``idx``, IN PLACE, and return
    ``arr``. Indices outside ``[0, arr.shape[0])`` are dropped, as the JAX
    package's ``mode="drop"`` scatter drops them: padding entries carry
    ``arr.shape[0]``. ``index_copy_`` would not drop them, so they are
    filtered first."""
    keep = (idx >= 0) & (idx < arr.shape[0])
    arr.index_copy_(0, idx[keep].long(), normalize_rows(rows[keep]))
    return arr


def grow_rows(arr: torch.Tensor, add: int) -> torch.Tensor:
    """``arr`` with ``add`` zero rows appended, on its own device."""
    return torch.cat([arr, arr.new_zeros((add, arr.shape[1]))])


def _inv_sqrt(D: int, device) -> torch.Tensor:
    """``1 / sqrt(D)`` in float32, as the JAX reference computes it."""
    return 1.0 / torch.sqrt(torch.tensor(float(D), dtype=torch.float32,
                                         device=device))


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True) -> torch.Tensor:
    """GQA attention over one sequence: q (B, S, Hq, D), k/v (B, S, Hkv, D)
    -> (B, S, Hq, D) in q's type. Computed in float32; masked scores are
    -1e30. Query head h reads KV head ``h // (Hq // Hkv)``."""
    B, S, Hq, D = q.shape
    group = Hq // k.shape[2]
    if group > 1:
        k = torch.repeat_interleave(k, group, dim=2)
        v = torch.repeat_interleave(v, group, dim=2)
    logits = torch.einsum("bqhd,bkhd->bhqk", q.to(torch.float32),
                          k.to(torch.float32)) * _inv_sqrt(D, q.device)
    if causal:
        mask = torch.tril(torch.ones((S, S), dtype=torch.bool,
                                     device=q.device))
        logits = torch.where(mask[None, None], logits,
                             torch.full_like(logits, NEG_INF))
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", probs, v.to(torch.float32))
    return out.to(q.dtype)


def decode_attention_ref(q: torch.Tensor, k_cache: torch.Tensor,
                         v_cache: torch.Tensor,
                         lengths: torch.Tensor) -> torch.Tensor:
    """One new token per sequence against its KV cache: q (B, Hq, D), caches
    (B, Smax, Hkv, D), lengths (B,) int32 -> (B, Hq, D) in q's type. Cache
    positions at or past ``lengths[b]`` are masked. A sequence of length 0
    gets zeros, as the Pallas kernel gives (it skips every block); the JAX
    package's jnp oracle would give the mean of v over all Smax rows."""
    B, Smax, Hkv, D = k_cache.shape
    group = q.shape[1] // Hkv
    qf = q.to(torch.float32).reshape(B, Hkv, group, D)
    logits = torch.einsum("bhgd,bshd->bhgs", qf, k_cache.to(torch.float32))
    logits = logits * _inv_sqrt(D, q.device)
    pos = torch.arange(Smax, device=q.device)[None, None, None, :]
    valid = pos < lengths.to(q.device)[:, None, None, None]
    logits = torch.where(valid, logits, torch.full_like(logits, NEG_INF))
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhgs,bshd->bhgd", probs, v_cache.to(torch.float32))
    out = torch.where((lengths.to(q.device) > 0)[:, None, None, None], out,
                      torch.zeros_like(out))
    return out.reshape(B, q.shape[1], D).to(q.dtype)
