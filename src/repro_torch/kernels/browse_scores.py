"""Level-synchronous browse scoring: wrappers of the CUDA kernel.

Counterpart of the JAX package's ``kernels/browse_scores.py``. One depth
level of the batched tree browse: every frontier entry scores its (<= K)
children against its own query vector, times the child mask. Two forms reach
the one kernel, ``csrc/browse_scores.cu``, and its one C entry:

- ``browse_scores(child_emb, q_emb, child_mask)``: (F, K, D), (F, D), (F, K)
  -> (F, K), the JAX function's form (the children packed by the caller);
- ``browse_scores_rows(arena, rows, q_rows, lane_of, child_mask)``: the
  children gathered by the kernel from an (R, D) arena by (F, K) row ids (-1
  in padded slots, which score exactly 0), the queries from (L, D) rows by
  (F,) lane ids. The browse keeps its node embeddings in such an arena on the
  card, so a level uploads indices and a mask, not the children.

CPU tensors take the plain versions in ``ref.py``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import browse_scores_ref, browse_scores_rows_ref

COUNT = _build.LaunchCount("browse_scores")

WARP_MAX_D = 512    # a warp covers a row up to this width: a warp per entry
TEAM = 4            # above it, a block of TEAM warps per entry, a slice each
SLOTS = 8           # child slots one warp reduces together


def plan(D: int) -> int:
    """Warps per frontier entry for rows of D floats: 1 up to
    ``WARP_MAX_D``, ``TEAM`` above. A function of D alone, so every slot,
    entry and form at one D sums in the same order."""
    return 1 if D <= WARP_MAX_D else TEAM


def _launch(dev, arena, rows, q, lane_of, mask, F, K, D, R, L):
    out = torch.empty((F, K), dtype=torch.float32, device=dev)
    if F * K:
        ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
        _build.launch("browse_scores", "memforest_browse_scores", dev,
                      arena.data_ptr(), ptr(rows), q.data_ptr(), ptr(lane_of),
                      mask.data_ptr(), out.data_ptr(), F, K, D, R, L, plan(D))
        COUNT.launched()
    return out


def browse_scores(child_emb: torch.Tensor, q_emb: torch.Tensor,
                  child_mask: torch.Tensor) -> torch.Tensor:
    if (child_emb.dim() != 3 or q_emb.shape != (child_emb.shape[0],
                                                 child_emb.shape[2])
            or child_mask.shape != child_emb.shape[:2]):
        raise ValueError("browse_scores: expected child_emb (F, K, D), q_emb "
                         f"(F, D) and child_mask (F, K), got "
                         f"{tuple(child_emb.shape)}, {tuple(q_emb.shape)} and "
                         f"{tuple(child_mask.shape)}")
    if _build.is_plain("browse_scores", child_emb, q_emb, child_mask):
        COUNT.plain_calls += 1
        return browse_scores_ref(child_emb, q_emb, child_mask)
    _build.refuse_grad("browse_scores", child_emb, q_emb, child_mask)
    dev = _build.check_cuda_inputs("browse_scores", child_emb, q_emb,
                                   child_mask)
    F, K, D = child_emb.shape
    # the packed children are an arena of F*K rows, row f*K + k (null rows
    # and lane ids in the C entry)
    return _launch(dev, child_emb, None, q_emb, None, child_mask, F, K, D,
                   F * K, F)


def browse_scores_rows(arena: torch.Tensor, rows: torch.Tensor,
                       q_rows: torch.Tensor, lane_of: torch.Tensor,
                       child_mask: torch.Tensor) -> torch.Tensor:
    if (arena.dim() != 2 or rows.dim() != 2 or q_rows.dim() != 2
            or q_rows.shape[1] != arena.shape[1]
            or lane_of.shape != rows.shape[:1]
            or child_mask.shape != rows.shape):
        raise ValueError("browse_scores_rows: expected arena (R, D), rows (F, "
                         "K), q_rows (L, D), lane_of (F,) and child_mask (F, "
                         f"K), got {tuple(arena.shape)}, {tuple(rows.shape)}, "
                         f"{tuple(q_rows.shape)}, {tuple(lane_of.shape)} and "
                         f"{tuple(child_mask.shape)}")
    if rows.dtype != torch.int32 or lane_of.dtype != torch.int32:
        raise TypeError("browse_scores_rows: rows and lane_of are int32, got "
                        f"{rows.dtype} and {lane_of.dtype}")
    tensors = (arena, rows, q_rows, lane_of, child_mask)
    R, L = arena.shape[0], q_rows.shape[0]
    if _build.is_plain("browse_scores_rows", *tensors):
        # on the card a range check would cost a round trip: there the
        # kernel scores an out-of-range id NaN instead
        if rows.numel() and not (-1 <= int(rows.min())
                                 and int(rows.max()) < R):
            raise ValueError(f"browse_scores_rows: row ids must lie in [-1, "
                             f"{R}), got [{int(rows.min())}, "
                             f"{int(rows.max())}]")
        if lane_of.numel() and not (0 <= int(lane_of.min())
                                    and int(lane_of.max()) < L):
            raise ValueError(f"browse_scores_rows: lane ids must lie in [0, "
                             f"{L}), got [{int(lane_of.min())}, "
                             f"{int(lane_of.max())}]")
        COUNT.plain_calls += 1
        return browse_scores_rows_ref(*tensors)
    _build.refuse_grad("browse_scores_rows", *tensors)
    dev = _build.check_cuda_inputs("browse_scores_rows", arena, q_rows,
                                   child_mask)
    _build.check_cuda_inputs("browse_scores_rows", rows, lane_of, arena,
                             dtypes=(torch.int32, torch.float32))
    F, K = rows.shape
    return _launch(dev, arena, rows, q_rows, lane_of, child_mask, F, K,
                   arena.shape[1], R, L)
