"""Operations of one launch of each kernel, from its shapes.

The counts behind ``chip_smoke.py``'s bound column, and the dry run's
operations for a kernel call on fake tensors, which launches nothing
(``_build.launch``): a multiply and an add are two operations, as
``torch.utils.flop_counter`` counts a product. Where the work depends on
the data (a decode step's cache lengths), the count takes the most the
shapes allow.
"""
from __future__ import annotations


def attention_ops(B: int, S: int, Hq: int, D: int, causal: bool) -> int:
    """``flash_attention``: the two products S = QK^T and P.V over the
    (lower-triangle, when causal) pairs of every query head."""
    pairs = S * (S + 1) // 2 if causal else S * S
    return 4 * B * Hq * pairs * D


def attention_bwd_ops(B: int, S: int, Hq: int, D: int, causal: bool) -> int:
    """``flash_attention_bwd``: the five products S, dP, dq, dk and dv."""
    pairs = S * (S + 1) // 2 if causal else S * S
    return 5 * 2 * B * Hq * pairs * D


def decode_ops(rows: int, Hq: int, D: int) -> int:
    """``decode_attention`` over ``rows`` cache rows (the batch's lengths
    summed): the two products per query head."""
    return 4 * rows * Hq * D


def ssd_ops(B: int, T: int, H: int, P: int, N: int, C: int) -> int:
    """The chunked SSD (``mamba2_ssd``): C.B^T once per (batch, chunk) over
    the lower triangle (B and C are shared by the heads); per (batch, head,
    chunk) the masked G, G.x, C.S^T and the state update."""
    nc, tri = T // C, C * (C + 1) // 2
    per_head = (tri * (3 + 2 * P) + C * P * (2 * N + 2) + P * N * (2 * C + 2)
                + 4 * C)
    return B * nc * (tri * 2 * N + H * per_head)


def rwkv_ops(B: int, T: int, H: int, K: int, V: int, C: int) -> int:
    """The chunked WKV6 (``rwkv6_scan``) per (batch, head, chunk): the
    log-decay sums, the gated r.k over the strict lower triangle (exp
    counted as one operation), the bonus diagonal, the rescales, A.v, the
    carried state's term and the state update."""
    nc, tri = T // C, C * (C + 1) // 2
    strict = C * (C - 1) // 2
    per_head = (3 * C * K + 5 * strict * K + 3 * C * K + 4 * C * K
                + C * V * 2 * K + tri * 2 * V + K * V * (2 * C + 2))
    return B * H * nc * per_head


def ssd_bwd_ops(B: int, T: int, H: int, P: int, N: int) -> int:
    """``mamba2_ssd_bwd``'s products: C.B^T once per (batch, chunk); per
    head dG, dx's two products, dC's and dB's two each, and dS's, over the
    lower triangle where masked."""
    C = min(64, T)
    nc, tri = T // C, C * (C + 1) // 2
    return B * nc * (2 * tri * N + H * (4 * tri * P + 4 * tri * N
                                        + 8 * C * P * N))


def rwkv_bwd_ops(B: int, T: int, H: int, K: int, V: int) -> int:
    """``rwkv6_scan_bwd``'s products per (batch, head, chunk): dA and A.do^T
    over the lower triangle, the gate's three terms (A, dr, dk: three
    operations a pair and key), and the four K x V products (k'.dS,
    do.S0^T, v.dS^T, the dS update)."""
    C = min(64, T)
    nc, tri, strict = T // C, C * (C + 1) // 2, C * (C - 1) // 2
    return B * H * nc * (4 * tri * V + 9 * strict * K + 8 * C * K * V)


def rwkv_bwd_exps(B: int, T: int, H: int, K: int) -> int:
    """``rwkv6_scan_bwd``'s gate exponentials: the pairs of the diagonal 16
    x 16 blocks once, and below them per-element factors of r and k (about
    4 C K), as the sub-chunk form needs them."""
    C, sub = min(64, T), 16
    nc = T // C
    diag = -(-C // sub) * sub * (sub - 1) // 2
    return B * H * nc * (diag * K + 4 * C * K)


def topk_ops(Q: int, num_valid: int, D: int) -> int:
    """``topk_sim``: one dot product per (query, valid key)."""
    return 2 * Q * num_valid * D


def tree_refresh_ops(P: int, K: int, D: int) -> int:
    """``tree_refresh``: the masked sum, the mean and the norm."""
    return 2 * P * K * D + 3 * P * D


def browse_ops(F: int, K: int, D: int) -> int:
    """``browse_scores``: one dot product per (entry, child slot)."""
    return 2 * F * K * D
