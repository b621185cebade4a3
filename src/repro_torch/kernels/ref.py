"""Plain PyTorch versions of the port's kernels and the index ops.

Each function computes what its CUDA kernel computes, with ordinary tensor
operations, on any device. The kernel wrappers run these for CPU tensors (the
tests compare them with the JAX package's oracles), and ``chip_smoke.py``
holds every CUDA kernel against them on the card. For the two recurrent
scans the wrappers run the chunked forms (``rwkv6_chunked``,
``mamba2_ssd_chunked``), whose operation order the kernels follow; the exact
sequential recurrences beside them are oracles for the tests.

The top-k order is part of the contract: (score desc, key index asc). It is
realised here with a stable sort of the negated scores, never ``torch.topk``,
whose tie order is unspecified.
"""
from __future__ import annotations

import torch

NEG_INF = -1e30
LOG2E = 1.4426950408889634   # the attention kernels' exp2 domain


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


def browse_scores_rows_ref(arena: torch.Tensor, rows: torch.Tensor,
                           q_rows: torch.Tensor, lane_of: torch.Tensor,
                           child_mask: torch.Tensor) -> torch.Tensor:
    """The gather form: (R, D) node arena, (F, K) row ids, (L, D) lane
    queries, (F,) lane ids, (F, K) mask -> (F, K) scores
    ``arena[rows[f, k]] . q_rows[lane_of[f]]``, times the mask. A slot whose
    row id is negative scores exactly 0. Gathers, then ``browse_scores_ref``:
    the gathered rows equal the packed ones, and so do the scores."""
    r = rows.long()
    s = browse_scores_ref(arena[r.clamp(min=0)], q_rows[lane_of.long()],
                          child_mask)
    return torch.where(r >= 0, s, torch.zeros_like(s))


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


SCORE_BLOCK = 256     # keys per product of ``topk_sim_ref``'s scores


def block_scores(qf: torch.Tensor, kf: torch.Tensor) -> torch.Tensor:
    """``qf @ kf.T``, one product per ``SCORE_BLOCK`` keys with the last
    block zero-padded: every product has one shape, so a key's score is the
    same bits whichever keys stand beside it. A shard's rows then score as
    they do in the whole index (``shard_ops.sharded_topk_sim``); one product
    over all N keys would let the matmul's blocking follow N."""
    N = kf.shape[0]
    if N == 0:
        return qf.new_zeros((qf.shape[0], 0))
    pad = -N % SCORE_BLOCK
    if pad:
        kf = torch.cat([kf, kf.new_zeros((pad, kf.shape[1]))])
    return torch.cat([qf @ kf[i:i + SCORE_BLOCK].T
                      for i in range(0, N + pad, SCORE_BLOCK)], dim=1)[:, :N]


def topk_sim_ref(queries: torch.Tensor, keys: torch.Tensor, k: int, *,
                 normalize: bool = True, num_valid=None):
    """Cosine top-k: (Q, D) x (N, D) -> (Q, k) float32 values and int32 key
    indices, ordered by (score desc, index asc). Keys at or past
    ``num_valid`` score ``NEG_INF``; a slot whose value is ``NEG_INF`` gets
    index -1. The scores come from ``block_scores``."""
    qf = queries.to(torch.float32)
    kf = keys.to(torch.float32)
    if normalize:
        qf = normalize_rows(qf)
        kf = normalize_rows(kf)
    scores = block_scores(qf, kf)
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


def scatter_rows(arr: torch.Tensor, idx: torch.Tensor,
                 rows: torch.Tensor) -> torch.Tensor:
    """Write ``rows`` into ``arr`` at ``idx``, IN PLACE, unnormalized, and
    return ``arr``: the node arena's update."""
    arr.index_copy_(0, idx.long(), rows.to(arr.dtype))
    return arr


def grow_rows(arr: torch.Tensor, add: int) -> torch.Tensor:
    """``arr`` with ``add`` zero rows appended, on its own device."""
    return torch.cat([arr, arr.new_zeros((add, arr.shape[1]))])


def _inv_sqrt(D: int, device) -> torch.Tensor:
    """``1 / sqrt(D)`` in float32, as the JAX reference computes it."""
    return 1.0 / torch.sqrt(torch.tensor(float(D), dtype=torch.float32,
                                         device=device))


def _masked_logits(qf: torch.Tensor, kf: torch.Tensor,
                   causal: bool) -> torch.Tensor:
    """The scores q . k / sqrt(D) of q (B, S, H, D) and k (B, Sk, H, D) of
    one float type -> (B, H, S, Sk), masked at ``NEG_INF`` for keys past the
    row when causal (then Sk == S)."""
    S, D = qf.shape[1], qf.shape[3]
    logits = torch.einsum("bqhd,bkhd->bhqk", qf, kf) * _inv_sqrt(
        D, qf.device).to(qf.dtype)
    if causal:
        mask = torch.tril(torch.ones((S, S), dtype=torch.bool,
                                     device=qf.device))
        logits = torch.where(mask[None, None], logits,
                             torch.full_like(logits, NEG_INF))
    return logits


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True) -> torch.Tensor:
    """GQA attention over one sequence: q (B, S, Hq, D), k/v (B, S, Hkv, D)
    -> (B, S, Hq, D) in q's type. Computed in float32; masked scores are
    -1e30. Query head h reads KV head ``h // (Hq // Hkv)``. Full
    (``causal=False``), k and v may have another length than q: whisper's
    cross-attention, which no kernel computes."""
    group = q.shape[2] // k.shape[2]
    if group > 1:
        k = torch.repeat_interleave(k, group, dim=2)
        v = torch.repeat_interleave(v, group, dim=2)
    logits = _masked_logits(q.to(torch.float32), k.to(torch.float32), causal)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", probs, v.to(torch.float32))
    return out.to(q.dtype)


def attention_lse_ref(q: torch.Tensor, k: torch.Tensor, *,
                      causal: bool = True) -> torch.Tensor:
    """Each row's log-sum-exp of ``attention_ref``'s masked scores, in log2
    units, the domain ``flash_attention``'s kernel writes for training: q
    (B, S, Hq, D), k (B, S, Hkv, D) -> (B, Hq, S) float32 (float64 for
    float64 inputs), log2 sum_j exp2(s_ij log2(e)) for the scores s_ij =
    q_i . k_j / sqrt(D) masked at ``NEG_INF`` (keys past the row when
    causal), that is the natural log-sum-exp times log2(e)."""
    group = q.shape[2] // k.shape[2]
    ct = torch.float64 if q.dtype == torch.float64 else torch.float32
    kf = k.to(ct)
    if group > 1:
        kf = torch.repeat_interleave(kf, group, dim=2)
    return torch.logsumexp(_masked_logits(q.to(ct), kf, causal),
                           dim=-1) * LOG2E


def attention_bwd_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      o: torch.Tensor, do: torch.Tensor, *,
                      causal: bool = True):
    """The gradient of ``attention_ref`` over one sequence, which the JAX
    package gets by differentiating its jnp attention: q, o and do (B, S,
    Hq, D), k and v (B, S, Hkv, D) -> (dq, dk, dv) in the inputs' type.
    Explicit float32 math (float64 for float64 inputs): P = softmax of the
    scores masked at ``NEG_INF``, dP = dO . v, Di = dO . o from the
    forward's output ``o``, dS = P (dP - Di); dq = scale dS k, dk = scale
    dS^T q and dv = P^T dO, dk and dv summed over each KV head's group of
    query heads. ``flash_attention_bwd`` computes the same."""
    B, S, Hq, D = q.shape
    group = Hq // k.shape[2]
    ct = torch.float64 if q.dtype == torch.float64 else torch.float32
    qf, kf, vf, of, dof = (x.to(ct) for x in (q, k, v, o, do))
    if group > 1:
        kf = torch.repeat_interleave(kf, group, dim=2)
        vf = torch.repeat_interleave(vf, group, dim=2)
    scale = _inv_sqrt(D, q.device).to(ct)
    p = torch.softmax(_masked_logits(qf, kf, causal), dim=-1)
    dp = torch.einsum("bqhd,bkhd->bhqk", dof, vf)
    delta = torch.sum(dof * of, dim=-1).permute(0, 2, 1)[..., None]
    ds = p * (dp - delta)
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, kf) * scale
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, qf) * scale
    dv = torch.einsum("bhqk,bqhd->bkhd", p, dof)
    Hkv = Hq // group
    dk = dk.reshape(B, S, Hkv, group, D).sum(dim=3)
    dv = dv.reshape(B, S, Hkv, group, D).sum(dim=3)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


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


# ---------------------------------------------------------------------------
# the two recurrent scans: RWKV6's WKV and Mamba2's SSD
# ---------------------------------------------------------------------------
SCAN_CHUNK = 64


def scan_chunk(name: str, T: int, chunk: int = SCAN_CHUNK) -> int:
    """``min(chunk, T)``, the chunk the reference takes; a ``T`` that is not
    a multiple of it is refused, as the reference asserts ``T % chunk ==
    0`` (``src/repro/kernels/ref.py``, ``mamba2_ssd.py``,
    ``rwkv6_scan.py``)."""
    if T < 1 or chunk < 1:
        raise ValueError(f"{name}: T and chunk must be positive, got T={T}, "
                         f"chunk={chunk}")
    c = min(chunk, T)
    if T % c:
        raise ValueError(f"{name}: T={T} is not a multiple of the chunk {c}: "
                         "the reference scans take T <= chunk or T % chunk "
                         "== 0")
    return c


def rwkv6_scan_ref(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   w: torch.Tensor, u: torch.Tensor, state: torch.Tensor):
    """Exact sequential WKV6 recurrence. r, k, w (B, T, H, K), v (B, T, H,
    V), u (H, K), state (B, H, K, V) -> (o (B, T, H, V) in r's type, final
    state in state's type)::

        o_t = r_t . (S_{t-1} + diag(u) k_t^T v_t)
        S_t = diag(exp(-exp(w_t))) S_{t-1} + k_t^T v_t
    """
    f32 = torch.float32
    rf, kf, vf, wf = (x.to(f32) for x in (r, k, v, w))
    uf = u.to(f32)
    s = state.to(f32)
    outs = []
    for t in range(r.shape[1]):
        kv = kf[:, t, :, :, None] * vf[:, t, :, None, :]       # (B,H,K,V)
        outs.append(torch.einsum("bhk,bhkv->bhv", rf[:, t],
                                 s + uf[None, :, :, None] * kv))
        s = torch.exp(-torch.exp(wf[:, t]))[..., None] * s + kv
    return torch.stack(outs, dim=1).to(r.dtype), s.to(state.dtype)


def rwkv6_chunked(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  w: torch.Tensor, u: torch.Tensor, state: torch.Tensor, *,
                  chunk: int = SCAN_CHUNK):
    """Chunked WKV6, the reference's operation order (``rwkv6_chunked``):
    per chunk, per-key cumulative log-decays, the carried state's term, the
    (C, C, K) log-difference gate with every exponent clamped to <= 0, the
    bonus ``u`` on the diagonal, then the state update. The plain version
    of ``csrc/rwkv6_scan.cu``. It computes in float32, or in float64 for
    float64 inputs (the reference its bf16 check holds the kernel to)."""
    B, T, H, K = r.shape
    V = v.shape[-1]
    chunk = scan_chunk("rwkv6_scan", T, chunk)
    nc = T // chunk
    f32 = torch.promote_types(r.dtype, torch.float32)   # float64 stays so
    rf, kf, vf, wf = (x.to(f32) for x in (r, k, v, w))
    uf = u.to(f32)

    def resh(x, d):             # (nc, B, H, C, d)
        return x.reshape(B, nc, chunk, H, d).permute(1, 0, 3, 2, 4)

    rc, kc, wc, vc = resh(rf, K), resh(kf, K), resh(wf, K), resh(vf, V)
    idx = torch.arange(chunk, device=r.device)
    strict = (idx[:, None] > idx[None, :])[..., None]           # (C, C, 1)
    diag = idx[:, None] == idx[None, :]
    s = state.to(f32)
    outs = []
    for c in range(nc):
        rb, kb, vb, wb = rc[c], kc[c], vc[c], wc[c]
        logdec = -torch.exp(wb)
        cum = torch.cumsum(logdec, dim=2)
        cum_excl = cum - logdec
        o_inter = torch.einsum("bhck,bhkv->bhcv", rb * torch.exp(cum_excl), s)
        diff = cum_excl[:, :, :, None, :] - cum[:, :, None, :, :]
        gate = torch.where(strict, torch.exp(torch.clamp(diff, max=0.0)),
                           torch.zeros((), dtype=f32, device=r.device))
        A = torch.einsum("bhtk,bhsk,bhtsk->bhts", rb, kb, gate)
        A_diag = torch.sum(rb * uf[None, :, None, :] * kb, dim=-1)
        A = A + torch.where(diag, A_diag[..., None],
                            torch.zeros((), dtype=f32, device=r.device))
        o_intra = torch.einsum("bhts,bhsv->bhtv", A, vb)
        total = cum[:, :, -1]                                   # (B, H, K)
        k_scaled = kb * torch.exp(torch.clamp(total[:, :, None, :] - cum,
                                              max=0.0))
        s = torch.exp(total)[..., None] * s + torch.einsum(
            "bhck,bhcv->bhkv", k_scaled, vb)
        outs.append(o_inter + o_intra)
    out = torch.stack(outs).permute(1, 0, 3, 2, 4).reshape(B, T, H, V)
    return out.to(r.dtype), s.to(state.dtype)


def mamba2_ssd_ref(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                   Bm: torch.Tensor, C: torch.Tensor, state: torch.Tensor):
    """Exact sequential SSD recurrence. x (B, T, H, P), dt (B, T, H) (after
    softplus, > 0), A (H,) (< 0), Bm and C (B, T, N) (one group), state (B,
    H, P, N) -> (y (B, T, H, P) in x's type, final state in state's
    type)::

        S_t = exp(dt_t A_h) S_{t-1} + dt_t x_t (x) B_t
        y_t = S_t C_t
    """
    f32 = torch.float32
    xf, dtf, Bf, Cf = (a.to(f32) for a in (x, dt, Bm, C))
    Af = A.to(f32)
    s = state.to(f32)
    ys = []
    for t in range(x.shape[1]):
        decay = torch.exp(dtf[:, t] * Af[None, :])                # (B, H)
        upd = (dtf[:, t, :, None] * xf[:, t])[..., None] \
            * Bf[:, t, None, None, :]
        s = decay[..., None, None] * s + upd
        ys.append(torch.einsum("bhpn,bn->bhp", s, Cf[:, t]))
    return torch.stack(ys, dim=1).to(x.dtype), s.to(state.dtype)


def mamba2_ssd_chunked(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                       Bm: torch.Tensor, C: torch.Tensor, state: torch.Tensor,
                       *, chunk: int = SCAN_CHUNK):
    """Chunked SSD, the reference's operation order
    (``mamba2_ssd_chunked``): per chunk, the cumulative log-decay dt.A, the
    decay mask with every exponent clamped to <= 0, G = (C.B^T) * mask * dt,
    y = G.x + exp(cum) (C.S^T), then the state update. The plain version of
    ``csrc/mamba2_ssd.cu``. It computes in float32, or in float64 for
    float64 inputs (the reference its bf16 check holds the kernel to)."""
    B, T, H, P = x.shape
    N = Bm.shape[-1]
    chunk = scan_chunk("mamba2_ssd", T, chunk)
    nc = T // chunk
    f32 = torch.promote_types(x.dtype, torch.float32)   # float64 stays so
    xf = x.to(f32).reshape(B, nc, chunk, H, P).permute(1, 0, 3, 2, 4)
    dtf = dt.to(f32).reshape(B, nc, chunk, H).permute(1, 0, 3, 2)
    Bf = Bm.to(f32).reshape(B, nc, chunk, N).permute(1, 0, 2, 3)
    Cf = C.to(f32).reshape(B, nc, chunk, N).permute(1, 0, 2, 3)
    Af = A.to(f32)
    idx = torch.arange(chunk, device=x.device)
    lower = idx[:, None] >= idx[None, :]
    s = state.to(f32)
    ys = []
    for c in range(nc):
        xb, dtb, Bb, Cb = xf[c], dtf[c], Bf[c], Cf[c]
        cum = torch.cumsum(dtb * Af[None, :, None], dim=2)        # (B, H, C)
        dmat = torch.where(
            lower, torch.exp(torch.clamp(cum[..., :, None] - cum[..., None, :],
                                         max=0.0)),
            torch.zeros((), dtype=f32, device=x.device))          # (B,H,C,C)
        cb = torch.einsum("btn,bsn->bts", Cb, Bb)
        G = cb[:, None] * dmat * dtb[:, :, None, :]
        y_intra = torch.einsum("bhts,bhsp->bhtp", G, xb)
        y_inter = torch.exp(cum)[..., None] * torch.einsum("btn,bhpn->bhtp",
                                                           Cb, s)
        total = cum[:, :, -1]                                     # (B, H)
        xw = xb * (dtb * torch.exp(torch.clamp(total[:, :, None] - cum,
                                               max=0.0)))[..., None]
        s = torch.exp(total)[..., None, None] * s + torch.einsum(
            "bhcp,bcn->bhpn", xw, Bb)
        ys.append(y_intra + y_inter)
    y = torch.stack(ys).permute(1, 0, 3, 2, 4).reshape(B, T, H, P)
    return y.to(x.dtype), s.to(state.dtype)


# ---------------------------------------------------------------------------
# the scans' gradients, which the JAX package gets by differentiating its
# chunked forms (``ref.mamba2_ssd_chunked``, ``ref.rwkv6_chunked``)
# ---------------------------------------------------------------------------
def _revcumsum(x: torch.Tensor, dim: int) -> torch.Tensor:
    """sum_{t' >= t} x[t'] along ``dim``."""
    return torch.flip(torch.cumsum(torch.flip(x, (dim,)), dim), (dim,))


def mamba2_ssd_bwd_ref(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                       Bm: torch.Tensor, C: torch.Tensor, state: torch.Tensor,
                       dy: torch.Tensor, ds_out=None, *,
                       chunk: int = SCAN_CHUNK):
    """The gradient of ``mamba2_ssd_chunked``: its inputs, the output's
    cotangent ``dy`` (B, T, H, P) and the final state's ``ds_out`` (B, H, P,
    N; None means zeros) -> (dx, ddt, dA, dB, dC, dstate), each in its
    input's type. Explicit float32 math (float64 for float64 inputs).

    The chunks' entering states come from a forward sweep; the chunks are
    then walked in reverse, carrying the state's cotangent dS. Per chunk,
    with G = (C.B^T) L dt_s, L[t,s] = exp(min(cum_t - cum_s, 0)) (s <= t)
    and w_s = dt_s exp(min(total - cum_s, 0)) the state update's weights:
    dG = dy.x^T, dx = G^T.dy + w (B.dS^T), d(C.B^T) = dG L dt_s into dC and
    dB, and the inter-chunk term exp(cum_t) C.S0^T into dC and dS0. Every
    term's cotangent of the cumulative log-decay ``dcum`` is gathered, and
    the reverse cumulative sum of dcum turns it into dt's, ``ddt += A
    revcumsum(dcum)``. dA is sum dt revcumsum(dcum) = sum_t dcum_t D_t, D
    the cumulative sum of dt (cum = A D), a small sum of large terms that
    cancel: it is taken term by term instead, each pair (t, s) of the
    intra-chunk term weighted by D_t - D_s and the state update's w_s by
    D_last - D_s, which leaves its float32 error several times smaller. dB
    and dC sum over the heads (which share B and C), dA over batch and
    time. ``mamba2_ssd_bwd`` computes the same."""
    B, T, H, P = x.shape
    N = Bm.shape[-1]
    chunk = scan_chunk("mamba2_ssd_bwd", T, chunk)
    nc = T // chunk
    ct = torch.promote_types(x.dtype, torch.float32)
    dev = x.device

    def heads(t, d):            # (nc, B, H, C, d)
        return t.to(ct).reshape(B, nc, chunk, H, d).permute(1, 0, 3, 2, 4)

    xf, dyf = heads(x, P), heads(dy, P)
    dtf = dt.to(ct).reshape(B, nc, chunk, H).permute(1, 0, 3, 2)
    Bf = Bm.to(ct).reshape(B, nc, chunk, N).permute(1, 0, 2, 3)
    Cf = C.to(ct).reshape(B, nc, chunk, N).permute(1, 0, 2, 3)
    Af = A.to(ct)
    idx = torch.arange(chunk, device=dev)
    lower = idx[:, None] >= idx[None, :]
    zero = torch.zeros((), dtype=ct, device=dev)

    def decays(c):
        cum = torch.cumsum(dtf[c] * Af[None, :, None], dim=2)      # (B, H, C)
        total = cum[:, :, -1]
        ex = torch.exp(torch.clamp(total[:, :, None] - cum, max=0.0))
        return cum, total, ex

    states, s = [], state.to(ct)
    for c in range(nc):                 # the chunks' entering states
        states.append(s)
        cum, total, ex = decays(c)
        xw = xf[c] * (dtf[c] * ex)[..., None]
        s = torch.exp(total)[..., None, None] * s + torch.einsum(
            "bhcp,bcn->bhpn", xw, Bf[c])
    dS = (torch.zeros_like(s) if ds_out is None else ds_out.to(ct))
    dx = torch.empty_like(xf)
    ddt = torch.empty_like(dtf)
    dBm = torch.empty_like(Bf)
    dCm = torch.empty_like(Cf)
    dA = torch.zeros_like(Af)
    for c in reversed(range(nc)):
        xb, dyb, dtb, Bb, Cb, S0 = xf[c], dyf[c], dtf[c], Bf[c], Cf[c], states[c]
        cum, total, ex = decays(c)
        D = torch.cumsum(dtb, dim=2)    # cum / A: dcum's weight in dA
        L = torch.where(lower, torch.exp(torch.clamp(
            cum[..., :, None] - cum[..., None, :], max=0.0)), zero)  # (B,H,C,C)
        cb = torch.einsum("btn,bsn->bts", Cb, Bb)[:, None]
        G = cb * L * dtb[:, :, None, :]
        dG = torch.where(lower, torch.einsum("bhtp,bhsp->bhts", dyb, xb), zero)
        dcb = dG * L * dtb[:, :, None, :]
        R = dG * cb * L                 # dG's share of dt_s, before dt_s
        Q = R * dtb[:, :, None, :]      # its share of cum_t - cum_s
        dxb = torch.einsum("bhts,bhtp->bhsp", G, dyb)
        dCh = torch.einsum("bhts,bsn->bhtn", dcb, Bb)
        dBh = torch.einsum("bhts,btn->bhsn", dcb, Cb)
        ddtb = R.sum(dim=2)
        dcum = Q.sum(dim=3) - Q.sum(dim=2)
        dAb = torch.sum(Q * (D[..., :, None] - D[..., None, :]), dim=(2, 3))
        # the carried state's term, exp(cum_t) (C_t . S0[p, :])
        e = torch.exp(cum)
        dyS = torch.einsum("bhtp,bhpn->bhtn", dyb, S0)
        dCh = dCh + e[..., None] * dyS
        dcum_i = e * torch.einsum("bhtn,btn->bht", dyS, Cb)
        dcum = dcum + dcum_i
        dS0 = torch.einsum("bhtp,btn->bhpn", dyb * e[..., None], Cb)
        dAb = dAb + torch.sum(dcum_i * D, dim=2)
        # the state update, exp(total) S0 + sum_s (x_s w_s) (x) B_s
        w = dtb * ex
        xdS = torch.einsum("bhsp,bhpn->bhsn", xb, dS)
        dxb = dxb + w[..., None] * torch.einsum("bsn,bhpn->bhsp", Bb, dS)
        dBh = dBh + w[..., None] * xdS
        dw = torch.sum(Bb[:, None] * xdS, dim=-1)
        ddtb = ddtb + ex * dw
        dcum = dcum - w * dw
        dtot = torch.exp(total) * torch.sum(dS * S0, dim=(-2, -1))
        dcum[:, :, -1] += dtot + torch.sum(w * dw, dim=-1)
        dAb = dAb + dtot * D[..., -1] + torch.sum(
            w * dw * (D[..., -1:] - D), dim=2)
        dS = torch.exp(total)[..., None, None] * dS + dS0
        rc = _revcumsum(dcum, 2)
        ddt[c] = ddtb + Af[None, :, None] * rc
        dA = dA + dAb.sum(dim=0)
        dx[c], dBm[c], dCm[c] = dxb, dBh.sum(dim=1), dCh.sum(dim=1)
    return (dx.permute(1, 0, 3, 2, 4).reshape(B, T, H, P).to(x.dtype),
            ddt.permute(1, 0, 3, 2).reshape(B, T, H).to(dt.dtype),
            dA.to(A.dtype),
            dBm.permute(1, 0, 2, 3).reshape(B, T, N).to(Bm.dtype),
            dCm.permute(1, 0, 2, 3).reshape(B, T, N).to(C.dtype),
            dS.to(state.dtype))


def rwkv6_scan_bwd_ref(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       w: torch.Tensor, u: torch.Tensor, state: torch.Tensor,
                       do: torch.Tensor, ds_out=None, *,
                       chunk: int = SCAN_CHUNK):
    """The gradient of ``rwkv6_chunked``: its inputs, the output's cotangent
    ``do`` (B, T, H, V) and the final state's ``ds_out`` (B, H, K, V; None
    means zeros) -> (dr, dk, dv, dw, du, dstate), each in its input's type.
    Explicit float32 math (float64 for float64 inputs).

    The chunks' entering states come from a forward sweep; the chunks are
    then walked in reverse, carrying the state's cotangent dS. Per chunk,
    with the gate E[t,s,k] = exp(min(ce_t - cum_s, 0)) (s < t) of the
    forward's log-difference form (every exponent <= 0): dA = do.v^T, dv =
    A^T.do + k'.dS (k' = k exp(min(total - cum, 0))), dr and dk from dA
    through the gate and the bonus diagonal, the inter-chunk term (r
    exp(ce)).S0 into dr and dS0, and the update's k'^T.v into dk. Every
    term's cotangent of the inclusive sums ``cum`` and the exclusive ``ce =
    cum - ld`` is gathered; a reverse cumulative sum turns them into the
    log-decays' cotangent, ``dld = revcumsum(dcum + dce) - dce``, and dw =
    dld (-exp(w)). du sums over batch and time. ``rwkv6_scan_bwd``
    computes the same."""
    B, T, H, K = r.shape
    V = v.shape[-1]
    chunk = scan_chunk("rwkv6_scan_bwd", T, chunk)
    nc = T // chunk
    ct = torch.promote_types(r.dtype, torch.float32)
    dev = r.device

    def resh(x, d):             # (nc, B, H, C, d)
        return x.to(ct).reshape(B, nc, chunk, H, d).permute(1, 0, 3, 2, 4)

    rc, kc, wc = resh(r, K), resh(k, K), resh(w, K)
    vc, doc = resh(v, V), resh(do, V)
    uf = u.to(ct)[None, :, None, :]
    idx = torch.arange(chunk, device=dev)
    strict = idx[:, None] > idx[None, :]
    lower = idx[:, None] >= idx[None, :]
    diag = idx[:, None] == idx[None, :]
    zero = torch.zeros((), dtype=ct, device=dev)

    def decays(c):
        ld = -torch.exp(wc[c])
        cum = torch.cumsum(ld, dim=2)
        total = cum[:, :, -1]                                     # (B, H, K)
        ex = torch.exp(torch.clamp(total[:, :, None, :] - cum, max=0.0))
        return ld, cum, cum - ld, total, ex

    states, s = [], state.to(ct)
    for c in range(nc):                 # the chunks' entering states
        states.append(s)
        _, _, _, total, ex = decays(c)
        s = torch.exp(total)[..., None] * s + torch.einsum(
            "bhck,bhcv->bhkv", kc[c] * ex, vc[c])
    dS = (torch.zeros_like(s) if ds_out is None else ds_out.to(ct))
    dr, dk, dw = (torch.empty_like(rc) for _ in range(3))
    dv = torch.empty_like(vc)
    du = torch.zeros_like(u, dtype=ct)
    for c in reversed(range(nc)):
        rb, kb, vb, dob, S0 = rc[c], kc[c], vc[c], doc[c], states[c]
        ld, cum, ce, total, ex = decays(c)
        gate = torch.where(strict[..., None], torch.exp(torch.clamp(
            ce[:, :, :, None, :] - cum[:, :, None, :, :], max=0.0)), zero)
        bonus = torch.sum(rb * uf * kb, dim=-1)                   # (B, H, C)
        Am = torch.einsum("bhtk,bhsk,bhtsk->bhts", rb, kb, gate)
        Am = Am + torch.where(diag, bonus[..., None], zero)
        dAm = torch.where(lower, torch.einsum("bhtv,bhsv->bhts", dob, vb),
                          zero)
        dAd = torch.diagonal(dAm, dim1=-2, dim2=-1)               # (B, H, C)
        dAs = torch.where(strict, dAm, zero)
        dvb = torch.einsum("bhts,bhtv->bhsv", Am, dob)
        dr_g = torch.einsum("bhts,bhsk,bhtsk->bhtk", dAs, kb, gate)
        dk_g = torch.einsum("bhts,bhtk,bhtsk->bhsk", dAs, rb, gate)
        drb = dAd[..., None] * uf * kb + dr_g
        dkb = dAd[..., None] * uf * rb + dk_g
        du = du + torch.sum(dAd[..., None] * rb * kb, dim=(0, 2))
        dce = rb * dr_g
        dcum = -kb * dk_g
        # the carried state's term, (r exp(ce)).S0
        ece = torch.exp(ce)
        doS = torch.einsum("bhtv,bhkv->bhtk", dob, S0)
        drb = drb + ece * doS
        dce = dce + rb * ece * doS
        dS0 = torch.einsum("bhtk,bhtv->bhkv", rb * ece, dob)
        # the state update, exp(total) S0 + k'^T.v
        ks = kb * ex
        dks = torch.einsum("bhsv,bhkv->bhsk", vb, dS)
        dvb = dvb + torch.einsum("bhsk,bhkv->bhsv", ks, dS)
        dkb = dkb + ex * dks
        Y = ks * dks
        dcum = dcum - Y
        dcum[:, :, -1] += (torch.exp(total) * torch.sum(dS * S0, dim=-1)
                           + torch.sum(Y, dim=2))
        dS = torch.exp(total)[..., None] * dS + dS0
        dld = _revcumsum(dcum + dce, 2) - dce
        dr[c], dk[c], dv[c], dw[c] = drb, dkb, dvb, dld * ld

    def back(x, d):
        return x.permute(1, 0, 3, 2, 4).reshape(B, T, H, d)

    return (back(dr, K).to(r.dtype), back(dk, K).to(k.dtype),
            back(dv, V).to(v.dtype), back(dw, K).to(w.dtype), du.to(u.dtype),
            dS.to(state.dtype))
