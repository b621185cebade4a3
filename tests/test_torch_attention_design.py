"""The arithmetic and plans of the two attention kernels, on the CPU.

The CUDA kernels run only on a card (``chip_smoke.py`` holds them against
their plain versions there). What their designs change is held here, in
plain PyTorch that follows each kernel's schedule step by step:

- ``flash_attention`` (bf16): rows packed as (position, query head of the
  GQA group), 64 rows per warpgroup tile and one or two tiles per block;
  64-key tiles, none past the block's last position when causal; the online
  softmax in f32 with exp2 on scores scaled by log2(e)/sqrt(D); P rounded
  to bf16 before P.V, its row sums kept in f32. Against ``repro.kernels.ref``
  and ``repro_torch.kernels.ref.attention_ref`` at the main paths' shapes,
  cut in batch, and at S = 4096, within the tolerance ``chip_smoke.py``
  holds the kernel to: |err| <= 2e-2 + 1e-2 |plain|.
- ``decode_attention``: the chunk plan (fixed 128-row chunks at every Smax,
  made from Smax alone), which positions each chunk reads, and the merge
  inside the launch: partials written to a scratch that starts as garbage,
  tickets drawn from self-resetting counters, the last block of a group
  merging its slots in split-index order. Whatever order the blocks finish
  in gives the same bits. (The kernel's own run-to-run bits are held by
  ``chip_smoke.py``'s repeat check.) Each query head's log-sum-exp (log2
  units) from the final (m, l) of its block row (``BLOCK_HEADS`` heads a
  block in bf16), after both levels of the merge, against
  ``decode_attention_lse_ref`` at 1, 2, 17 and 300 splits.
- the log-sum-exp the forward writes for training (log2 units), against
  ``attention_lse_ref`` and ``jax.nn.logsumexp``.
- ``flash_attention_bwd``: both entries' schedules read the forward's lse
  (none recomputes it). float32 (the CUDA-core kernels: A per 64-row query
  tile and query head sweeping the key tiles once; B per 64-key tile
  looping over the group's heads) against ``attention_bwd_ref`` and
  ``jax.vjp`` of the reference within 1e-4. bf16 (the tensor-core kernels:
  packed rows of Gc heads and Mp positions, exp2 on the lse, P and dS
  rounded to bf16 before their products, f32 sums; B's (lse, Di) from A's
  scratch) against both references and against a float64 run within one
  ulp plus ``chip_smoke.BWD_TC_EXCESS`` (pinned here, with the shapes it
  was derived at), with ragged tails, S = 1, head dims 16 to 128 and
  groups of 1 to 96.
- the wrappers still refuse what they refused and never fall back.

Inputs come from numpy with fixed seeds and go to both packages.
"""
import inspect
import math

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels import ref as jax_ref
from repro_torch import kernels
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops, ref
from repro_torch.kernels.decode_attention import (BLOCK_HEADS, CHUNK, FAN_IN,
                                                 TILE, plan_splits,
                                                 scratch_sizes)
from repro_torch.kernels._build import TMA_ALIGN, tma_ready

ATOL, RTOL = 2e-2, 1e-2         # chip_smoke.py's bf16 criterion
NEG = -1e30
LOG2E = 1.4426950408889634


def _pair(rng, shape):
    """The same bf16 values as a jax array and a torch tensor."""
    j = jnp.asarray(rng.normal(size=shape).astype(np.float32), jnp.bfloat16)
    return j, torch.from_numpy(np.array(j.astype(jnp.float32))).to(torch.bfloat16)


def _within(out, plain):
    o = np.asarray(out, np.float32)
    p = np.asarray(plain, np.float32)
    excess = (np.abs(o - p) - RTOL * np.abs(p)).max()
    assert excess <= ATOL, f"differs by {excess} beyond rtol {RTOL} (atol {ATOL})"


# ---------------------------------------------------------------------------
# flash_attention: the tensor-core schedule
# ---------------------------------------------------------------------------
def flash_schedule(q, k, v, causal, with_lse=False):
    """The bf16 kernel's arithmetic: q (B, S, Hq, D), k and v (B, S, Hkv,
    D), bf16 -> (B, S, Hq, D) bf16, and with ``with_lse`` also each row's
    log-sum-exp (B, Hq, S) float32 as training asks the kernel for it: m +
    log2(l) from the online softmax, in log2 units. Block (row tile, head
    chunk, KV head, batch) as the kernel launches them, vectorised over
    batch and KV head."""
    B, S, Hq, D = q.shape
    Hkv = k.shape[2]
    G = Hq // Hkv
    Gc = min(G, 64)                   # heads per tile
    Mp = 64 // Gc                     # positions per warpgroup tile
    W = 1 if S <= Mp else 2           # warpgroups per block
    scale_log2 = np.float32(LOG2E / math.sqrt(D))
    qf = q.float().reshape(B, S, Hkv, G, D)
    kf, vf = k.float(), v.float()
    out = torch.zeros(B, S, Hkv, G, D)
    lse = torch.zeros(B, S, Hkv, G)
    for g0 in range(0, G, Gc):
        for p0 in range(0, S, W * Mp):
            pos = torch.arange(p0, p0 + W * Mp)          # the block's positions
            heads = torch.arange(g0, g0 + Gc)
            rows_pos = pos[:, None].expand(-1, Gc).reshape(-1)   # position-major
            # packed rows (b, hk, position * Gc + head, D); rows past S are zeros
            tile = torch.zeros(B, Hkv, W * Mp, Gc, D)
            pv, hv = pos[pos < S], heads[heads < G]
            tile[:, :, : len(pv), : len(hv)] = qf[:, pv][:, :, :, hv].permute(0, 2, 1, 3, 4)
            qt = tile.reshape(B, Hkv, W * Mp * Gc, D)
            m = torch.full(qt.shape[:3], NEG)
            l = torch.zeros(qt.shape[:3])
            o = torch.zeros(qt.shape)
            kv_end = min(S, p0 + W * Mp) if causal else S
            for kv0 in range(0, kv_end, 64):          # no tile past the block
                keys = torch.arange(kv0, kv0 + 64)
                kt = torch.zeros(B, Hkv, 64, D)
                vt = torch.zeros(B, Hkv, 64, D)
                n = min(64, S - kv0)
                kt[:, :, :n] = kf[:, kv0:kv0 + n].permute(0, 2, 1, 3)
                vt[:, :, :n] = vf[:, kv0:kv0 + n].permute(0, 2, 1, 3)
                x = (qt @ kt.transpose(-1, -2)) * scale_log2
                ok = keys[None, :] < S
                if causal:
                    ok = ok & (keys[None, :] <= rows_pos[:, None])
                x = torch.where(ok, x, torch.tensor(NEG))
                mn = torch.maximum(m, x.amax(-1))
                a = torch.exp2(m - mn)
                p = torch.exp2(x - mn[..., None])
                l = a * l + p.sum(-1)
                o = a[..., None] * o + p.to(torch.bfloat16).float() @ vt
                m = mn
            res = (o / torch.clamp(l, min=1e-30)[..., None]).reshape(
                B, Hkv, W * Mp, Gc, D).permute(0, 2, 1, 3, 4)
            row_lse = (m + torch.log2(l)).reshape(B, Hkv, W * Mp, Gc).permute(0, 2, 1, 3)
            for i, pi in enumerate(pos.tolist()):
                if pi < S:
                    out[:, pi, :, g0:g0 + len(hv)] = res[:, i, :, : len(hv)]
                    lse[:, pi, :, g0:g0 + len(hv)] = row_lse[:, i, :, : len(hv)]
    out = out.reshape(B, S, Hq, D).to(torch.bfloat16)
    if with_lse:
        return out, lse.reshape(B, S, Hq).permute(0, 2, 1).contiguous()
    return out


FLASH_SHAPES = [
    # B, S, Hq, Hkv, D, causal: the main paths' shapes, cut in batch
    (2, 28, 32, 8, 128, True),      # the ModelEncoder forward (G = 4)
    (1, 128, 32, 8, 128, True),     # llama3-8b prefill
    (1, 128, 32, 32, 112, True),    # zamba2's shared block (G = 1)
    (1, 77, 8, 2, 72, True),        # a head dim zero-padded to 80
    (1, 70, 8, 8, 96, False),       # full, two row tiles
]


@pytest.mark.parametrize("B,S,Hq,Hkv,D,causal", FLASH_SHAPES)
def test_flash_schedule_meets_the_kernel_tolerance(B, S, Hq, Hkv, D, causal):
    rng = np.random.default_rng(S * 100 + D)
    (qj, q), (kj, k), (vj, v) = (_pair(rng, (B, S, h, D))
                                 for h in (Hq, Hkv, Hkv))
    got = flash_schedule(q, k, v, causal).float().numpy()
    _within(got, ref.attention_ref(q, k, v, causal=causal).float().numpy())
    want = jax_ref.attention_ref(qj, kj, vj, causal=causal)
    _within(got, np.asarray(want.astype(jnp.float32)))


@pytest.mark.parametrize("B,S,Hq,Hkv,D,causal", FLASH_SHAPES)
def test_flash_schedule_lse_matches_the_references(B, S, Hq, Hkv, D, causal):
    """The log-sum-exp the forward kernel writes for training (log2 units),
    within 1e-5 of ``attention_lse_ref`` and of ``jax.nn.logsumexp`` of the
    reference's masked scores (times log2(e)), on the same bf16 inputs."""
    import jax
    rng = np.random.default_rng(S * 100 + D + 1)
    (qj, q), (kj, k), (vj, v) = (_pair(rng, (B, S, h, D))
                                 for h in (Hq, Hkv, Hkv))
    out, lse = flash_schedule(q, k, v, causal, with_lse=True)
    assert torch.equal(out, flash_schedule(q, k, v, causal))
    assert lse.shape == (B, Hq, S) and lse.dtype == torch.float32
    assert (lse - ref.attention_lse_ref(q, k, causal=causal)).abs().max() <= 1e-5
    kr = jnp.repeat(kj.astype(jnp.float32), Hq // Hkv, axis=2)
    s = jnp.einsum("bqhd,bkhd->bhqk", qj.astype(jnp.float32), kr) / np.sqrt(np.float32(D))
    if causal:
        s = jnp.where(jnp.tril(jnp.ones((S, S), bool))[None, None], s, NEG)
    want = np.asarray(jax.nn.logsumexp(s, axis=-1)) * LOG2E
    assert np.abs(lse.numpy() - want).max() <= 1e-5


def test_flash_schedule_at_4096_positions():
    """The stress shape's length and group (B = 1, S = 4096, G = 4), with
    four query heads of 64 so that the plain versions' (S, S) logits stay
    small."""
    rng = np.random.default_rng(4096)
    (qj, q), (kj, k), (vj, v) = (_pair(rng, (1, 4096, h, 64)) for h in (4, 1, 1))
    got = flash_schedule(q, k, v, True).float().numpy()
    _within(got, ref.attention_ref(q, k, v, causal=True).float().numpy())
    want = jax_ref.attention_ref(qj, kj, vj, causal=True)
    _within(got, np.asarray(want.astype(jnp.float32)))


def test_tma_ready_pads_the_head_dim_and_aligns():
    x = torch.randn(2, 5, 3, 20)
    y = tma_ready(x)
    assert y.shape == (2, 5, 3, 24) and y.shape[-1] % TMA_ALIGN == 0
    assert torch.equal(y[..., :20], x) and not y[..., 20:].any()
    z = torch.randn(2, 5, 3, 16)
    assert tma_ready(z) is z
    shifted = torch.randn(2 * 5 * 3 * 16 + 1)[1:].view(2, 5, 3, 16)
    assert shifted.data_ptr() % 16 != 0
    w = tma_ready(shifted)
    assert w.data_ptr() % 16 == 0 and torch.equal(w, shifted)


# ---------------------------------------------------------------------------
# flash_attention_bwd: the two entries' tile schedules
# ---------------------------------------------------------------------------
BWD_TILE = 64


def _tile(x, h, r0, S):
    """Rows r0 .. r0 + 63 of head h of x (B, S, H, D) in float32, rows past S
    zeros: what the f32 kernel stages in shared memory."""
    t = torch.zeros(x.shape[0], BWD_TILE, x.shape[3])
    n = max(0, min(BWD_TILE, S - r0))
    t[:, :n] = x[:, r0:r0 + n, h].float()
    return t


def _allowed(rows, keys, S, causal):
    """(rows, keys) pairs a score is kept for: keys before S, and no key
    past its row when causal."""
    ok = (keys[None] < S).expand(len(rows), -1)
    return ok & (keys[None] <= rows[:, None]) if causal else ok


def flash_bwd_schedule(q, k, v, o, lse, do, causal):
    """``csrc/flash_attention_bwd.cu``'s float32 entries, tile by tile: A per
    (query tile, query head) takes Di = dO . o and sums dq over the allowed
    64-key tiles in one sweep, P = exp2(q.k scale log2(e) - lse) with the
    forward's lse (log2 units); B per (key tile, KV head) loops over the
    group's heads and the query tiles from the tile's first key (causal) or
    0, reading the forward's lse and A's Di. Vectorised over the batch.
    Returns (dq, dk, dv) in the inputs' type."""
    B, S, Hq, D = q.shape
    Hkv = k.shape[2]
    G = Hq // Hkv
    scale = np.float32(1.0) / np.sqrt(np.float32(D))
    scale_log2 = scale * np.float32(LOG2E)
    dq = torch.zeros(B, S, Hq, D)
    dk = torch.zeros(B, S, Hkv, D)
    dv = torch.zeros(B, S, Hkv, D)
    delta = torch.zeros(B, Hq, S)
    tiles = range(0, S, BWD_TILE)
    local = torch.arange(BWD_TILE)

    def rows_of(x, h, r0):       # (B, 64) of a (B, Hq, S) array, zeros past S
        t = torch.zeros(B, BWD_TILE)
        n = min(BWD_TILE, S - r0)
        t[:, :n] = x[:, h, r0:r0 + n]
        return t
    for h in range(Hq):                                   # entry A
        hk = h // G
        for q0 in tiles:
            qs, dos = _tile(q, h, q0, S), _tile(do, h, q0, S)
            rows = q0 + local
            di = (dos * _tile(o, h, q0, S)).sum(-1)
            lse_t = rows_of(lse, h, q0)
            kv_end = min(S, q0 + BWD_TILE) if causal else S
            acc = torch.zeros(B, BWD_TILE, D)
            for kv0 in range(0, kv_end, BWD_TILE):
                keys = kv0 + local
                ks, vs = _tile(k, hk, kv0, S), _tile(v, hk, kv0, S)
                ok = _allowed(rows, keys, S, causal)
                p = torch.where(ok, torch.exp2((qs @ ks.transpose(1, 2)) * scale_log2
                                               - lse_t[..., None]),
                                torch.tensor(0.0))
                acc += (p * (dos @ vs.transpose(1, 2) - di[..., None])) @ ks
            n = min(BWD_TILE, S - q0)
            dq[:, q0:q0 + n, h] = (acc * scale)[:, :n]
            delta[:, h, q0:q0 + n] = di[:, :n]
    for hk in range(Hkv):                                 # entry B
        for k0 in tiles:
            ks, vs = _tile(k, hk, k0, S), _tile(v, hk, k0, S)
            keys = k0 + local
            dk_acc = torch.zeros(B, BWD_TILE, D)
            dv_acc = torch.zeros(B, BWD_TILE, D)
            for h in range(hk * G, hk * G + G):
                for r0 in range(k0 if causal else 0, S, BWD_TILE):
                    rows = r0 + local
                    qs, dos = _tile(q, h, r0, S), _tile(do, h, r0, S)
                    lse_r, di = rows_of(lse, h, r0), rows_of(delta, h, r0)
                    ok = (rows[:, None] < S) & _allowed(rows, keys, S, causal)
                    p = torch.where(ok, torch.exp2((qs @ ks.transpose(1, 2)) * scale_log2
                                                   - lse_r[..., None]),
                                    torch.tensor(0.0))
                    ds = p * (dos @ vs.transpose(1, 2) - di[..., None])
                    dv_acc += p.transpose(1, 2) @ dos
                    dk_acc += ds.transpose(1, 2) @ qs
            n = min(BWD_TILE, S - k0)
            dk[:, k0:k0 + n, hk] = (dk_acc * scale)[:, :n]
            dv[:, k0:k0 + n, hk] = dv_acc[:, :n]
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _packed_rows(S, G, c, t):
    """Positions and heads of the 64 packed rows of tile t of head chunk c,
    and which of them are rows of the tensor (a group that does not divide
    64 leaves rows past Gc * Mp; positions past S and heads past G)."""
    Gc, Mp, _, _ = fa.packing(S, G)
    r = torch.arange(64)
    pos, head = t * Mp + r // Gc, c * Gc + r % Gc
    return pos, head, (r < Gc * Mp) & (pos < S) & (head < G)


def _gather(x, pos, head, valid, G):
    """Packed rows of x (B, S, Hq, D) as (B, Hkv, 64, D) float32, zeros for
    rows that are none of the tensor's: what TMA lands in a Q panel."""
    B, S, Hq, D = x.shape
    out = torch.zeros(B, Hq // G, 64, D)
    xg = x.float().reshape(B, S, Hq // G, G, D)
    out[:, :, valid] = xg[:, pos[valid], :, head[valid]].permute(1, 2, 0, 3)
    return out


def flash_bwd_tc_schedule(q, k, v, o, lse, do, causal):
    """``csrc/flash_attention_bwd.cu``'s bf16 entries, tile by tile, in the
    kernel's arithmetic: bf16 inputs, f32 products and sums, P = exp2(S
    scale_log2 - lse) on the forward's lse, and the two roundings of the
    tensor-core design: dS to bf16 before dq += dS.K (A), P^T and dS^T to
    bf16 before dV += P^T.dO and dK += dS^T.Q (B). Rows are packed as
    (position, query head of the group) in 64-row tiles of Gc heads and Mp
    positions; the causal mask compares keys with positions. A writes each
    tile's (lse, Di) pairs into a scratch of ``bwd_scratch_floats`` floats
    that starts as NaN, and B reads them back, so a pair B read unwritten
    would poison its gradients. Vectorised over batch and KV head. Returns
    (dq, dk, dv) in bf16."""
    B, S, Hq, D = q.shape
    Hkv = k.shape[2]
    G = Hq // Hkv
    Gc, Mp, nc, nt = fa.packing(S, G)
    scale = np.float32(1.0) / np.sqrt(np.float32(D))
    scale_log2 = np.float32(LOG2E) / np.sqrt(np.float32(D))
    bf = torch.bfloat16
    kf, vf = k.float(), v.float()
    lse4 = lse.reshape(B, Hkv, G, S)
    pairs = torch.full((B, Hkv, nc, nt, 64, 2), math.nan)
    assert pairs.numel() == fa.bwd_scratch_floats(B, S, Hq, Hkv, True)
    local = torch.arange(64)
    zero = torch.tensor(0.0)

    def keys_of(x, k0):          # a 64-key tile (B, Hkv, 64, D), zeros past S
        t = torch.zeros(B, Hkv, 64, D)
        n = min(64, S - k0)
        t[:, :, :n] = x[:, k0:k0 + n].permute(0, 2, 1, 3)
        return t

    dq = torch.zeros(B, S, Hkv, G, D)
    for c in range(nc):                                   # entry A
        for t in range(nt):
            pos, head, valid = _packed_rows(S, G, c, t)
            qt, dot = _gather(q, pos, head, valid, G), _gather(do, pos, head, valid, G)
            lse_r = torch.zeros(B, Hkv, 64)
            lse_r[:, :, valid] = lse4[:, :, head[valid], pos[valid]].float()
            di = (dot * _gather(o, pos, head, valid, G)).sum(-1)
            pairs[:, :, c, t, :, 0], pairs[:, :, c, t, :, 1] = lse_r, di
            kv_end = min(S, t * Mp + Mp) if causal else S
            acc = torch.zeros(B, Hkv, 64, D)
            for kv0 in range(0, kv_end, 64):
                kt, vt = keys_of(kf, kv0), keys_of(vf, kv0)
                keys = kv0 + local
                p = torch.exp2((qt @ kt.transpose(-1, -2)) * scale_log2 - lse_r[..., None])
                ok = keys[None] < S
                if causal:
                    ok = ok & (keys[None] <= pos[:, None])
                p = torch.where(ok, p, zero)
                ds = p * (dot @ vt.transpose(-1, -2) - di[..., None])
                acc += ds.to(bf).float() @ kt
            res = (acc * scale)[:, :, valid].permute(2, 0, 1, 3)
            dq[:, pos[valid], :, head[valid]] = res
    dk = torch.zeros(B, S, Hkv, D)
    dv = torch.zeros(B, S, Hkv, D)
    for k0 in range(0, S, 64):                            # entry B
        kt, vt = keys_of(kf, k0), keys_of(vf, k0)
        keys = k0 + local
        dk_acc = torch.zeros(B, Hkv, 64, D)
        dv_acc = torch.zeros(B, Hkv, 64, D)
        for c in range(nc):
            for t in range(k0 // Mp if causal else 0, nt):
                if causal and min(S, t * Mp + Mp) - 1 < k0:
                    continue          # no position of the tile sees these keys
                pos, head, valid = _packed_rows(S, G, c, t)
                qt, dot = _gather(q, pos, head, valid, G), _gather(do, pos, head, valid, G)
                lse_c, di_c = pairs[:, :, c, t, :, 0], pairs[:, :, c, t, :, 1]
                p = torch.exp2((kt @ qt.transpose(-1, -2)) * scale_log2 - lse_c[..., None, :])
                ok = valid[None] & (keys[:, None] < S)
                if causal:
                    ok = ok & (keys[:, None] <= pos[None])
                p = torch.where(ok, p, zero)
                ds = p * (vt @ dot.transpose(-1, -2) - di_c[..., None, :])
                dv_acc += p.to(bf).float() @ dot
                dk_acc += ds.to(bf).float() @ qt
        n = min(64, S - k0)
        dk[:, k0:k0 + n] = (dk_acc * scale)[:, :, :n].permute(0, 2, 1, 3)
        dv[:, k0:k0 + n] = dv_acc[:, :, :n].permute(0, 2, 1, 3)
    return dq.reshape(B, S, Hq, D).to(bf), dk.to(bf), dv.to(bf)


BWD_SHAPES = [
    # B, S, Hq, Hkv, D, causal
    (2, 64, 4, 2, 16, True),        # the smoke configs' shape
    (1, 100, 4, 1, 64, True),       # a ragged tail, a group of 4
    (1, 100, 2, 2, 96, False),      # full, phi3's head dim
    (1, 1, 4, 2, 128, True),        # S = 1
    (1, 130, 8, 2, 128, True),      # three tiles, llama's head dim and group
    (2, 77, 2, 2, 64, False),       # whisper's encoder, full, ragged
    (1, 20, 96, 1, 32, True),       # G = 96: two head chunks, the second part empty
    (1, 50, 6, 2, 32, True),        # G = 3: 63 packed rows a tile
]


def _bwd_inputs(rng, B, S, Hq, Hkv, D, dtype):
    q, k, v, do = (torch.from_numpy(rng.normal(size=(B, S, h, D)).astype(np.float32)
                                    ).to(dtype) for h in (Hq, Hkv, Hkv, Hq))
    return q, k, v, do


@pytest.mark.parametrize("B,S,Hq,Hkv,D,causal", BWD_SHAPES)
def test_flash_bwd_schedule_matches_the_plain_version(B, S, Hq, Hkv, D, causal):
    """f32: the schedule, on the plain lse, within 1e-4 of the largest |plain|
    of the three gradients (chip_smoke.py's f32 tolerance for the kernel; at
    S = 1 dq and dk are 0 up to rounding), and against jax.vjp of the
    reference."""
    import jax
    rng = np.random.default_rng(S * 7 + D)
    q, k, v, do = _bwd_inputs(rng, B, S, Hq, Hkv, D, torch.float32)
    o = ref.attention_ref(q, k, v, causal=causal)
    lse = ref.attention_lse_ref(q, k, causal=causal)
    got = flash_bwd_schedule(q, k, v, o, lse, do, causal)
    want = ref.attention_bwd_ref(q, k, v, o, do, causal=causal)
    _, vjp = jax.vjp(lambda a, b, c: jax_ref.attention_ref(a, b, c, causal=causal),
                     *(jnp.asarray(x.numpy()) for x in (q, k, v)))
    top = max(w.abs().max().item() for w in want)
    for g, w, j in zip(got, want, vjp(jnp.asarray(do.numpy()))):
        assert (g - w).abs().max().item() <= 1e-4 * top
        assert np.abs(g.numpy() - np.asarray(j)).max() <= 1e-4 * top


def _tc_case(B, S, Hq, Hkv, D, causal, q, k, v, do):
    """The bf16 forward's o and lse (its schedule, as the kernel gives them
    to the backward), the tensor-core schedule's gradients, the float64
    plain gradients on the same bf16 inputs and their largest |value|."""
    o, lse = flash_schedule(q, k, v, causal, with_lse=True)
    got = flash_bwd_tc_schedule(q, k, v, o, lse, do, causal)
    want = ref.attention_bwd_ref(*(x.double() for x in (q, k, v, o, do)),
                                 causal=causal)
    return o, got, want, max(w.abs().max().item() for w in want)


@pytest.mark.parametrize("B,S,Hq,Hkv,D,causal", BWD_SHAPES)
def test_flash_bwd_schedule_meets_the_bf16_criterion(B, S, Hq, Hkv, D, causal):
    """bf16: the tensor-core schedule's outputs within one bf16 ulp plus
    ``chip_smoke.BWD_TC_EXCESS`` of the largest |w| of w, the plain version
    in float64 on the same bf16 inputs (the criterion the card's rows are
    held to). The schedule stays within half the constant, which is pinned
    here."""
    import chip_smoke
    assert chip_smoke.BWD_TC_EXCESS == 4e-3
    rng = np.random.default_rng(S * 11 + D)
    q, k, v, do = _bwd_inputs(rng, B, S, Hq, Hkv, D, torch.bfloat16)
    _, got, want, top = _tc_case(B, S, Hq, Hkv, D, causal, q, k, v, do)
    for g, w in zip(got, want):
        assert g.dtype == torch.bfloat16 and torch.isfinite(g.float()).all()
        assert chip_smoke.bwd_excess(g, w, top) <= chip_smoke.BWD_TC_EXCESS / 2


# the shapes BWD_TC_EXCESS was derived at, inputs from a torch generator of
# seed 0: phi3's and llama's training rows and whisper's encoder, cut in
# batch and heads, and a ragged full row
TC_DERIVATION = [
    (1, 512, 4, 4, 96, True),
    (1, 512, 8, 2, 128, True),
    (1, 1500, 2, 2, 64, False),
    (2, 100, 8, 2, 64, False),
]


@pytest.mark.parametrize("B,S,Hq,Hkv,D,causal", TC_DERIVATION)
def test_flash_bwd_tc_excess_at_the_derivation_shapes(B, S, Hq, Hkv, D, causal):
    """Where ``BWD_TC_EXCESS`` comes from: the two bf16 roundings (P and dS)
    put the tensor-core schedule 2.9e-4 to 1.48e-3 of the largest |value|
    beyond one ulp at these shapes; the constant keeps more than twice
    that."""
    import chip_smoke
    gen = torch.Generator().manual_seed(0)
    q, k, v, do = (torch.randn(B, S, h, D, generator=gen).to(torch.bfloat16)
                   for h in (Hq, Hkv, Hkv, Hq))
    _, got, want, top = _tc_case(B, S, Hq, Hkv, D, causal, q, k, v, do)
    worst = max(chip_smoke.bwd_excess(g, w, top) for g, w in zip(got, want))
    assert 1e-4 < worst <= chip_smoke.BWD_TC_EXCESS / 2


@pytest.mark.parametrize("B,S,Hq,Hkv,D,causal", BWD_SHAPES)
def test_flash_bwd_tc_schedule_matches_the_references(B, S, Hq, Hkv, D, causal):
    """The tensor-core schedule against ``attention_bwd_ref`` (float32) and
    ``jax.vjp`` of ``repro.kernels.ref.attention_ref`` on the same bf16
    values in float32, each within one bf16 ulp plus ``BWD_TC_EXCESS`` of
    the largest |value|."""
    import jax
    import chip_smoke
    rng = np.random.default_rng(S * 13 + D)
    q, k, v, do = _bwd_inputs(rng, B, S, Hq, Hkv, D, torch.bfloat16)
    o, got, _, _ = _tc_case(B, S, Hq, Hkv, D, causal, q, k, v, do)
    plain = ref.attention_bwd_ref(*(x.float() for x in (q, k, v, o, do)),
                                  causal=causal)
    _, vjp = jax.vjp(lambda a, b, c: jax_ref.attention_ref(a, b, c, causal=causal),
                     *(jnp.asarray(x.float().numpy()) for x in (q, k, v)))
    jgrads = [torch.from_numpy(np.array(j))
              for j in vjp(jnp.asarray(do.float().numpy()))]
    for want in (plain, jgrads):
        top = max(w.abs().max().item() for w in want)
        for g, w in zip(got, want):
            assert chip_smoke.bwd_excess(g, w, top) <= chip_smoke.BWD_TC_EXCESS


def test_flash_bwd_padding_rows_write_nothing():
    """The schedules write rows 0 .. S-1 only, whatever the tiles cover: a
    ragged S gives the plain version's gradient with no tail garbage."""
    rng = np.random.default_rng(5)
    q, k, v, do = _bwd_inputs(rng, 1, 65, 2, 1, 16, torch.float32)
    o = ref.attention_ref(q, k, v, causal=True)
    lse = ref.attention_lse_ref(q, k, causal=True)
    for g, w in zip(flash_bwd_schedule(q, k, v, o, lse, do, True),
                    ref.attention_bwd_ref(q, k, v, o, do, causal=True)):
        assert g.shape == w.shape and torch.isfinite(g).all()
        assert (g - w).abs().max() <= 1e-5


def test_bwd_scratch_and_packing():
    """The packed rows' plan: every (position, head) of a KV head's group in
    exactly one row of one tile, rows past Gc * Mp none; the scratch holds
    every tile's 64 pairs (float32 Di only for the f32 kernels)."""
    for S, G in ((1, 1), (77, 4), (50, 3), (40, 128), (20, 96), (512, 1)):
        Gc, Mp, nc, nt = fa.packing(S, G)
        seen = np.zeros((S, G), np.int64)
        for c in range(nc):
            for t in range(nt):
                pos, head, valid = _packed_rows(S, G, c, t)
                np.add.at(seen, (pos[valid].numpy(), head[valid].numpy()), 1)
        assert (seen == 1).all() and Gc * Mp <= 64 and Gc == min(G, 64)
    assert fa.bwd_scratch_floats(2, 77, 8, 2, True) == 2 * 2 * 1 * 5 * 64 * 2
    assert fa.bwd_scratch_floats(2, 77, 8, 2, False) == 2 * 8 * 77


# ---------------------------------------------------------------------------
# decode_attention: the chunk plan and the merge
# ---------------------------------------------------------------------------
SMAXES = [1, 63, 512, 4096, 32768]


def _lengths(smax):
    return sorted({0, 1, smax // 2, max(smax - 1, 0), smax, smax + 5,
                   CHUNK, CHUNK + 1, 2 * CHUNK, 3 * TILE})


@pytest.mark.parametrize("smax", SMAXES)
def test_decode_plan_owns_every_position_once(smax):
    splits, chunk = plan_splits(smax)
    assert chunk == CHUNK == 2 * TILE and splits * chunk >= smax
    assert (splits - 1) * chunk < max(smax, 1), "no empty trailing split"
    for length in _lengths(smax):
        n = min(max(length, 0), smax)
        owned = np.zeros(max(smax, 1), np.int64)
        for sp in range(splits):
            begin = sp * chunk
            if begin >= n:          # the block exits at once
                continue
            end = min(begin + chunk, n)
            owned[begin:end] += 1
        assert (owned[:n] == 1).all()
        assert not owned[n:].any(), "a position at or past the length is read"


def test_decode_plan_reads_smax_only():
    assert list(inspect.signature(plan_splits).parameters) == ["Smax"]
    assert plan_splits(512) == (4, CHUNK) and plan_splits(32768) == (256, CHUNK)


def _merge(parts, exp):
    """Partials (m, l, acc) merged in list order, as the kernel merges a
    group: the max first, then the weights, the sums in order."""
    M = torch.stack([m for m, _, _ in parts]).amax(0)
    w = [exp(m - M) for m, _, _ in parts]
    L = sum(wi * l for wi, (_, l, _) in zip(w, parts))
    A = sum(wi[:, None] * acc for wi, (_, _, acc) in zip(w, parts))
    return M, L, A


def decode_schedule(q, kc, vc, lengths, arrival=None, with_lse=False):
    """The decode kernel's arithmetic and merge: per (batch, KV head) each
    live chunk folds its rows into (m, l, acc): bf16, the whole chunk in one
    softmax, exp2 on log2(e)-scaled scores and P rounded to bf16 before P.V,
    as on the tensor cores; float32, 64-row tiles with an online softmax
    (exp). One live chunk writes the output. Otherwise the blocks finish in
    ``arrival`` order (split-index order by default): each writes its
    partial into its slot of a scratch that holds NaN until then (the
    kernel's is uninitialised), then draws a ticket from its group's
    counter. The block that draws the group's last ticket sets the counter
    back to 0 and merges the group's ``FAN_IN`` slots in split-index order;
    with more than one group it writes a second-level slot and draws from
    the second-level counter, whose last block merges those in group
    order. Every counter must be back at 0 at the end.

    A block row is (batch, KV head, chunk of the group's query heads): at
    most ``BLOCK_HEADS`` heads in bf16, the whole group in float32. With
    ``with_lse`` it also returns each query head's log-sum-exp in log2 units,
    written once per head by whichever write ends its row: the one live
    chunk's (m + log2 l; float32 keeps m in natural units, so m log2(e) +
    log2 l), the last level of the merge's (M, L), or -inf at a length of
    0."""
    B, Smax, Hkv, D = kc.shape
    G = q.shape[1] // Hkv
    bf16 = q.dtype == torch.bfloat16
    Gb = min(G, BLOCK_HEADS) if bf16 else G
    splits, chunk = plan_splits(Smax)
    scale = np.float32(1.0 / math.sqrt(D))
    qf = q.float().reshape(B, Hkv, G, D)
    out = torch.zeros(B, Hkv, G, D)
    lse = torch.full((B, Hkv, G), math.nan)
    exp = torch.exp2 if bf16 else torch.exp    # m's units

    def log2_sum(m, l):
        return (m if bf16 else m * np.float32(LOG2E)) + torch.log2(l)

    def fold(b, hk, g0, sp, n):
        heads = slice(g0, min(g0 + Gb, G))
        Gh = heads.stop - heads.start
        m = torch.full((Gh,), NEG)
        l = torch.zeros(Gh)
        acc = torch.zeros(Gh, D)
        begin, end = sp * chunk, min(sp * chunk + chunk, n)
        step = chunk if bf16 else TILE   # bf16: the chunk in one pass
        for t0 in range(begin, end, step):
            t1 = min(t0 + step, end)
            kt = kc[b, t0:t1, hk].float()
            vt = vc[b, t0:t1, hk].float()
            s = qf[b, hk, heads] @ kt.T
            if bf16:
                x = s * np.float32(scale * LOG2E)
                mn = torch.maximum(m, x.amax(-1))
                p, a = torch.exp2(x - mn[:, None]), torch.exp2(m - mn)
                pv = p.to(torch.bfloat16).float()
            else:
                x = s * scale
                mn = torch.maximum(m, x.amax(-1))
                p, a = torch.exp(x - mn[:, None]), torch.exp(m - mn)
                pv = p
            l = a * l + p.sum(-1)
            acc = a[:, None] * acc + pv @ vt
            m = mn
        return m, l, acc

    for b, hk, g0 in ((b, hk, g0) for b in range(B) for hk in range(Hkv)
                      for g0 in range(0, G, Gb)):
        heads = slice(g0, min(g0 + Gb, G))
        Gh = heads.stop - heads.start
        garbage = (torch.full((Gh,), math.nan), torch.full((Gh,), math.nan),
                   torch.full((Gh, D), math.nan))
        n = min(max(int(lengths[b]), 0), Smax)
        live = -(-n // chunk)
        assert lse[b, hk, heads].isnan().all(), "a head written twice"
        if live == 0:
            lse[b, hk, heads] = -math.inf
            continue            # zeros
        if live == 1:
            m, l, acc = fold(b, hk, g0, 0, n)
            out[b, hk, heads] = acc / torch.clamp(l, min=1e-30)[:, None]
            lse[b, hk, heads] = log2_sum(m, l)
            continue
        groups = -(-live // FAN_IN)
        slots = [garbage] * splits
        second = [garbage] * groups
        counters = [0] * (1 + groups)     # [second level, groups...]
        result = None
        order = list(range(live)) if arrival is None else arrival(live)
        for sp in order:
            slots[sp] = fold(b, hk, g0, sp, n)
            g = sp // FAN_IN
            in_group = min(FAN_IN, live - g * FAN_IN)
            ticket, counters[1 + g] = counters[1 + g], counters[1 + g] + 1
            if ticket != in_group - 1:
                continue
            counters[1 + g] = 0
            merged = _merge(slots[g * FAN_IN:g * FAN_IN + in_group], exp)
            if groups == 1:
                result = merged
                continue
            second[g] = merged
            ticket, counters[0] = counters[0], counters[0] + 1
            if ticket != groups - 1:
                continue
            counters[0] = 0
            result = _merge(second, exp)
        assert result is not None and not any(counters)
        M, L, A = result
        out[b, hk, heads] = A / torch.clamp(L, min=1e-30)[:, None]
        lse[b, hk, heads] = log2_sum(M, L)
    out = out.reshape(B, Hkv * G, D).to(q.dtype)
    assert not lse.isnan().any(), "a head's lse was never written"
    return (out, lse.reshape(B, Hkv * G)) if with_lse else out


@pytest.mark.parametrize("smax", SMAXES)
def test_decode_schedule_matches_the_references(smax):
    rng = np.random.default_rng(smax)
    lens = np.array(_lengths(smax), np.int32)
    B, Hq, Hkv, D = len(lens), 4, 2, 16
    (qj, q), (kj, k), (vj, v) = (_pair(rng, s) for s in (
        (B, Hq, D), (B, smax, Hkv, D), (B, smax, Hkv, D)))
    got = decode_schedule(q, k, v, lens)
    plain = ref.decode_attention_ref(q, k, v, torch.from_numpy(lens))
    _within(got.float().numpy(), plain.float().numpy())
    assert not got[lens == 0].float().any(), "length 0 gives zeros"
    # the jnp oracle agrees wherever the length is not 0
    want = np.asarray(jax_ref.decode_attention_ref(
        qj, kj, vj, jnp.asarray(lens)).astype(jnp.float32))
    _within(got.float().numpy()[lens > 0], want[lens > 0])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_merge_is_the_same_whatever_block_finishes_last(dtype):
    """Two levels: 3000 positions are 24 chunks, two groups. The blocks
    finish in split order, in reverse and in shuffled orders; a merge that
    ran before its group had arrived would read NaN, and one that folded
    the slots in arrival order would change the bits."""
    rng = np.random.default_rng(3)
    (_, q), (_, k), (_, v) = (_pair(rng, s) for s in (
        (2, 8, 32), (2, 3000, 2, 32), (2, 3000, 2, 32)))
    q, k, v = q.to(dtype), k.to(dtype), v.to(dtype)
    lens = torch.tensor([3000, 700], dtype=torch.int32)
    first = decode_schedule(q, k, v, lens)
    assert torch.isfinite(first.float()).all()
    shuffles = np.random.default_rng(0)
    for arrival in (lambda n: list(range(n))[::-1],
                    lambda n: shuffles.permutation(n).tolist(),
                    lambda n: shuffles.permutation(n).tolist()):
        assert torch.equal(first, decode_schedule(q, k, v, lens, arrival))
    _within(first.float().numpy(),
            ref.decode_attention_ref(q, k, v, lens).float().numpy())


@pytest.mark.parametrize("group", [4, 8, 32])
@pytest.mark.parametrize("splits", [1, 2, 17, 300])
def test_decode_schedule_lse_matches_the_plain_version(splits, group):
    """Each head's lse from the kernel's schedule (bf16: block rows of
    ``BLOCK_HEADS`` heads, a group of 32 is two; the merge's two levels
    past 16 splits) against ``decode_attention_lse_ref`` within
    ``chip_smoke.LSE_TOL``'s bf16 1e-4, with a length of 0 (-inf and
    zeros), a length inside the first chunk and one past Smax; the output
    is the schedule's without the lse. The float32 schedule (m in natural
    units) at the same plans, within 1e-5."""
    Smax = splits * CHUNK
    assert plan_splits(Smax)[0] == splits
    rng = np.random.default_rng(splits * 100 + group)
    lens = np.array([0, 37, Smax, Smax + 9], np.int32)
    B, Hkv, D = len(lens), 2 if group < 32 else 1, 16
    Hq = group * Hkv
    (_, q), (_, k), (_, v) = (_pair(rng, s) for s in (
        (B, Hq, D), (B, Smax, Hkv, D), (B, Smax, Hkv, D)))
    tl = torch.from_numpy(lens)
    for x, tol in (((q, k, v), 1e-4), (tuple(t.float() for t in (q, k, v)),
                                       1e-5)):
        out, lse = decode_schedule(*x, tl, with_lse=True)
        assert torch.equal(out, decode_schedule(*x, tl))
        plain, plain_lse = ref.decode_attention_lse_ref(*x, tl)
        _within(out.float().numpy(), plain.float().numpy())
        assert (lse[0] == -math.inf).all() and not out[0].float().any()
        err = (lse[1:] - plain_lse[1:]).abs().max().item()
        assert err <= tol, (splits, group, x[0].dtype, err)


@pytest.mark.parametrize("Hq,Hkv,bf16", [(32, 8, True), (32, 32, True),
                                          (64, 1, True), (32, 8, False)])
def test_decode_scratch_holds_every_slot(Hq, Hkv, bf16):
    """The wrapper's scratch covers every slot and counter the kernel's merge
    touches, walked as the kernel indexes them (block row ``by = (b, KV head,
    head chunk)``; per row ``splits`` first-level slots, then one per group,
    each of ``heads x (Dp + 4)`` floats, and ``1 + groups`` counters), and
    no two block rows share a float or a counter. The kernel's entry point
    refuses a smaller allocation on the card (``chip_smoke.py`` checks)."""
    B, D, splits = 3, 72, 256
    n_part, n_cnt = scratch_sizes(B, Hq, Hkv, D, splits, bf16)
    G = Hq // Hkv
    heads = min(G, 16) if bf16 else G              # Gb
    Dp = -(-D // 16) * 16 if bf16 else -(-D // 8) * 8
    slot = heads * (Dp + 4)
    groups = -(-splits // FAN_IN)
    grid_y = Hkv * -(-G // heads)
    floats = np.zeros(n_part, np.int32)
    counters = np.zeros(n_cnt, np.int32)
    for b in range(B):
        for y in range(grid_y):
            by = b * grid_y + y
            base = by * (splits + groups) * slot
            for sp in range(splits + groups):   # first level, then second
                lo = base + sp * slot
                assert lo + slot <= n_part
                floats[lo:lo + slot] += 1
            c0 = by * (1 + groups)
            assert c0 + 1 + groups <= n_cnt
            counters[c0:c0 + 1 + groups] += 1
    assert floats.max() == 1 and counters.max() == 1


# ---------------------------------------------------------------------------
# the wrappers: what they refuse, and no fallback off the CPU
# ---------------------------------------------------------------------------
def test_wrappers_refuse_shapes_they_refused():
    q, kv = torch.zeros(1, 8, 4, 16), torch.zeros(1, 8, 2, 16)
    with pytest.raises(ValueError):
        ops.attention(q, kv, torch.zeros(1, 8, 2, 8))          # k, v differ
    with pytest.raises(ValueError):
        ops.attention(q, torch.zeros(1, 8, 3, 16), torch.zeros(1, 8, 3, 16))
    with pytest.raises(ValueError):
        ops.attention(q, torch.zeros(1, 9, 2, 16), torch.zeros(1, 9, 2, 16))
    qd, cache = torch.zeros(2, 4, 16), torch.zeros(2, 32, 2, 16)
    with pytest.raises(ValueError):
        ops.decode_attention(qd, cache, cache, torch.zeros(3, dtype=torch.int32))
    with pytest.raises(ValueError):
        ops.decode_attention(torch.zeros(2, 3, 16), cache, cache,
                             torch.zeros(2, dtype=torch.int32))


@pytest.mark.parametrize("device", ["meta", "mixed"])
def test_attention_wrappers_never_fall_back_off_the_cpu(device):
    """A tensor anywhere but the CPU takes the kernel or raises; the plain
    version never runs for it."""
    def make(*shape, dtype=torch.float32):
        return torch.zeros(*shape, dtype=dtype, device="meta")
    flash_args = [make(1, 8, 4, 16), make(1, 8, 2, 16), make(1, 8, 2, 16)]
    dec_args = [make(2, 4, 16), make(2, 32, 2, 16), make(2, 32, 2, 16),
                make(2, dtype=torch.int32)]
    if device == "mixed":
        flash_args[0] = torch.zeros(1, 8, 4, 16)
        dec_args[3] = torch.zeros(2, dtype=torch.int32)
    before = {k: kernels.COUNTS[k].plain_calls
              for k in ("flash_attention", "decode_attention")}
    with pytest.raises(ValueError):
        ops.attention(*flash_args)
    with pytest.raises(ValueError):
        ops.decode_attention(*dec_args)
    with pytest.raises(ValueError):
        ops.decode_attention_lse(*dec_args)
    assert {k: kernels.COUNTS[k].plain_calls for k in before} == before


def test_every_included_header_is_hashed_with_the_sources(tmp_path,
                                                         monkeypatch):
    """A header the kernels include is part of the build's hash, so an edit
    to it rebuilds the libraries instead of loading stale ones."""
    import re
    import shutil

    from repro_torch.kernels import _build
    included = set()
    for name in _build.SOURCES:
        included |= set(re.findall(r'#include "([^"]+)"',
                                   (_build.CSRC / name).read_text()))
    assert "tma.cuh" in included
    assert included <= set(_build.HEADERS)
    for name in _build.SOURCES + _build.HEADERS:
        shutil.copy(_build.CSRC / name, tmp_path / name)
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    before = _build.source_hash()
    with open(tmp_path / "tma.cuh", "a") as f:
        f.write("\n")
    assert _build.source_hash() != before
