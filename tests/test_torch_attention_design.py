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
  ``chip_smoke.py``'s repeat check.)
- ``flash_attention_bwd``: its two entries' tile schedule (A: 64-row query
  tiles recomputing each row's log-sum-exp over 64-key tiles, keys past S
  at -inf and causally masked ones at -1e30, then dq; B: 64-key tiles
  looping over the group's query heads and the query tiles from the tile's
  first key, reading A's lse and Di), against ``attention_bwd_ref`` and
  ``jax.vjp`` of the reference in float32, and in bf16 against a float64
  run within one ulp plus ``chip_smoke.BWD_EXCESS`` (pinned here), with
  ragged tails, S = 1 and head dims 16, 64, 96 and 128.
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
from repro_torch.kernels import ops, ref
from repro_torch.kernels.decode_attention import (CHUNK, FAN_IN, TILE,
                                                 plan_splits, scratch_sizes)
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
def flash_schedule(q, k, v, causal):
    """The bf16 kernel's arithmetic: q (B, S, Hq, D), k and v (B, S, Hkv,
    D), bf16 -> (B, S, Hq, D) bf16. Block (row tile, head chunk, KV head,
    batch) as the kernel launches them, vectorised over batch and KV head."""
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
            for i, pi in enumerate(pos.tolist()):
                if pi < S:
                    out[:, pi, :, g0:g0 + len(hv)] = res[:, i, :, : len(hv)]
    return out.reshape(B, S, Hq, D).to(torch.bfloat16)


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
# flash_attention_bwd: the two entries' tile schedule
# ---------------------------------------------------------------------------
BWD_TILE = 64


def _tile(x, h, r0, S):
    """Rows r0 .. r0 + 63 of head h of x (B, S, H, D) in float32, rows past S
    zeros: what the kernel stages in shared memory."""
    t = torch.zeros(x.shape[0], BWD_TILE, x.shape[3])
    n = max(0, min(BWD_TILE, S - r0))
    t[:, :n] = x[:, r0:r0 + n, h].float()
    return t


def _allowed(rows, keys, S, causal):
    """(rows, keys) pairs a score is kept for: keys before S, and no key
    past its row when causal."""
    ok = (keys[None] < S).expand(len(rows), -1)
    return ok & (keys[None] <= rows[:, None]) if causal else ok


def flash_bwd_schedule(q, k, v, o, do, causal):
    """``csrc/flash_attention_bwd.cu``'s two entries, tile by tile, in
    float32: A per (query tile, query head) recomputes each row's lse in
    64-key tiles (keys past S at -inf, causally masked ones at -1e30), takes
    Di = dO . o and sums dq over the allowed key tiles; B per (key tile, KV
    head) loops over the group's heads and the query tiles from the tile's
    first key (causal) or 0, reading A's lse and Di. Vectorised over the
    batch. Returns (dq, dk, dv) in the inputs' type."""
    B, S, Hq, D = q.shape
    Hkv = k.shape[2]
    G = Hq // Hkv
    scale = np.float32(1.0) / np.sqrt(np.float32(D))
    dq = torch.zeros(B, S, Hq, D)
    dk = torch.zeros(B, S, Hkv, D)
    dv = torch.zeros(B, S, Hkv, D)
    lse = torch.zeros(B, Hq, S)
    delta = torch.zeros(B, Hq, S)
    tiles = range(0, S, BWD_TILE)
    local = torch.arange(BWD_TILE)
    for h in range(Hq):                                   # entry A
        hk = h // G
        for q0 in tiles:
            qs, dos = _tile(q, h, q0, S), _tile(do, h, q0, S)
            rows = q0 + local
            di = (dos * _tile(o, h, q0, S)).sum(-1)
            m = torch.full((B, BWD_TILE), NEG)
            l = torch.zeros(B, BWD_TILE)
            kv_end = min(S, q0 + BWD_TILE) if causal else S
            for kv0 in range(0, kv_end, BWD_TILE):
                keys = kv0 + local
                s = (qs @ _tile(k, hk, kv0, S).transpose(1, 2)) * scale
                if causal:
                    s = torch.where(keys[None] > rows[:, None],
                                    torch.tensor(NEG), s)
                s = torch.where(keys[None] >= S, torch.tensor(-math.inf), s)
                m_new = torch.maximum(m, s.amax(-1))
                l = l * torch.exp(m - m_new) + torch.exp(
                    s - m_new[..., None]).sum(-1)
                m = m_new
            lse_t = m + torch.log(l)
            acc = torch.zeros(B, BWD_TILE, D)
            for kv0 in range(0, kv_end, BWD_TILE):
                keys = kv0 + local
                ks, vs = _tile(k, hk, kv0, S), _tile(v, hk, kv0, S)
                ok = _allowed(rows, keys, S, causal)
                p = torch.where(ok, torch.exp((qs @ ks.transpose(1, 2)) * scale
                                              - lse_t[..., None]),
                                torch.tensor(0.0))
                acc += (p * (dos @ vs.transpose(1, 2) - di[..., None])) @ ks
            n = min(BWD_TILE, S - q0)
            dq[:, q0:q0 + n, h] = (acc * scale)[:, :n]
            lse[:, h, q0:q0 + n] = lse_t[:, :n]
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
                    lse_r = torch.zeros(B, BWD_TILE)
                    di = torch.zeros(B, BWD_TILE)
                    n = min(BWD_TILE, S - r0)
                    lse_r[:, :n], di[:, :n] = lse[:, h, r0:r0 + n], delta[:, h, r0:r0 + n]
                    ok = (rows[:, None] < S) & _allowed(rows, keys, S, causal)
                    p = torch.where(ok, torch.exp((qs @ ks.transpose(1, 2)) * scale
                                                  - lse_r[..., None]),
                                    torch.tensor(0.0))
                    ds = p * (dos @ vs.transpose(1, 2) - di[..., None])
                    dv_acc += p.transpose(1, 2) @ dos
                    dk_acc += ds.transpose(1, 2) @ qs
            n = min(BWD_TILE, S - k0)
            dk[:, k0:k0 + n, hk] = (dk_acc * scale)[:, :n]
            dv[:, k0:k0 + n, hk] = dv_acc[:, :n]
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


BWD_SHAPES = [
    # B, S, Hq, Hkv, D, causal
    (2, 64, 4, 2, 16, True),        # the smoke configs' shape
    (1, 100, 4, 1, 64, True),       # a ragged tail, a group of 4
    (1, 100, 2, 2, 96, False),      # full, phi3's head dim
    (1, 1, 4, 2, 128, True),        # S = 1
    (1, 130, 8, 2, 128, True),      # three tiles, llama's head dim and group
    (2, 77, 2, 2, 64, False),       # whisper's encoder, full, ragged
]


@pytest.mark.parametrize("B,S,Hq,Hkv,D,causal", BWD_SHAPES)
def test_flash_bwd_schedule_matches_the_plain_version(B, S, Hq, Hkv, D, causal):
    """f32: the schedule within 1e-4 of the largest |plain| of the three
    gradients (chip_smoke.py's f32 tolerance for the kernel; at S = 1 dq
    and dk are 0 up to rounding), and against jax.vjp of the reference."""
    import jax
    rng = np.random.default_rng(S * 7 + D)
    q, k, v = (torch.from_numpy(rng.normal(size=(B, S, h, D)).astype(np.float32))
               for h in (Hq, Hkv, Hkv))
    o = ref.attention_ref(q, k, v, causal=causal)
    do = torch.from_numpy(rng.normal(size=(B, S, Hq, D)).astype(np.float32))
    got = flash_bwd_schedule(q, k, v, o, do, causal)
    want = ref.attention_bwd_ref(q, k, v, o, do, causal=causal)
    _, vjp = jax.vjp(lambda a, b, c: jax_ref.attention_ref(a, b, c, causal=causal),
                     *(jnp.asarray(x.numpy()) for x in (q, k, v)))
    top = max(w.abs().max().item() for w in want)
    for g, w, j in zip(got, want, vjp(jnp.asarray(do.numpy()))):
        assert (g - w).abs().max().item() <= 1e-4 * top
        assert np.abs(g.numpy() - np.asarray(j)).max() <= 1e-4 * top


@pytest.mark.parametrize("B,S,Hq,Hkv,D,causal", BWD_SHAPES[:5])
def test_flash_bwd_schedule_meets_the_bf16_criterion(B, S, Hq, Hkv, D, causal):
    """bf16 inputs, f32 sums, outputs rounded to bf16: each output within one
    bf16 ulp plus ``chip_smoke.BWD_EXCESS`` of the largest |w| of w, the plain version
    in float64 on the same bf16 inputs (the criterion the card's rows are
    held to). The schedule stays ten times inside the constant, which is
    pinned here."""
    import chip_smoke
    assert chip_smoke.BWD_EXCESS == 1e-5
    rng = np.random.default_rng(S * 11 + D)
    q, k, v = (torch.from_numpy(rng.normal(size=(B, S, h, D)).astype(np.float32)
                                ).to(torch.bfloat16) for h in (Hq, Hkv, Hkv))
    o = ref.attention_ref(q, k, v, causal=causal)
    do = torch.from_numpy(rng.normal(size=(B, S, Hq, D)).astype(np.float32)
                          ).to(torch.bfloat16)
    got = flash_bwd_schedule(q, k, v, o, do, causal)
    want = ref.attention_bwd_ref(*(x.double() for x in (q, k, v, o, do)),
                                 causal=causal)
    top = max(w.abs().max().item() for w in want)
    for g, w in zip(got, want):
        assert g.dtype == torch.bfloat16
        assert chip_smoke.bwd_excess(g, w, top) <= chip_smoke.BWD_EXCESS / 10


def test_flash_bwd_padding_rows_write_nothing():
    """The schedule writes rows 0 .. S-1 only, whatever the tiles cover: a
    ragged S gives the plain version's gradient with no tail garbage."""
    rng = np.random.default_rng(5)
    q, k, v = (torch.from_numpy(rng.normal(size=(1, 65, h, 16)).astype(np.float32))
               for h in (2, 1, 1))
    o = ref.attention_ref(q, k, v, causal=True)
    do = torch.from_numpy(rng.normal(size=(1, 65, 2, 16)).astype(np.float32))
    for g, w in zip(flash_bwd_schedule(q, k, v, o, do, True),
                    ref.attention_bwd_ref(q, k, v, o, do, causal=True)):
        assert g.shape == w.shape and torch.isfinite(g).all()
        assert (g - w).abs().max() <= 1e-5


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


def decode_schedule(q, kc, vc, lengths, arrival=None):
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
    order. Every counter must be back at 0 at the end."""
    B, Smax, Hkv, D = kc.shape
    G = q.shape[1] // Hkv
    bf16 = q.dtype == torch.bfloat16
    splits, chunk = plan_splits(Smax)
    scale = np.float32(1.0 / math.sqrt(D))
    qf = q.float().reshape(B, Hkv, G, D)
    out = torch.zeros(B, Hkv, G, D)
    exp = torch.exp2 if bf16 else torch.exp    # m's units
    garbage = (torch.full((G,), math.nan), torch.full((G,), math.nan),
               torch.full((G, D), math.nan))

    def fold(b, hk, sp, n):
        m = torch.full((G,), NEG)
        l = torch.zeros(G)
        acc = torch.zeros(G, D)
        begin, end = sp * chunk, min(sp * chunk + chunk, n)
        step = chunk if bf16 else TILE   # bf16: the chunk in one pass
        for t0 in range(begin, end, step):
            t1 = min(t0 + step, end)
            kt = kc[b, t0:t1, hk].float()
            vt = vc[b, t0:t1, hk].float()
            s = qf[b, hk] @ kt.T
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

    for b in range(B):
        n = min(max(int(lengths[b]), 0), Smax)
        live = -(-n // chunk)
        for hk in range(Hkv):
            if live == 0:
                continue            # zeros
            if live == 1:
                m, l, acc = fold(b, hk, 0, n)
                out[b, hk] = acc / torch.clamp(l, min=1e-30)[:, None]
                continue
            groups = -(-live // FAN_IN)
            slots = [garbage] * splits
            second = [garbage] * groups
            counters = [0] * (1 + groups)     # [second level, groups...]
            result = None
            order = list(range(live)) if arrival is None else arrival(live)
            for sp in order:
                slots[sp] = fold(b, hk, sp, n)
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
            out[b, hk] = A / torch.clamp(L, min=1e-30)[:, None]
    return out.reshape(B, Hkv * G, D).to(q.dtype)


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
