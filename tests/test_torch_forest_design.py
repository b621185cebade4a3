"""The schedules of the two forest kernels, on the CPU.

The CUDA kernels run only on a card (``chip_smoke.py`` holds them against
their plain versions there). What their designs do is held here, in plain
PyTorch that follows each kernel's schedule step by step:

- ``topk_sim``: the plan (``plan_splits``): 32-query blocks, splits of whole
  64-key tiles below ``num_valid``, a cluster of C blocks over slices of D.
  Every score is summed over its rank's slice in d order, one rounding per
  multiply-add (an FMA, emulated in float64), and the slices' sums are
  added in rank order. A row's sorted list lives on 32 lanes: a ballot
  against the k-th score skips a tile, a few keys above it are inserted one
  by one, more go through a bitonic sort of the tile's 64 (score, index)
  pairs under the two-key order and two bitonic merges. Each split writes
  its list and takes a ticket; the last block of a (query block, rank)
  merges the lists in split order.
- ``tree_refresh``: the plan (``plan``), the masked sum over k, the division
  by cnt, each rank's sum of squares over its slice, the rank sums added in
  rank order, the division by (norm + 1e-6).
- ``browse_scores``: the plan (a warp per entry up to ``WARP_MAX_D``, a team
  of ``TEAM`` warps over slices of D above), each lane's chain of FMAs over
  its columns lane + 32 j (float4s, or floats where D % 4 != 0), the 8
  slots' partials reduced across the warp by the reduce-scatter butterfly
  (lane l ends with slot bitrev3(l & 7)), the team's sums added in warp
  order, padded rows exactly 0.

Each schedule is held against the port's plain version
(``repro_torch.kernels.ref``) and the JAX package (``impl="reference"`` and
``"pallas_interpret"``) with ``chip_smoke.py``'s tolerances: 1e-5 on values
and node rows, indices exact where the plain scores lie more than 1e-5
apart, planted ties bitwise equal and ordered by index. Inputs come from
numpy with fixed seeds.
"""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels import ops as jax_ops
from repro_torch.kernels import ref
from repro_torch.kernels._build import tma_ready
from repro_torch.kernels.browse_scores import SLOTS, TEAM
from repro_torch.kernels.browse_scores import WARP_MAX_D as BROWSE_WARP_MAX_D
from repro_torch.kernels.browse_scores import plan as browse_plan
from repro_torch.kernels.topk_sim import (KEY_TILE, MAX_CLUSTER, MAX_SPLITS,
                                          QUERY_BLOCK, SLICE, plan_splits)
from repro_torch.kernels.tree_refresh import BLOCK_COLS, WARP_MAX_D
from repro_torch.kernels.tree_refresh import MAX_CLUSTER as REFRESH_MAX_CLUSTER
from repro_torch.kernels.tree_refresh import plan as refresh_plan

LANES = torch.arange(32)
DEAD = 2 ** 31 - 1          # index of an empty entry: it ranks last
INF = float("inf")
SMS = 132                   # an H100 SXM
INSERT = 8                  # at most this many keys above the k-th: inserted
STAGE = 32                  # depth of one ring stage
WARPS = 4                   # warps of a block; with split_k each sums a quarter of a stage


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _unit(rng, *shape):
    x = rng.normal(size=shape).astype(np.float32)
    return x / np.linalg.norm(x, axis=-1, keepdims=True)


def _pad4(x):
    """Zero columns up to a multiple of 4, as the wrappers pad rows."""
    return torch.nn.functional.pad(x, (0, -x.shape[-1] % 4))


# ---------------------------------------------------------------------------
# topk_sim: the selection network on 32 lanes (rows vectorised)
# ---------------------------------------------------------------------------
def before(v, i, bv, bi):
    """(v, i) ranks before (bv, bi): score desc, then index asc."""
    return (v > bv) | ((v == bv) & (i < bi))


def exchange(v, i, stride, keep_first):
    """Each lane against lane ^ stride; keep the entry that ranks first where
    ``keep_first``, else the other."""
    p = LANES ^ stride
    ov, oi = v[:, p], i[:, p]
    take = before(ov, oi, v, i) == keep_first
    return torch.where(take, ov, v), torch.where(take, oi, i)


def sort32(v, i):
    size = 2
    while size <= 32:
        stride = size // 2
        while stride:
            first = ((LANES & size) == 0) == ((LANES & stride) == 0)
            v, i = exchange(v, i, stride, first)
            stride //= 2
        size *= 2
    return v, i


def merge(v, i, w, j):
    """Sorted (v, i) <- the best 32 of itself and sorted (w, j)."""
    rw, rj = w[:, 31 - LANES], j[:, 31 - LANES]
    t = before(rw, rj, v, i)
    v, i = torch.where(t, rw, v), torch.where(t, rj, i)
    for stride in (16, 8, 4, 2, 1):
        v, i = exchange(v, i, stride, (LANES & stride) == 0)
    return v, i


def insert(v, i, cv, ci):
    """One row's sorted list with (cv, ci) at its place; the last entry
    drops out."""
    pos = int(before(v, i, cv, ci).sum())
    if pos < 32:
        v = torch.cat([v[:pos], cv.view(1), v[pos:-1]])
        i = torch.cat([i[:pos], ci.view(1), i[pos:-1]])
    return v, i


def fold(lv, li, a, ia, b, ib, k, network_only=False):
    """One tile row (64 keys after every key of the list) into the list: the
    ballot against the k-th score; up to ``INSERT`` keys above it inserted
    one by one, more through the network (sort, two merges)."""
    nv, ni = sort32(a, ia)
    wb, jb = sort32(b, ib)
    nv, ni = merge(nv, ni, wb, jb)
    nv, ni = merge(lv, li, nv, ni)
    if network_only:
        return nv, ni
    kth = lv[:, k - 1:k]
    ca, cb = a > kth, b > kth
    n = ca.sum(1) + cb.sum(1)
    many = (n > INSERT)[:, None]
    out_v, out_i = torch.where(many, nv, lv), torch.where(many, ni, li)
    for r in torch.nonzero((n > 0) & (n <= INSERT)).flatten().tolist():
        v, i = lv[r], li[r]
        for x, ix, c in ((a, ia, ca), (b, ib, cb)):
            for lane in torch.nonzero(c[r]).flatten().tolist():
                v, i = insert(v, i, x[r, lane], ix[r, lane])
        out_v[r], out_i[r] = v, i
    return out_v, out_i


def fma_chain(q, keys, ds):
    """Partial scores: a chain of FMAs over the columns ``ds`` in order, each
    rounded once to f32 (the product is exact in float64)."""
    acc = torch.zeros(q.shape[0], keys.shape[0], dtype=torch.float32)
    qd, kd = q.double(), keys.double()
    for d in ds:
        acc = (acc.double() + qd[:, d:d + 1] * kd[None, :, d]).float()
    return acc


def schedule_scores(q, keys, cluster, slice_, split_k):
    """Scores as the kernel sums them. Rank r owns the slice [r slice,
    (r + 1) slice) of D, cut into stages of ``STAGE``. Without ``split_k``
    one chain runs over the slice in d order; with it, warp w of the rank's
    block sums columns 8 w .. 8 w + 7 of each stage, stage after stage. The
    partial sums are added in (rank, warp) order."""
    D = q.shape[1]
    total = None
    for r in range(cluster):
        lo, hi = r * slice_, min(D, (r + 1) * slice_)
        for w in range(WARPS if split_k else 1):
            ds = ([d for s0 in range(lo, hi, STAGE)
                   for d in range(s0 + 8 * w, min(s0 + 8 * w + 8, hi))]
                  if split_k else range(lo, hi))
            p = fma_chain(q, keys, ds)
            total = p if total is None else total + p
    return total


def topk_schedule(q, keys, k, nv, sms=SMS, network_only=False, arrival=None):
    """The kernel's answer: (Q, k) values and indices, -1e30 / -1 in dead
    slots. ``arrival`` orders the splits' tickets (default: split order)."""
    Q, N = q.shape[0], keys.shape[0]
    k = min(k, N)
    q, keys = _pad4(q.float()), _pad4(keys.float())
    D = q.shape[1]
    per_split, splits, cluster, slice_, split_k = plan_splits(Q, nv, D, sms)
    scores = schedule_scores(q, keys[:nv], cluster, slice_, split_k)
    lists = []
    for sp in range(splits):
        kb0, ke = sp * per_split, min((sp + 1) * per_split, nv)
        lv = torch.full((Q, 32), -INF)
        li = torch.full((Q, 32), DEAD, dtype=torch.int64)
        for kb in range(kb0, ke, KEY_TILE):
            cols = torch.arange(kb, kb + KEY_TILE)
            live = cols < ke
            s = torch.full((Q, KEY_TILE), -INF)
            s[:, live] = scores[:, cols[live]]
            ix = torch.where(live, cols, torch.full_like(cols, DEAD))
            ix = ix.expand(Q, KEY_TILE)
            lv, li = fold(lv, li, s[:, :32], ix[:, :32], s[:, 32:], ix[:, 32:],
                          k, network_only)
        lists.append((lv[:, :k], li[:, :k]))
    # tickets: every split takes one from each (query block, rank) counter;
    # the one that draws the last merges and sets the counter back to 0
    order = list(range(splits)) if arrival is None else list(arrival)
    counters = np.zeros((-(-Q // QUERY_BLOCK), cluster), int)
    merger = np.full(counters.shape, -1)
    for sp in order:
        merger[counters == splits - 1] = sp
        counters += 1
        counters[counters == splits] = 0
    assert (merger == order[-1]).all() and not counters.any()
    v = torch.full((Q, 32), -INF)
    i = torch.full((Q, 32), DEAD, dtype=torch.int64)
    for w, j in lists:                                   # split order
        w = torch.cat([w, torch.full((Q, 32 - k), -INF)], 1)
        j = torch.cat([j, torch.full((Q, 32 - k), DEAD, dtype=torch.int64)], 1)
        hit = w[:, :1] > v[:, k - 1:k]
        mv, mi = merge(v, i, w, j)
        v, i = torch.where(hit, mv, v), torch.where(hit, mi, i)
    val = torch.where(i[:, :k] == DEAD, torch.full((Q, k), -1e30), v[:, :k])
    idx = torch.where(val > -1e29, i[:, :k], torch.full_like(i[:, :k], -1))
    return val, idx.to(torch.int32)


def assert_topk(v, i, q, keys, k, nv, ties=(), what=""):
    """chip_smoke.py's criterion against the plain version."""
    N = keys.shape[0]
    k = min(k, N)
    pv, _ = ref.topk_sim_ref(q, keys, min(k + 1, N), normalize=False,
                             num_valid=nv)
    pvk, pik = ref.topk_sim_ref(q, keys, k, normalize=False, num_valid=nv)
    live = pvk > -1e29
    if live.any():
        assert (v - pvk).abs()[live].max().item() <= 1e-5, what
    assert (v[~live] == -1e30).all() and (i[~live] == -1).all(), what
    gap_prev = torch.full_like(pvk, INF)
    gap_prev[:, 1:] = (pvk[:, 1:] - pvk[:, :-1]).abs()
    gap_next = torch.full_like(pvk, INF)
    nxt = pv[:, 1:k + 1]
    gap_next[:, : nxt.shape[1]] = (pvk[:, : nxt.shape[1]] - nxt).abs()
    firm = (gap_prev > 1e-5) & (gap_next > 1e-5)
    assert not ((i != pik) & firm).any(), what
    for qi, pair in ties:
        assert i[qi, :2].tolist() == pair, what
        assert v[qi, 0].item() == v[qi, 1].item(), what
    assert not (i >= nv).any(), f"{what}: a key at or past num_valid"


def topk_inputs(seed, Q, N, D, nv, plant):
    """Unit rows from numpy; with ``plant``, exact ties (two equal key rows
    equal to a query): the pair in one tile, in two splits (and so two
    clusters), at num_valid - 1 with a copy at num_valid, which is masked."""
    rng = np.random.default_rng(seed)
    keys, q = _unit(rng, N, D), _unit(rng, Q, D)
    ties = []
    if plant:
        for qi, a, b in [(0, 5, 6), (1, 17, N // 2 + 3), (2, 100, nv - 1)][:min(Q, 3)]:
            keys[a] = keys[b] = q[qi]
            ties.append((qi, sorted((a, b))))
        if nv < N and Q > 3:
            keys[nv] = q[3]
    return _t(q), _t(keys), ties


TOPK_CASES = [
    # Q, N, D, k, num_valid, plant
    (64, 1024, 256, 24, 675, True),     # the slice's root recall, cut nothing
    (64, 256, 256, 16, 210, True),      # the slice's fact recall
    (40, 512, 256, 32, 500, True),      # Q not a multiple of 32, clusters of 8
    (8, 300, 36, 1, 299, False),        # k = 1, D = 36 (whole float4s: unpadded)
    (5, 200, 8, 16, 9, False),          # num_valid < k, D = 8
    (33, 700, 32, 24, 601, True),       # num_valid not a multiple of 64
    (3, 130, 16, 32, 0, False),         # no valid key: every slot dead
]


@pytest.mark.parametrize("Q,N,D,k,nv,plant", TOPK_CASES)
def test_topk_schedule_matches_the_plain_version(Q, N, D, k, nv, plant):
    q, keys, ties = topk_inputs(Q + N + D, Q, N, D, nv, plant)
    v, i = topk_schedule(q, keys, k, nv)
    assert_topk(v, i, q, keys, k, nv, ties, f"{Q}x{N}x{D} k={k}")


def test_topk_schedule_at_4096_with_ties_across_clusters():
    """D = 4096 at a small Q and N: a cluster of 8 ranks of 512; the planted
    pair (17, 131) lies in two splits, so two clusters sum it."""
    Q, N, D, k, nv = 4, 256, 4096, 24, 250
    per_split, splits, cluster, slice_, split_k = plan_splits(Q, nv, D, SMS)
    assert (cluster, slice_, split_k) == (8, 512, True) and splits == 4
    assert 17 // per_split != (N // 2 + 3) // per_split
    q, keys, ties = topk_inputs(7, Q, N, D, nv, True)
    v, i = topk_schedule(q, keys, k, nv)
    assert_topk(v, i, q, keys, k, nv, ties, "4096")
    for impl in ("reference", "pallas_interpret"):
        jv, ji = jax_ops.topk_sim(jnp.asarray(q.numpy()), jnp.asarray(keys.numpy()), k,
                                  normalize=False, num_valid=jnp.int32(nv), impl=impl)
        np.testing.assert_allclose(v.numpy(), np.asarray(jv), atol=1e-5)
        assert [np.asarray(ji)[qi, :2].tolist() for qi, _ in ties] == \
            [pair for _, pair in ties]


@pytest.mark.parametrize("k", [1, 16, 24, 32])
@pytest.mark.parametrize("impl", ["reference", "pallas_interpret"])
def test_topk_schedule_matches_the_jax_package(k, impl):
    Q, N, D, nv = 40, 600, 256, 577
    q, keys, ties = topk_inputs(k, Q, N, D, nv, True)
    v, i = topk_schedule(q, keys, k, nv)
    jv, ji = jax_ops.topk_sim(jnp.asarray(q.numpy()), jnp.asarray(keys.numpy()), k,
                              normalize=False, num_valid=jnp.int32(nv), impl=impl)
    np.testing.assert_allclose(v.numpy(), np.asarray(jv), atol=1e-5)
    # indices exact where the JAX scores lie more than 1e-5 apart
    jv = np.asarray(jv)
    apart = np.ones_like(jv, bool)
    apart[:, 1:] &= np.abs(np.diff(jv, axis=1)) > 1e-5
    apart[:, :-1] &= np.abs(np.diff(jv, axis=1)) > 1e-5
    assert (i.numpy() == np.asarray(ji))[apart].all()
    for qi, pair in ties:
        assert np.asarray(ji)[qi, :2].tolist() == pair[:k] == i[qi, :2].tolist()


@pytest.mark.parametrize("cluster,slice_,split_k", [(8, 32, False), (1, 256, True),
                                                  (2, 128, True), (4, 64, False)])
def test_duplicates_score_bitwise_equal_wherever_they_fall(cluster, slice_, split_k):
    """One key row copied into every tile position and split: each cut's
    sums give every copy the same bits."""
    rng = np.random.default_rng(3)
    keys = _unit(rng, 512, 256)
    keys[:] = keys[0]
    s = schedule_scores(_t(_unit(rng, 4, 256)), _t(keys), cluster, slice_, split_k)
    assert (s == s[:, :1]).all()


def test_the_network_sorts_under_the_two_key_order():
    rng = np.random.default_rng(4)
    v = _t(rng.integers(0, 4, size=(64, 32)).astype(np.float32))   # many ties
    i = _t(rng.permutation(64 * 32).reshape(64, 32).astype(np.int64))
    v[:5, -4:], i[:5, -4:] = -INF, DEAD                              # empty entries
    sv, si = sort32(v, i)
    want_v, want_i = ref.merge_topk(v, torch.where(i == DEAD, -1, i), 32)
    assert torch.equal(sv[sv > -INF], want_v[want_v > -1e29])
    assert torch.equal(si[sv > -INF], want_i[want_v > -1e29])


def test_merge_keeps_the_best_32_of_two_lists():
    rng = np.random.default_rng(5)
    a = _t(rng.integers(0, 6, size=(32, 32)).astype(np.float32))
    b = _t(rng.integers(0, 6, size=(32, 32)).astype(np.float32))
    ia = _t(rng.permutation(32 * 64)[: 32 * 32].reshape(32, 32).astype(np.int64))
    ib = _t((32 * 64 + rng.permutation(32 * 32)).reshape(32, 32).astype(np.int64))
    a, ia = sort32(a, ia)
    b, ib = sort32(b, ib)
    v, i = merge(a, ia, b, ib)
    want_v, want_i = ref.merge_topk(torch.cat([a, b], 1), torch.cat([ia, ib], 1), 32)
    assert torch.equal(v, want_v) and torch.equal(i, want_i)


def test_the_ballot_and_the_insertions_change_nothing():
    """Skipping tiles with no key above the k-th score and inserting a few
    keys one by one give the same answer as the network on every tile."""
    q, keys, _ = topk_inputs(6, 16, 4096, 16, 4000, False)
    for k in (1, 16, 32):
        assert all(torch.equal(x, y) for x, y in zip(
            topk_schedule(q, keys, k, 4000),
            topk_schedule(q, keys, k, 4000, network_only=True)))


def test_insert_keeps_the_list_sorted():
    rng = np.random.default_rng(9)
    v = _t(np.sort(rng.integers(0, 5, size=32).astype(np.float32))[::-1].copy())
    i = _t(np.arange(32, dtype=np.int64))
    v, i = sort32(v[None], i[None])
    v, i = v[0], i[0]
    for cv, ci in ((2.0, 40), (4.0, 41), (-1.0, 42), (2.0, 3)):
        v, i = insert(v, i, torch.tensor(cv), torch.tensor(ci))
        want_v, want_i = ref.merge_topk(v[None], i[None], 32)
        assert torch.equal(v, want_v[0]) and torch.equal(i, want_i[0])


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_the_merge_is_the_same_whatever_split_finishes_last(seed):
    q, keys, _ = topk_inputs(8, 8, 2048, 8, 2000, False)
    _, splits, _, _, _ = plan_splits(8, 2000, 8, SMS)
    assert splits > 1
    order = np.random.default_rng(seed).permutation(splits).tolist()
    got = topk_schedule(q, keys, 24, 2000, arrival=order)
    want = topk_schedule(q, keys, 24, 2000)
    assert all(torch.equal(x, y) for x, y in zip(got, want))


@pytest.mark.parametrize("Q,nv,D,cluster,splits,split_k", [
    (64, 1024, 256, 8, 16, False),     # the main row: 256 blocks
    (64, 675, 256, 8, 11, False),      # the slice's roots: 176 blocks
    (64, 210, 256, 8, 4, False),       # the slice's facts: 64 blocks
    (32, 1024, 4096, 8, 16, True),     # the serve phase's D: 128 blocks
    (64, 262143, 256, 1, 128, True),   # stress: keys alone fill the card
    (1, 262143, 256, 1, 256, True),
    (200, 262143, 256, 1, 37, True),
    (64, 1024, 36, 1, 16, False),      # D too narrow to split
])
def test_plan_fills_the_card(Q, nv, D, cluster, splits, split_k):
    per_split, n, c, slice_, sk = plan_splits(Q, nv, D, SMS)
    assert (c, n, sk) == (cluster, splits, split_k)
    assert c * slice_ >= D and (c - 1) * slice_ < D and slice_ % 4 == 0
    assert c == 1 or slice_ >= SLICE
    assert per_split % KEY_TILE == 0 and per_split * n >= nv > per_split * (n - 1)
    assert c <= MAX_CLUSTER and n <= MAX_SPLITS


# ---------------------------------------------------------------------------
# tree_refresh
# ---------------------------------------------------------------------------
def refresh_schedule(emb, mask):
    """The kernel's arithmetic: FMAs over k in order, / cnt, each rank's
    squares over its slice, the rank sums in rank order, / (norm + 1e-6)."""
    P, K, D = emb.shape
    e = _pad4(emb.float())
    Dp = e.shape[2]
    cluster, slice_ = refresh_plan(Dp)
    s = torch.zeros(P, Dp)
    for kk in range(K):
        s = (s.double() + e[:, kk].double() * mask[:, kk:kk + 1].double()).float()
    cnt = torch.clamp(mask.float().sum(1, keepdim=True), min=1.0)
    mean = s / cnt
    parts = [(mean[:, r * slice_:(r + 1) * slice_] ** 2).sum(1, keepdim=True)
             for r in range(cluster)]
    total = parts[0]
    for p in parts[1:]:
        total = total + p
    return (mean / (torch.sqrt(total) + 1e-6))[:, :D]


REFRESH_CASES = [
    # P, K, D: the slice's launches, the serve phase's D, stress-like K,
    # D = 36 and 38 (padded), odd cluster slices, phi3-mini's width (a
    # cluster of 4), slices wider than one pass of a block, one child
    (128, 8, 256), (16, 8, 256), (4, 8, 256), (8, 8, 4096), (6, 16, 256),
    (5, 3, 36), (4, 2, 38), (7, 16, 1028), (3, 8, 3584), (3, 4, 3072),
    (2, 3, 36004), (2, 1, 8),
]


@pytest.mark.parametrize("P,K,D", REFRESH_CASES)
def test_refresh_schedule_matches_both_packages(P, K, D):
    rng = np.random.default_rng(P * 31 + K + D)
    emb = _unit(rng, P, K, D)
    cnt = rng.integers(0, K + 1, size=P)
    cnt[0] = 0                                     # a parent with no child
    mask = (np.arange(K)[None, :] < cnt[:, None]).astype(np.float32)
    out = refresh_schedule(_t(emb), _t(mask))
    np.testing.assert_allclose(out.numpy(), ref.tree_refresh_ref(_t(emb), _t(mask)).numpy(),
                               atol=1e-5)
    for impl in ("reference", "pallas_interpret"):
        want = np.asarray(jax_ops.tree_refresh(jnp.asarray(emb), jnp.asarray(mask), impl=impl))
        np.testing.assert_allclose(out.numpy(), want, atol=1e-5)
    assert (out[torch.from_numpy(cnt == 0)] == 0).all(), "no child: an exact zero row"


@pytest.mark.parametrize("D,cluster", [(8, 1), (256, 1), (260, 1), (1024, 1), (1028, 2),
                                       (2560, 4), (3072, 4), (3584, 4), (4096, 4),
                                       (5120, 8), (6144, 8), (8192, 8), (36004, 8)])
def test_refresh_plan_covers_every_column(D, cluster):
    c, slice_ = refresh_plan(D)
    assert c == cluster
    assert c in (1, 2, 4, 8), "the C entry takes clusters of 1, 2, 4 or 8 blocks"
    if D <= WARP_MAX_D:
        assert slice_ == D
    elif c < REFRESH_MAX_CLUSTER:
        assert slice_ <= BLOCK_COLS, "a slice of at most a float4 a thread"
    assert slice_ % 4 == 0
    assert c * slice_ >= D and (c - 1) * slice_ < D


def test_forest_rows_of_whole_float4s_go_in_uncopied():
    """The forest kernels load float4s: their wrappers pad rows to a
    multiple of 4 floats, not to the tensor maps' 8, so D % 8 == 4 costs no
    copy."""
    x = torch.zeros(5, 36)
    assert tma_ready(x, align=4) is x
    y = tma_ready(torch.ones(5, 38), align=4)
    assert y.shape == (5, 40) and bool((y[:, 38:] == 0).all())


# ---------------------------------------------------------------------------
# browse_scores
# ---------------------------------------------------------------------------
LANE = np.arange(32)


def bitrev3(x):
    return ((x & 1) << 2) | (x & 2) | ((x >> 2) & 1)


def reduce_scatter(acc):
    """The warp's reduce-scatter of ``SLOTS`` partials a lane, acc (F, SLOTS,
    32) f32 -> (F, SLOTS): steps 1, 2 and 4 lanes apart each keep half of the
    slots (the upper half where the lane's bit is set) and add the partner's
    value; then two sums 8 and 16 lanes apart. Lane l holds slot
    bitrev3(l & 7), and so do lanes l + 8, l + 16 and l + 24."""
    v = acc.transpose(0, 2, 1).copy()               # (F, lane, slot)
    n, off = SLOTS // 2, 1
    while n >= 1:
        up = ((LANE & off) != 0)[None, :, None]
        send = np.where(up, v[:, :, :n], v[:, :, n:2 * n])
        keep = np.where(up, v[:, :, n:2 * n], v[:, :, :n])
        v = v[:, :, :n].copy()
        v[:] = keep + send[:, LANE ^ off]
        n, off = n // 2, off * 2
    r = v[:, :, 0]
    r = r + r[:, LANE ^ 8]
    r = r + r[:, LANE ^ 16]
    assert (r[:, :8] == r[:, 8:16]).all() and (r[:, :8] == r[:, 24:]).all()
    out = np.empty((acc.shape[0], SLOTS), np.float32)
    out[:, bitrev3(LANE[:8])] = r[:, :8]
    return out


def browse_schedule(arena, rows, q_rows, lane_of, mask):
    """The kernel's arithmetic, numpy f32 (one rounding per FMA, emulated in
    float64): arena (R, D), rows (F, K) with -1 in padded slots, q_rows (L,
    D), lane_of (F,), mask (F, K) -> (F, K)."""
    F, K = rows.shape
    D = arena.shape[1]
    unit = 4 if D % 4 == 0 else 1                  # float4 or float columns
    n = D // unit
    team = browse_plan(D)
    per = -(-n // team)
    child = np.where(rows[..., None] >= 0, arena[np.maximum(rows, 0)],
                     np.float32(0))                # a padded slot loads nothing
    q = q_rows[lane_of].astype(np.float64)[:, None, :]
    out = np.zeros((F, K), np.float32)
    for k0 in range(0, K, SLOTS):
        ks = [k for k in range(k0, k0 + SLOTS) if k < K]
        c = np.zeros((F, SLOTS, D))
        c[:, :len(ks)] = child[:, ks]
        total = None
        for w in range(team):
            c0, c1 = w * per, min(w * per + per, n)
            acc = np.zeros((F, SLOTS, 32), np.float32)
            for i0 in range(c0, c1, 32):
                cols = i0 + LANE                   # column lane + 32 j
                live = cols < c1
                for e in range(unit):
                    d = np.minimum(cols * unit + e, D - 1)
                    prod = np.where(live, c[:, :, d] * q[:, :, d], 0.0)
                    acc = (acc + prod).astype(np.float32)
            part = reduce_scatter(acc)
            total = part if total is None else total + part
        out[:, ks] = total[:, :len(ks)]
    return np.where(rows >= 0, out * mask, np.float32(0))


BROWSE_CASES = [
    # F, K, D: K = 4, 8, 16 a warp an entry; D = 260 (65 float4: lanes
    # uneven), 7 and 514 (floats), a team of 4 at 1028 (slices of 65
    # float4), 4096 (the serve phase's width) with K = 8 and 16
    (8, 4, 256), (16, 8, 256), (5, 16, 256), (6, 8, 260), (5, 4, 7),
    (3, 8, 514), (4, 8, 1028), (3, 8, 4096), (3, 16, 4096),
]


def browse_inputs(seed, F, K, D):
    rng = np.random.default_rng(seed)
    R, L = 3 * F * K, 3
    arena, q_rows = _unit(rng, R, D), _unit(rng, L, D)
    rows = rng.integers(0, R, size=(F, K)).astype(np.int32)
    rows[0, K // 2:] = -1
    rows[-1] = -1                                  # an all-padded entry
    lane_of = rng.integers(0, L, size=F).astype(np.int32)
    mask = (rows >= 0).astype(np.float32)
    return arena, rows, q_rows, lane_of, mask


@pytest.mark.parametrize("F,K,D", BROWSE_CASES)
def test_browse_schedule_matches_both_packages(F, K, D):
    arena, rows, q_rows, lane_of, mask = browse_inputs(F * 13 + K + D, F, K, D)
    out = browse_schedule(arena, rows, q_rows, lane_of, mask)
    plain = ref.browse_scores_rows_ref(_t(arena), _t(rows), _t(q_rows),
                                       _t(lane_of), _t(mask)).numpy()
    np.testing.assert_allclose(out, plain, atol=2e-5)
    child = np.where(rows[..., None] >= 0, arena[np.maximum(rows, 0)], 0.0)
    args = (jnp.asarray(child, jnp.float32), jnp.asarray(q_rows[lane_of]),
            jnp.asarray(mask))
    for impl in ("reference", "pallas_interpret"):
        want = np.asarray(jax_ops.browse_scores(*args, impl=impl))
        np.testing.assert_allclose(out, want, atol=2e-5)
    assert (out[rows < 0] == 0).all() and not out[-1].any()


@pytest.mark.parametrize("K", [4, 8, 16])
@pytest.mark.parametrize("D", [256, 260, 7, 4096])
def test_browse_duplicates_score_bitwise_equal_wherever_they_fall(K, D):
    """One node's row, gathered in every slot of several entries, and copies
    of it at other arena rows: every slot scores the same bits, in the
    gather form and in the packed form (an arena of F*K rows)."""
    F = 5
    arena, rows, q_rows, _, _ = browse_inputs(K + D, F, K, D)
    arena[1:7] = arena[0]
    rows[:] = np.arange(F * K).reshape(F, K) % 7   # rows 0-6: one node's row
    lane_of = np.zeros(F, np.int32)
    mask = np.ones((F, K), np.float32)
    out = browse_schedule(arena, rows, q_rows, lane_of, mask)
    assert (out == out[0, 0]).all()
    packed = browse_schedule(arena[rows].reshape(F * K, D),
                             np.arange(F * K, dtype=np.int32).reshape(F, K),
                             q_rows[lane_of], np.arange(F, dtype=np.int32), mask)
    assert (packed == out[0, 0]).all()


def test_reduce_scatter_puts_slot_bitrev3_on_its_lanes():
    """Partials of whole numbers sum exactly, so each slot's total shows which
    slot a lane ended with."""
    acc = (1000 * np.arange(SLOTS)[:, None] + LANE[None, :]).astype(np.float32)
    out = reduce_scatter(acc[None])[0]
    assert out.tolist() == [1000 * 32 * s + LANE.sum() for s in range(SLOTS)]


@pytest.mark.parametrize("D,team", [(7, 1), (256, 1), (260, 1), (512, 1),
                                    (514, TEAM), (4096, TEAM), (36004, TEAM)])
def test_browse_plan_is_a_function_of_d(D, team):
    assert browse_plan(D) == team
    assert (team == 1) == (D <= BROWSE_WARP_MAX_D)

