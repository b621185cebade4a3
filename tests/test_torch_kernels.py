"""The port's kernel wrappers, run on CPU tensors (their plain PyTorch
versions), against the JAX package's oracles (``repro.kernels.ref``) and its
Pallas kernels in interpret mode. Tolerances are those of
tests/test_kernels.py; top-k indices must match exactly, ties included.

The CUDA kernels themselves cannot run here; ``chip_smoke.py`` holds each of
them against the same plain versions on the card."""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels import ops as jax_ops
from repro.kernels import ref as jax_ref
from repro.kernels.topk_sim import merge_topk as jax_merge_topk
from repro_torch import kernels
from repro_torch.kernels import ops, ref
from repro_torch.kernels.topk_sim import (KEY_TILE, MAX_K, MAX_SPLITS,
                                          plan_splits)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _unit(rng, *shape):
    x = rng.normal(size=shape).astype(np.float32)
    return x / np.linalg.norm(x, axis=-1, keepdims=True)


# ---------------------------------------------------------------------------
# tree_refresh
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("P,K,D", [(1, 4, 8), (8, 8, 256), (5, 3, 16),
                                   (16, 16, 64)])
def test_tree_refresh(P, K, D):
    rng = np.random.default_rng(P * 100 + K)
    emb = _unit(rng, P, K, D)
    cnt = rng.integers(0, K + 1, size=P)
    cnt[0] = 0                                   # a parent with no children
    mask = (np.arange(K)[None, :] < cnt[:, None]).astype(np.float32)
    before = kernels.COUNTS["tree_refresh"].plain_calls
    out = ops.tree_refresh(_t(emb), _t(mask)).numpy()
    assert kernels.COUNTS["tree_refresh"].plain_calls == before + 1
    want = np.asarray(jax_ref.tree_refresh_ref(jnp.asarray(emb),
                                               jnp.asarray(mask)))
    pal = np.asarray(jax_ops.tree_refresh(jnp.asarray(emb), jnp.asarray(mask),
                                          impl="pallas_interpret"))
    np.testing.assert_allclose(out, want, atol=1e-5)
    np.testing.assert_allclose(out, pal, atol=1e-5)
    assert not out[0].any(), "no children -> zero row"


# ---------------------------------------------------------------------------
# browse_scores
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("F,K,D", [(8, 4, 256), (16, 8, 32), (3, 5, 7)])
def test_browse_scores(F, K, D):
    rng = np.random.default_rng(F + K + D)
    child = _unit(rng, F, K, D)
    q = _unit(rng, F, D)
    mask = (rng.random((F, K)) < 0.6).astype(np.float32)
    out = ops.browse_scores(_t(child), _t(q), _t(mask)).numpy()
    args = (jnp.asarray(child), jnp.asarray(q), jnp.asarray(mask))
    np.testing.assert_allclose(out, np.asarray(jax_ref.browse_scores_ref(*args)),
                               atol=2e-5)
    np.testing.assert_allclose(
        out, np.asarray(jax_ops.browse_scores(*args, impl="pallas_interpret")),
        atol=2e-5)
    assert np.all(out[mask == 0] == 0), "padded slots score exactly 0"


def _browse_rows_inputs(rng, F, K, D, R, L):
    """A gather-form call: padded slots (-1), an all-padded entry, a real row
    masked, and one arena row in three slots of three entries."""
    arena = _unit(rng, R, D)
    q_rows = _unit(rng, L, D)
    rows = rng.integers(0, R, size=(F, K)).astype(np.int32)
    rows[1, K // 2:] = -1
    rows[-1] = -1
    rows[2, 0] = rows[3, 1] = rows[0, K - 1]
    lane_of = rng.integers(0, L, size=F).astype(np.int32)
    mask = (rows >= 0).astype(np.float32)
    mask[4, 0] = 0.0
    return arena, rows, q_rows, lane_of, mask


@pytest.mark.parametrize("F,K,D", [(8, 4, 256), (16, 8, 256), (8, 16, 256),
                                   (6, 8, 260), (9, 16, 260), (8, 4, 7)])
def test_browse_scores_rows(F, K, D):
    """The gather form against the JAX package's browse_scores (reference
    and interpret mode) on the packed equivalent of the same call."""
    rng = np.random.default_rng(F * 7 + K + D)
    arena, rows, q_rows, lane_of, mask = _browse_rows_inputs(
        rng, F, K, D, R=2 * F * K + 5, L=3)
    before = kernels.COUNTS["browse_scores"].plain_calls
    out = ops.browse_scores_rows(_t(arena), _t(rows), _t(q_rows), _t(lane_of),
                                 _t(mask)).numpy()
    assert kernels.COUNTS["browse_scores"].plain_calls == before + 1
    child = np.where(rows[..., None] >= 0, arena[np.maximum(rows, 0)], 0.0)
    args = (jnp.asarray(child), jnp.asarray(q_rows[lane_of]), jnp.asarray(mask))
    for impl in ("reference", "pallas_interpret"):
        want = np.asarray(jax_ops.browse_scores(*args, impl=impl))
        np.testing.assert_allclose(out, want, atol=2e-5)
    assert np.all(out[rows < 0] == 0) and not out[-1].any()
    assert out[4, 0] == 0, "a masked real row scores 0"
    packed = ops.browse_scores(_t(child.astype(np.float32)),
                               _t(q_rows[lane_of]), _t(mask)).numpy()
    np.testing.assert_allclose(out, packed, atol=2e-5)


def test_browse_scores_rows_refuses_what_it_does_not_take():
    arena, q = torch.zeros(10, 8), torch.zeros(3, 8)
    rows = torch.zeros(4, 2, dtype=torch.int32)
    lane_of, mask = torch.zeros(4, dtype=torch.int32), torch.zeros(4, 2)
    assert ops.browse_scores_rows(arena, rows, q, lane_of, mask).shape == (4, 2)
    before = kernels.COUNTS["browse_scores"].plain_calls
    bad_shapes = [
        (arena, rows, torch.zeros(3, 7), lane_of, mask),
        (arena, rows, q, torch.zeros(3, dtype=torch.int32), mask),
        (arena, rows, q, lane_of, torch.zeros(4, 3)),
        (arena, rows[None], q, lane_of, mask),
        (arena[0], rows, q, lane_of, mask),
    ]
    out_of_range = [
        (arena, torch.full((4, 2), 10, dtype=torch.int32), q, lane_of, mask),
        (arena, torch.full((4, 2), -2, dtype=torch.int32), q, lane_of, mask),
        (arena, rows, q, torch.full((4,), 3, dtype=torch.int32), mask),
        (arena, rows, q, torch.full((4,), -1, dtype=torch.int32), mask),
    ]
    off_the_cpu = [
        (torch.zeros(10, 8, device="meta"), rows, q, lane_of, mask),
        tuple(t.to("meta") for t in (arena, rows, q, lane_of, mask)),
    ]
    for args in bad_shapes + out_of_range + off_the_cpu:
        with pytest.raises(ValueError):
            ops.browse_scores_rows(*args)
    for wrong in (rows.long(), rows.float()):
        with pytest.raises(TypeError):
            ops.browse_scores_rows(arena, wrong, q, lane_of, mask)
    assert kernels.COUNTS["browse_scores"].plain_calls == before


# ---------------------------------------------------------------------------
# topk_sim
# ---------------------------------------------------------------------------
TOPK_CASES = [
    # Q, N, D, k, num_valid, normalize
    (4, 64, 32, 8, None, True),
    (3, 100, 16, 5, 37, False),
    (2, 40, 8, 16, 9, False),        # num_valid < k: dead slots
    (5, 300, 64, 32, 300, True),
    (1, 1, 8, 1, None, True),
]


@pytest.mark.parametrize("Q,N,D,k,nv,normalize", TOPK_CASES)
def test_topk_sim(Q, N, D, k, nv, normalize):
    rng = np.random.default_rng(Q * 1000 + N)
    scale = 1.0 if not normalize else 3.0
    q = rng.normal(size=(Q, D)).astype(np.float32) * scale
    keys = rng.normal(size=(N, D)).astype(np.float32)
    if not normalize:
        q = q / np.linalg.norm(q, axis=-1, keepdims=True)
        keys = keys / np.linalg.norm(keys, axis=-1, keepdims=True)
    v, i = ops.topk_sim(_t(q), _t(keys), k, normalize=normalize, num_valid=nv)
    assert v.dtype == torch.float32 and i.dtype == torch.int32
    assert v.shape == i.shape == (Q, min(k, N))
    nvj = None if nv is None else jnp.int32(nv)
    for impl in ("reference", "pallas_interpret"):
        jv, ji = jax_ops.topk_sim(jnp.asarray(q), jnp.asarray(keys), k,
                                  normalize=normalize, num_valid=nvj,
                                  impl=impl)
        np.testing.assert_allclose(v.numpy(), np.asarray(jv)[:, : v.shape[1]],
                                   atol=1e-5)
        np.testing.assert_array_equal(i.numpy(),
                                      np.asarray(ji)[:, : i.shape[1]])
    if nv is not None and nv < k:
        assert (i[:, nv:] == -1).all() and (v[:, nv:] == -1e30).all()


@pytest.mark.parametrize("copies", [2, 3, 5])
def test_topk_sim_exact_ties_order_by_index(copies):
    """Duplicated key rows score bitwise equal; they must come out by index
    ascending, as the JAX oracle and Pallas kernel order them."""
    rng = np.random.default_rng(copies)
    keys = _unit(rng, 50, 16)
    q = _unit(rng, 2, 16)
    spots = sorted(rng.choice(50, size=copies, replace=False).tolist())
    for s in spots:
        keys[s] = q[0]
    v, i = ops.topk_sim(_t(q), _t(keys), 8, normalize=False)
    assert i[0, :copies].tolist() == spots
    assert len(set(v[0, :copies].tolist())) == 1
    for impl in ("reference", "pallas_interpret"):
        jv, ji = jax_ops.topk_sim(jnp.asarray(q), jnp.asarray(keys), 8,
                                  normalize=False, impl=impl)
        np.testing.assert_array_equal(i.numpy(), np.asarray(ji))


def test_merge_topk_matches_jax():
    rng = np.random.default_rng(5)
    vals = rng.integers(0, 4, size=(3, 24)).astype(np.float32)   # many ties
    idx = rng.permutation(3 * 24).reshape(3, 24).astype(np.int32)
    vals[:, -3:] = ref.NEG_INF
    idx[:, -3:] = -1
    v, i = ref.merge_topk(_t(vals), _t(idx), 22)
    jv, ji = jax_merge_topk(jnp.asarray(vals), jnp.asarray(idx), 22)
    np.testing.assert_array_equal(v.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(i.numpy(), np.asarray(ji))


def test_topk_sim_rejects_what_the_kernel_does_not_take():
    q, keys = torch.zeros(2, 8), torch.zeros(10, 8)
    with pytest.raises(ValueError):
        ops.topk_sim(q, keys, MAX_K + 1)
    with pytest.raises(ValueError):
        ops.topk_sim(q, keys, 4, num_valid=11)
    with pytest.raises(ValueError):
        ops.topk_sim(q, torch.zeros(10, 4), 4)


def test_wrappers_never_fall_back_off_the_cpu():
    """Only a CPU tensor takes the plain version: a tensor on any other
    device raises rather than silently running it."""
    meta = torch.empty(4, 2, 8, device="meta")
    with pytest.raises(ValueError):
        ops.tree_refresh(meta, torch.empty(4, 2, device="meta"))
    with pytest.raises(ValueError):
        ops.tree_refresh(meta, torch.zeros(4, 2))
    with pytest.raises(ValueError):
        ops.browse_scores(torch.zeros(4, 2, 8), torch.zeros(3, 8),
                          torch.zeros(4, 2))


@pytest.mark.parametrize("Q,N", [(64, 256), (64, 1024), (1, 262144),
                                 (200, 262144), (64, 0), (3, 65)])
@pytest.mark.parametrize("D", [256, 4096])
def test_plan_splits_cover_every_key(Q, N, D):
    per_split, splits, cluster, slice_, _ = plan_splits(Q, N, D, sm_count=132)
    assert per_split % KEY_TILE == 0 and 1 <= splits <= MAX_SPLITS
    assert per_split * splits >= N
    assert per_split * (splits - 1) < max(N, 1), "no empty trailing split"
    assert cluster in (1, 2, 4, 8) and slice_ % 4 == 0
    assert cluster * slice_ >= D > (cluster - 1) * slice_, "every rank a slice"


# ---------------------------------------------------------------------------
# device-index ops
# ---------------------------------------------------------------------------
def test_normalize_rows_matches_jax():
    rng = np.random.default_rng(1)
    x = rng.normal(size=(12, 32)).astype(np.float32) * 4
    x[3] = 0.0
    np.testing.assert_allclose(ops.normalize_rows(_t(x)).numpy(),
                               np.asarray(jax_ops.normalize_rows(jnp.asarray(x))),
                               atol=1e-6)


def test_scatter_normalize_rows_drops_the_sentinel():
    rng = np.random.default_rng(2)
    base = rng.normal(size=(10, 16)).astype(np.float32)
    rows = rng.normal(size=(4, 16)).astype(np.float32)
    idx = np.array([7, 2, 10, 10], np.int32)      # two padding entries
    jax_out = np.asarray(jax_ops.scatter_normalize_rows(
        jax_ops.normalize_rows(jnp.asarray(base)), jnp.asarray(idx),
        jnp.asarray(rows)))
    arr = ops.normalize_rows(_t(base))
    out = ops.scatter_normalize_rows(arr, _t(idx.astype(np.int64)), _t(rows))
    assert out is arr, "the cache is updated in place"
    np.testing.assert_allclose(out.numpy(), jax_out, atol=1e-6)


def test_grow_rows_matches_jax():
    rng = np.random.default_rng(3)
    base = rng.normal(size=(5, 8)).astype(np.float32)
    out = ops.grow_rows(_t(base), 3)
    want = np.asarray(jax_ops.grow_rows(jnp.asarray(base), 3))
    np.testing.assert_allclose(out.numpy(), want, atol=1e-6)
    assert out.shape == (8, 8)


def test_release_rows():
    arr = torch.arange(12, dtype=torch.float32).reshape(6, 2)
    assert ops.release_rows(arr) is None
    assert ops.release_rows(None) is None
    kept = ops.release_rows(arr, keep=2)
    assert torch.equal(kept, arr[:2]) and kept.data_ptr() != arr.data_ptr()


# ---------------------------------------------------------------------------
# the kernels' first build, from several threads
# ---------------------------------------------------------------------------
def test_first_build_runs_once_across_threads(monkeypatch, tmp_path):
    """The maintenance plane's worker and the serve thread can reach the
    first kernel launch together: ``_build.library()`` compiles and loads
    the libraries once, and every caller gets that one library."""
    import ctypes
    import threading
    import time
    import types

    from repro_torch.kernels import _build

    compiles = []

    def fake_compile(outs):
        compiles.append(sorted(outs))
        time.sleep(0.05)              # a build takes a while: callers pile up
        return "ptxas report"

    class FakeLib:
        def __getattr__(self, name):
            return types.SimpleNamespace()     # takes argtypes and restype

    monkeypatch.setattr(_build, "_LIBRARY", None)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build, "_compile", fake_compile)
    monkeypatch.setattr(ctypes, "CDLL", lambda path: FakeLib())
    start = threading.Barrier(8)
    got = []

    def first_launch():
        start.wait(timeout=10)
        got.append(_build.library())

    threads = [threading.Thread(target=first_launch) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert not any(t.is_alive() for t in threads)
    assert len(compiles) == 1 and compiles[0] == sorted(_build.SOURCES)
    assert len(got) == 8 and all(lib is got[0] for lib in got)
    assert set(got[0].entries) == set(_build.SIGNATURES)
    assert _build.library() is got[0]


def test_launch_counts_split_by_thread_under_contention():
    """``LaunchCount.launched`` counts every launch once, under the calling
    thread's name, when the serve thread and the maintenance plane's
    worker launch at once (a short switch interval interleaves them)."""
    import sys
    import threading

    from repro_torch.core.maintenance_plane import WORKER_NAME
    from repro_torch.kernels._build import LaunchCount

    count = LaunchCount("probe")
    n = 20000
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=lambda: [count.launched()
                                                    for _ in range(n)],
                                    name=name)
                   for name in (WORKER_NAME, "serve", "serve-2")]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert count.launches == 3 * n
    assert count.by_thread == {WORKER_NAME: n, "serve": n, "serve-2": n}
    count.reset()
    assert (count.launches, count.by_thread, count.plain_calls) == (0, {}, 0)
