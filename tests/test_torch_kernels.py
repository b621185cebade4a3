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
def test_plan_splits_cover_every_key(Q, N):
    per_split, splits = plan_splits(Q, N, sm_count=132)
    assert per_split % KEY_TILE == 0 and 1 <= splits <= MAX_SPLITS
    assert per_split * splits >= N
    assert per_split * (splits - 1) < max(N, 1), "no empty trailing split"


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
