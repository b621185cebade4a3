"""Multi-device serve of the port's memory on the CPU: the round-robin
sharded fact index, shard-local ``topk_sim`` with a candidate merge, the
sharded flush and browse, ``set_mesh`` and ``ShardedServeConfig``; and the
serve entry points (``repro_torch.launch.serve``, ``repro_torch.examples``).

A mesh here is a ``DataMesh`` that names the CPU several times: each shard is
its own tensor and its own call of the kernel's plain version, as each shard
is its own launch on a card. Criteria:

- (a) the JAX package's in-process cases of ``tests/test_sharded_serve.py``
  on the port (merge tie-break and padding, duplicate rows, growth without a
  re-upload, the mesh=None fallbacks);
- (b) ``shard_ops`` at S = 2, 3, 4 against the port's unsharded ops: ids
  exact, values and rows bitwise equal, the physical shard-major layout;
- (c) a ``MemForestSystem`` with a mesh of 2 or 4 shards against mesh=None
  (``tests/sharded_parity_check.py``'s cases): trees bitwise, fact ids,
  answers and evidence exact in the six browse modes, growth without a
  re-upload, uneven shards, 3 rows on 4 shards;
- (d) detach and reattach under a mesh, and a mesh change 2 -> 4 -> None;
- (e) a ``ServeEngine`` whose memory carries a mesh;
- (f) the JAX package's sharded functions and system on 4 forced host
  devices, in a subprocess that runs this module as ``__main__`` (so this
  process keeps one JAX device), beside the port's on the same seeded numpy
  inputs: ids, layouts, tree shapes and answers exact, floats within
  ``tests/test_kernels.py``'s float32 tolerance (atol 2e-5);
- the entry points: the serve CLI's lines equal the JAX package's with the
  timings stripped, the examples' answers equal, finite losses.
"""
import contextlib
import io
import math
import os
import re
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import MemForestConfig, MemForestSystem
from repro_torch.data.synthetic import make_workload
from repro_torch.kernels import ops, ref, shard_ops
from repro_torch.kernels import topk_sim as topk_mod
from repro_torch.launch.mesh import DataMesh, make_data_mesh

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODES = ["flat", "root-only", "emb", "emb+planner", "llm", "llm+planner"]
F32_ATOL = 2e-5          # tests/test_kernels.py's float32 tolerance


def cpu_mesh(S):
    return DataMesh(("cpu",) * S)


def _rows(rng, n, d):
    return rng.standard_normal((n, d)).astype(np.float32)


# ---------------------------------------------------------------------------
# (a) the JAX package's in-process cases, on the port
# ---------------------------------------------------------------------------
def test_merge_topk_breaks_ties_by_ascending_index():
    vals = torch.tensor([[1.0, 3.0, 3.0, 2.0, 3.0, 1.0]])
    idx = torch.tensor([[50, 40, 7, 12, 19, 3]], dtype=torch.int32)
    v, i = ref.merge_topk(vals, idx, 4)
    assert v[0].tolist() == [3.0, 3.0, 3.0, 2.0]
    assert i[0].tolist() == [7, 19, 40, 12]


def test_merge_topk_masks_padding():
    vals = torch.tensor([[2.0, ref.NEG_INF, 1.0, ref.NEG_INF]])
    idx = torch.tensor([[4, -1, 9, -1]], dtype=torch.int32)
    _, i = ref.merge_topk(vals, idx, 3)
    assert i[0].tolist() == [4, 9, -1]


@pytest.mark.parametrize("S", [1, 2, 3, 4])
def test_duplicate_rows_surface_in_ascending_id_order(S):
    """Identical key rows score identically and come out lowest id first,
    unsharded and over every mesh size (the contract the merge needs)."""
    rng = np.random.default_rng(0)
    row = rng.standard_normal(32).astype(np.float32)
    other = _rows(rng, 64, 32)
    keys = np.concatenate([other, row[None], other[-8:], row[None]])
    q = torch.from_numpy(row[None] / np.linalg.norm(row))
    if S == 1:
        vals, idx = ops.topk_sim(q, torch.from_numpy(keys), 4)
    else:
        cap = shard_ops.pad_rows(keys.shape[0], S)
        sk = shard_ops.upload_sharded(keys, cap, cpu_mesh(S))
        vals, idx = shard_ops.sharded_topk_sim(
            ref.normalize_rows(q), sk, 4, mesh=cpu_mesh(S),
            num_valid=keys.shape[0])
    idx = idx[0].tolist()
    assert 64 in idx and 73 in idx, idx
    assert idx.index(64) < idx.index(73), idx
    for g in range(65, 73):
        if g in idx and (g - 9) in idx:
            assert idx.index(g - 9) < idx.index(g)


def _small_workload(seed=3, sessions=12):
    return make_workload(num_entities=4, num_sessions=sessions,
                         num_queries=6, seed=seed)


@pytest.mark.parametrize("S", [1, 2, 4])
def test_device_cache_grows_without_reupload(S):
    wl = _small_workload()
    mf = MemForestSystem(MemForestConfig(), device="cpu")
    if S > 1:
        mf.set_mesh(cpu_mesh(S))
    third = len(wl.sessions) // 3
    for s in wl.sessions[:third]:
        mf.ingest_session(s)
    mf.query_batch(wl.queries)          # builds the device caches
    up0, gr0 = mf.forest.index_uploads, mf.forest.index_grows
    assert up0 > 0 and gr0 == 0
    for s in wl.sessions[third:]:
        mf.ingest_session(s)            # host capacity grows past cache cap
    res = mf.query_batch(wl.queries)
    assert mf.forest.index_uploads == up0, \
        "capacity growth re-uploaded the whole index"
    assert mf.forest.index_grows >= 1

    fresh = MemForestSystem(MemForestConfig(), device="cpu")
    for s in wl.sessions:
        fresh.ingest_session(s)
    for a, b in zip(res, fresh.query_batch(wl.queries)):
        assert a.answer == b.answer and a.evidence == b.evidence


def test_grow_rows_preserves_existing():
    arr = torch.arange(12, dtype=torch.float32).reshape(4, 3)
    grown = ops.grow_rows(arr, 4)
    assert grown.shape == (8, 3)
    assert torch.equal(grown[:4], arr) and not grown[4:].any()


def test_make_data_mesh_without_two_cards_is_none():
    assert make_data_mesh() is None      # no card is visible here
    assert make_data_mesh(1) is None
    assert make_data_mesh(4) is None     # capped at available


def test_make_data_mesh_counts_cards(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    mesh = make_data_mesh()
    assert mesh.devices == tuple(torch.device("cuda", i) for i in range(4))
    assert mesh.shape == {"data": 4} and mesh.axis == "data"
    assert make_data_mesh(2).size == 2 and make_data_mesh(1) is None
    assert make_data_mesh(8).size == 4
    assert shard_ops.mesh_shards(mesh) == 4
    assert shard_ops.mesh_shards(mesh, "model") == 1
    assert shard_ops.mesh_shards(None) == 1


def test_data_mesh_distinct_devices_keep_first_use_order():
    mesh = DataMesh(("cpu", "cpu", "cpu"))
    assert mesh.size == 3 and mesh.distinct() == (torch.device("cpu"),)
    with pytest.raises(ValueError):
        DataMesh(())


def test_set_mesh_none_is_identity():
    wl = make_workload(num_entities=3, num_sessions=5, num_queries=5, seed=9)
    a = MemForestSystem(MemForestConfig(), device="cpu")
    b = MemForestSystem(MemForestConfig(), device="cpu")
    b.set_mesh(None)
    assert b.forest.mesh is None
    b.set_mesh(cpu_mesh(1))             # width 1 counts as no mesh
    assert b.forest.mesh is None
    for s in wl.sessions:
        a.ingest_session(s)
        b.ingest_session(s)
    for ra, rb in zip(a.query_batch(wl.queries), b.query_batch(wl.queries)):
        assert ra.answer == rb.answer and ra.evidence == rb.evidence


def _no_model_engine(memory, **kw):
    from repro_torch.serving.engine import ServeEngine
    return ServeEngine(None, {"embed": torch.zeros(1)}, memory=memory, **kw)


def test_sharded_serve_config_single_device_fallback():
    """ShardedServeConfig without two cards degrades to mesh=None serve."""
    from repro_torch.serving.engine import ShardedServeConfig

    mf = MemForestSystem(MemForestConfig(), device="cpu")
    eng = _no_model_engine(mf, sharded=ShardedServeConfig(devices=4))
    assert eng.serve_mesh is None
    assert mf.forest.mesh is None
    assert eng.metrics()["serve_devices"] == 1


def test_sharded_serve_config_refuses_cards_for_a_cpu_memory(monkeypatch):
    """With cards visible the config builds a mesh of them; a memory on the
    CPU refuses it rather than run its kernels on another device type."""
    from repro_torch.serving.engine import ShardedServeConfig

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    mf = MemForestSystem(MemForestConfig(), device="cpu")
    with pytest.raises(ValueError, match="mesh"):
        _no_model_engine(mf, sharded=ShardedServeConfig())
    assert mf.forest.mesh is None


# ---------------------------------------------------------------------------
# (b) shard_ops against the unsharded ops, bitwise
# ---------------------------------------------------------------------------
SHARDS = [2, 3, 4]


def _shard_major(x, S):
    """The physical layout: row s*(cap/S) + l holds logical row l*S + s."""
    cap, d = x.shape
    return x.reshape(cap // S, S, d).transpose(0, 1).reshape(cap, d)


def _logical(sk):
    """A ``ShardedRows``' matrix in global row order."""
    phys = sk.physical()
    S = len(sk.shards)
    return phys.reshape(S, -1, phys.shape[1]).transpose(0, 1).reshape(
        phys.shape)


@pytest.mark.parametrize("S", SHARDS)
@pytest.mark.parametrize("n", [3, 61, 64])
def test_upload_sharded_layout(S, n):
    rng = np.random.default_rng(S * 100 + n)
    host = _rows(rng, 64, 24)
    host[n:] = 0.0
    cap = shard_ops.pad_rows(64, S)
    mesh = cpu_mesh(S)
    sk = shard_ops.upload_sharded(host, cap, mesh)
    assert sk.shape == (cap, 24) and len(sk.shards) == S
    assert all(t.shape == (cap // S, 24) for t in sk.shards)
    dense = ops.normalize_rows(torch.from_numpy(host))
    want = ops.grow_rows(dense, cap - 64)
    assert torch.equal(_logical(sk), want)
    assert torch.equal(sk.physical(), _shard_major(want, S))
    for s, t in enumerate(sk.shards):
        assert torch.equal(t, want[s::S])


@pytest.mark.parametrize("S", SHARDS)
def test_grow_sharded_keeps_every_row_on_its_shard(S):
    rng = np.random.default_rng(S)
    host = _rows(rng, 40, 16)
    mesh = cpu_mesh(S)
    cap = shard_ops.pad_rows(40, S)
    sk = shard_ops.upload_sharded(host, cap, mesh)
    before = [t.clone() for t in sk.shards]
    grown = shard_ops.grow_sharded(sk, cap + 4 * S, mesh)
    assert grown.shape == (cap + 4 * S, 16)
    for s, t in enumerate(grown.shards):
        assert torch.equal(t[: before[s].shape[0]], before[s])
        assert not t[before[s].shape[0]:].any()
    dense = ops.grow_rows(ops.normalize_rows(torch.from_numpy(host)),
                          cap + 4 * S - 40)
    assert torch.equal(_logical(grown), dense)


@pytest.mark.parametrize("S", SHARDS)
def test_sharded_scatter_rows_equals_the_unsharded_scatter(S):
    rng = np.random.default_rng(10 + S)
    host = _rows(rng, 48, 16)
    mesh = cpu_mesh(S)
    cap = shard_ops.pad_rows(48, S)
    sk = shard_ops.upload_sharded(host, cap, mesh)
    dense = ops.grow_rows(ops.normalize_rows(torch.from_numpy(host)),
                          cap - 48)
    rows = [3, 17, 40, 5, 46]
    upd = _rows(rng, 8, 16)
    idx_sharded = np.full(8, -1, np.int64)
    idx_sharded[:5] = rows
    idx_dense = np.where(idx_sharded >= 0, idx_sharded, cap)
    out = shard_ops.sharded_scatter_rows(sk, idx_sharded, upd, mesh=mesh)
    assert out is sk                     # in place, as the unsharded scatter
    ops.scatter_normalize_rows(dense, torch.from_numpy(idx_dense),
                               torch.from_numpy(upd))
    assert torch.equal(_logical(sk), dense)
    # -1 padding only: nothing changes
    shard_ops.sharded_scatter_rows(sk, np.full(4, -1), upd[:4], mesh=mesh)
    assert torch.equal(_logical(sk), dense)


def _index(rng, n, cap, d, S):
    host = np.zeros((cap, d), np.float32)
    host[:n] = _rows(rng, n, d)
    q = ops.normalize_rows(torch.from_numpy(_rows(rng, 7, d)))
    # planted ties: two rows equal to query 0 on different shards, one equal
    # to query 1 past num_valid (masked)
    host[1] = host[n - 2] = q[0].numpy() * 3.0
    if n < cap:
        host[n] = q[1].numpy()
    return host, q, shard_ops.upload_sharded(host, cap, cpu_mesh(S)), \
        ops.normalize_rows(torch.from_numpy(host))


@pytest.mark.parametrize("S", SHARDS)
@pytest.mark.parametrize("n,k", [(57, 8), (64, 32), (10, 16), (300, 5)])
def test_sharded_topk_sim_equals_topk_sim(S, n, k):
    rng = np.random.default_rng(1000 * S + n)
    cap = shard_ops.pad_rows(max(n + 1, 64), S)
    _, q, sk, dense = _index(rng, n, cap, 32, S)
    v1, i1 = shard_ops.sharded_topk_sim(q, sk, k, mesh=cpu_mesh(S),
                                        num_valid=n)
    v0, i0 = ops.topk_sim(q, dense, k, normalize=False, num_valid=n)
    assert torch.equal(i1, i0) and i1.dtype == torch.int32
    assert torch.equal(v1, v0)
    assert i1[0, :2].tolist() == [1, n - 2]


@pytest.mark.parametrize("S", SHARDS)
def test_sharded_topk_sim_whole_index_without_num_valid(S):
    rng = np.random.default_rng(7 + S)
    cap = shard_ops.pad_rows(64, S)
    host = _rows(rng, cap, 16)
    q = ops.normalize_rows(torch.from_numpy(_rows(rng, 5, 16)))
    sk = shard_ops.upload_sharded(host, cap, cpu_mesh(S))
    v1, i1 = shard_ops.sharded_topk_sim(q, sk, 10, mesh=cpu_mesh(S))
    v0, i0 = ops.topk_sim(q, ops.normalize_rows(torch.from_numpy(host)), 10,
                          normalize=False)
    assert torch.equal(i1, i0) and torch.equal(v1, v0)


@pytest.mark.parametrize("S", SHARDS)
def test_fewer_valid_rows_than_shards(S):
    """``S - 1`` valid rows: the last shard owns none and returns only dead
    slots (-1e30 / -1), which the merge drops."""
    rng = np.random.default_rng(5)
    tiny = _rows(rng, S - 1, 16)
    q = ops.normalize_rows(torch.from_numpy(_rows(rng, 2, 16)))
    cap = shard_ops.pad_rows(8, S)
    mesh = cpu_mesh(S)
    sk = shard_ops.upload_sharded(tiny, cap, mesh)
    v1, i1 = shard_ops.sharded_topk_sim(q, sk, 4, mesh=mesh,
                                        num_valid=tiny.shape[0])
    dense = ops.normalize_rows(torch.from_numpy(
        np.pad(tiny, ((0, cap - tiny.shape[0]), (0, 0)))))
    v0, i0 = ops.topk_sim(q, dense, 4, normalize=False,
                          num_valid=tiny.shape[0])
    assert torch.equal(i0, i1) and torch.equal(v0, v1)
    assert (i1[:, S - 1:] == -1).all() and (v1[:, S - 1:] == ref.NEG_INF).all()
    # the empty shard itself
    ve, ie = ops.topk_sim(q, sk.shards[-1], 2, normalize=False, num_valid=0)
    assert (ie == -1).all() and (ve == ref.NEG_INF).all()


def test_block_scores_do_not_depend_on_the_neighbour_rows():
    """The plain top-k's scores are the same bits whichever rows stand
    beside a key: a strided shard of the index scores as the whole index."""
    rng = np.random.default_rng(2)
    for Q, N, D in ((1, 1000, 128), (64, 1000, 4096), (7, 3, 256)):
        q = torch.from_numpy(_rows(rng, Q, D))
        keys = torch.from_numpy(_rows(rng, N, D))
        full = ref.block_scores(q, keys)
        for S in SHARDS:
            for s in range(S):
                assert torch.equal(ref.block_scores(q, keys[s::S]),
                                   full[:, s::S]), (Q, N, D, S, s)


def test_a_shard_can_plan_another_cluster_than_its_index():
    """Why a shard launches with the whole index's cluster: at 64 queries
    over 3000 keys of 256 the index's launch takes a cluster of 2 and a
    quarter of the keys a cluster of 8, which would sum every score in
    another order. With the cluster given, the slice and split_k follow it
    and only the splits follow the shard's rows."""
    sms = 132
    whole = topk_mod.plan_cluster(64, 3000, 256, sms)
    shard = topk_mod.plan_cluster(64, 750, 256, sms)
    assert (whole, shard) == (2, 8)
    got = topk_mod.plan_splits(64, 750, 256, sms, cluster=whole)
    want = topk_mod.plan_splits(64, 3000, 256, sms)
    assert got[2:] == want[2:] == (2, 128, True)
    assert got[0] * got[1] >= 750
    # at the slice's and the serve phase's recall shapes both plans agree
    for Q, nv, D in ((64, 210, 256), (1, 210, 256), (64, 240, 4096)):
        for S in (2, 4):
            assert topk_mod.plan_cluster(Q, nv, D, sms) == \
                topk_mod.plan_cluster(Q, -(-nv // S), D, sms)


@pytest.mark.parametrize("S", SHARDS)
def test_sharded_tree_refresh_equals_tree_refresh(S):
    rng = np.random.default_rng(20 + S)
    P = shard_ops.pad_rows(16, S)
    emb = rng.standard_normal((P, 8, 32)).astype(np.float32)
    mask = (rng.random((P, 8)) < 0.6).astype(np.float32)
    mask[-1] = 0.0                       # a padded parent
    out = shard_ops.sharded_tree_refresh(emb, mask, mesh=cpu_mesh(S))
    want = ops.tree_refresh(torch.from_numpy(emb), torch.from_numpy(mask))
    assert torch.equal(out, want)


@pytest.mark.parametrize("S", SHARDS)
def test_sharded_browse_scores_equals_browse_scores(S):
    rng = np.random.default_rng(30 + S)
    F = shard_ops.pad_rows(16, S)
    emb = rng.standard_normal((F, 4, 32)).astype(np.float32)
    q = _rows(rng, F, 32)
    mask = (rng.random((F, 4)) < 0.7).astype(np.float32)
    out = shard_ops.sharded_browse_scores(emb, q, mask, mesh=cpu_mesh(S))
    want = ops.browse_scores(*map(torch.from_numpy, (emb, q, mask)))
    assert torch.equal(out, want)


@pytest.mark.parametrize("S", SHARDS)
def test_sharded_browse_scores_rows_equals_browse_scores_rows(S):
    rng = np.random.default_rng(40 + S)
    F, K, R, L = shard_ops.pad_rows(32, S), 8, 200, 12
    arena = torch.from_numpy(_rows(rng, R, 32))
    rows = torch.from_numpy(rng.integers(-1, R, (F, K)).astype(np.int32))
    rows[:, 0] = 7                       # one node in many slots
    q_rows = torch.from_numpy(_rows(rng, L, 32))
    lane_of = torch.from_numpy(rng.integers(0, L, F).astype(np.int32))
    mask = (rows >= 0).to(torch.float32)
    mesh = cpu_mesh(S)
    out = shard_ops.sharded_browse_scores_rows(arena, rows, q_rows, lane_of,
                                               mask, mesh=mesh)
    want = ops.browse_scores_rows(arena, rows, q_rows, lane_of, mask)
    assert torch.equal(out, want)
    rep = shard_ops.sharded_browse_scores_rows(
        shard_ops.replicate(arena, mesh), rows, shard_ops.replicate(
            q_rows, mesh), lane_of, mask, mesh=mesh)
    assert torch.equal(rep, want)


# ---------------------------------------------------------------------------
# (c) the system under a mesh against mesh=None
# ---------------------------------------------------------------------------
def _build(wl, mesh, sessions=None):
    mf = MemForestSystem(MemForestConfig(), device="cpu")
    mf.set_mesh(mesh)
    for s in (wl.sessions if sessions is None else sessions):
        mf.ingest_session(s)
    return mf


def check_trees(base, other, tag):
    fa, fb = base.forest, other.forest
    assert list(fa.trees) == list(fb.trees), tag
    assert [(f.fact_id, f.text) for f in fa.facts] == \
        [(f.fact_id, f.text) for f in fb.facts], tag
    assert fa.placement == fb.placement, tag
    for tid, tree in fa.trees.items():
        t2 = fb.trees[tid]
        n = tree._n
        assert t2._n == n and tree.children == t2.children, (tag, tid)
        assert np.array_equal(tree.emb[:n], t2.emb[:n]), (tag, tid)
        assert tree.text == t2.text, (tag, tid)


def check_queries(base, other, queries, tag):
    assert queries, f"{tag}: workload produced no queries"
    for mode in MODES:
        r0 = base.query_batch(queries, mode=mode)
        r1 = other.query_batch(queries, mode=mode)
        for a, b in zip(r0, r1):
            assert a.answer == b.answer, (tag, mode, a.answer, b.answer)
            assert a.evidence == b.evidence, (tag, mode)
    a = base.query(queries[0])
    b = other.query(queries[0])
    assert a.answer == b.answer and a.evidence == b.evidence, tag


@pytest.fixture(scope="module")
def main_wl():
    return make_workload(num_entities=5, num_sessions=9,
                         transitions_per_entity=3, num_queries=10, seed=11)


@pytest.fixture(scope="module")
def base(main_wl):
    return _build(main_wl, None)


@pytest.mark.parametrize("S", [2, 4])
def test_flush_and_six_modes_equal_mesh_none(main_wl, base, S):
    mf = _build(main_wl, cpu_mesh(S))
    assert mf.forest.mesh.size == S
    check_trees(base, mf, f"S={S}")
    check_queries(base, mf, main_wl.queries, f"S={S}")
    fact_dev, n = mf.forest.fact_index_device()
    assert isinstance(fact_dev, shard_ops.ShardedRows)
    assert len(fact_dev.shards) == S and n == len(base.forest.facts)
    root_dev, _, _ = mf.forest.root_index_device()
    assert isinstance(root_dev, shard_ops.Replicated)
    arena, _ = mf.forest.node_arena()
    assert isinstance(arena, shard_ops.Replicated)
    assert len(arena.copies) == 1        # shards on one device share it


@pytest.mark.parametrize("S", [2, 4])
def test_launches_per_call_under_a_mesh(main_wl, S):
    """S plain calls of topk_sim for the fact recall plus 1 for the roots, S
    of tree_refresh a flush level and S of browse_scores a browse depth."""
    from repro_torch.kernels import COUNTS, reset_counts

    mf = _build(main_wl, cpu_mesh(S), main_wl.sessions[:4])
    levels = mf.forest.flush_levels
    reset_counts()
    mf.ingest_batch(main_wl.sessions[4:])
    levels = mf.forest.flush_levels - levels
    assert levels > 0
    assert COUNTS["tree_refresh"].plain_calls == S * levels
    reset_counts()
    mf.query_batch(main_wl.queries, mode="flat")
    assert COUNTS["topk_sim"].plain_calls == S + 1
    reset_counts()
    before = mf.retriever.browse_launches
    mf.query_batch(main_wl.queries, mode="llm")
    depths = mf.retriever.browse_launches - before
    assert depths > 0
    assert COUNTS["browse_scores"].plain_calls == S * depths
    assert COUNTS["topk_sim"].plain_calls == S + 1


@pytest.mark.parametrize("S", [2, 4])
def test_growth_under_a_mesh_never_reuploads(main_wl, S):
    mf = _build(main_wl, cpu_mesh(S))
    wl2 = make_workload(num_entities=5, num_sessions=4,
                        transitions_per_entity=2, num_queries=4, seed=12)
    mf.query_batch(main_wl.queries)
    up0, gr0 = mf.forest.index_uploads, mf.forest.index_grows
    for s in wl2.sessions:
        mf.ingest_session(s)
    r = mf.query_batch(main_wl.queries)
    assert mf.forest.index_uploads == up0, \
        f"S={S}: capacity growth re-uploaded the sharded cache"
    assert mf.forest.index_grows > gr0, f"S={S}: no sharded growth"
    fresh = _build(main_wl, None, list(main_wl.sessions) + list(wl2.sessions))
    for a, b in zip(r, fresh.query_batch(main_wl.queries)):
        assert a.answer == b.answer and a.evidence == b.evidence, f"S={S}"
    check_trees(fresh, mf, f"grown S={S}")


@pytest.mark.parametrize("S", [2, 3, 4])
def test_uneven_shards(S):
    wl = make_workload(num_entities=1, num_sessions=2,
                       transitions_per_entity=2, num_queries=6, seed=6)
    b = _build(wl, None)
    n_facts = len(b.forest.facts)
    assert n_facts % 2 and n_facts % 4, \
        f"odd workload regressed: {n_facts} facts"
    mf = _build(wl, cpu_mesh(S))
    check_trees(b, mf, f"odd S={S}")
    check_queries(b, mf, wl.queries, f"odd S={S}")


def test_three_row_index_on_four_shards():
    """A memory whose fact index holds fewer rows than shards."""
    from repro_torch.core.types import Query, Session, Turn

    sessions = [Session("s1", [
        Turn("user", "Bob lives in Boston as of January 2023.", 36.0, 0),
        Turn("user", "Bob moved from Boston to Davis in May 2023.", 40.0, 1),
    ])]
    queries = [Query("Where does Bob live now?", "current", "Bob",
                     "residence")]
    b = MemForestSystem(MemForestConfig(), device="cpu")
    m = MemForestSystem(MemForestConfig(), device="cpu")
    m.set_mesh(cpu_mesh(4))
    for s in sessions:
        b.ingest_session(s)
        m.ingest_session(s)
    assert 0 < len(b.forest.facts) < 4
    check_trees(b, m, "tiny")
    check_queries(b, m, queries, "tiny")


# ---------------------------------------------------------------------------
# (d) detach and reattach; a mesh change mid-run
# ---------------------------------------------------------------------------
def test_detach_reattach_under_a_mesh(main_wl, base):
    mf = _build(main_wl, cpu_mesh(4))
    mf.query_batch(main_wl.queries)
    held = mf.device_bytes()
    assert held > 0
    f = mf.forest
    fact_dev = f._fact_dev
    D = f.config.embed_dim
    # a sharded or replicated matrix counts once, by its global shape
    assert held == 4 * D * (fact_dev.shape[0] + f._root_dev.shape[0]
                            + f._arena.shape[0])
    releases = f.index_releases
    assert mf.detach_device() == held and mf.device_bytes() == 0
    assert f.index_releases == releases + 3
    assert f._fact_dev is None and f._arena is None and not f._arenas
    check_queries(base, mf, main_wl.queries, "reattached")
    assert mf.device_bytes() == held


def test_mesh_change_mid_run(main_wl, base):
    mf = MemForestSystem(MemForestConfig(), device="cpu")
    ref_sys = MemForestSystem(MemForestConfig(), device="cpu")
    plan = [(cpu_mesh(2), main_wl.sessions[:3]),
            (cpu_mesh(4), main_wl.sessions[3:6]),
            (None, main_wl.sessions[6:])]
    for mesh, sessions in plan:
        uploads = mf.forest.index_uploads
        mf.set_mesh(mesh)
        assert mf.forest._fact_dev is None and not mf.forest._arenas
        assert mf.forest.index_uploads == uploads
        for s in sessions:
            mf.ingest_session(s)
            ref_sys.ingest_session(s)
        check_trees(ref_sys, mf, f"mesh {mesh}")
        check_queries(ref_sys, mf, main_wl.queries, f"mesh {mesh}")
    check_trees(base, mf, "end")


def test_adopted_forest_keeps_the_mesh(main_wl, tmp_path):
    mf = _build(main_wl, cpu_mesh(2), main_wl.sessions[:4])
    path = mf.save(str(tmp_path / "snap"))
    fresh = MemForestSystem(MemForestConfig(), device="cpu")
    fresh.set_mesh(cpu_mesh(3))
    fresh.adopt(MemForestSystem.load(path, device="cpu").forest)
    assert fresh.forest.mesh is not None and fresh.forest.mesh.size == 3
    check_queries(mf, fresh, main_wl.queries, "adopted")


def test_set_mesh_refuses_another_device_type():
    mf = MemForestSystem(MemForestConfig(), device="cpu")
    with pytest.raises(ValueError, match="mesh"):
        mf.set_mesh(DataMesh(("cuda:0", "cuda:0")))


# ---------------------------------------------------------------------------
# (e) the serve engine's lanes over a sharded memory
# ---------------------------------------------------------------------------
def test_engine_lanes_over_a_sharded_memory(main_wl):
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import get_model
    from repro_torch.serving.engine import ServeEngine

    cfg = get_smoke_config("llama3_8b").replace(num_layers=1)
    model = get_model(cfg)
    params = model.init(0, device="cpu")
    results = []
    for mesh in (None, cpu_mesh(2), cpu_mesh(4)):
        mf = MemForestSystem(MemForestConfig(), device="cpu")
        mf.set_mesh(mesh)
        eng = ServeEngine(model, params, max_batch=2, max_len=32, memory=mf,
                          max_ingest_batch=4)
        for s in main_wl.sessions:
            eng.submit_session(s)
        eng.submit([5, 6, 7, 8], max_new_tokens=2)
        eng.run_until_drained()
        rids = [eng.submit_query(q) for q in main_wl.queries]
        eng.run_until_drained()
        res = [eng.pop_query_result(r) for r in rids]
        assert eng.metrics()["serve_devices"] == 1      # no ShardedServeConfig
        results.append((mf, [(r.answer, r.evidence) for r in res],
                        [r.out_tokens for r in eng.finished]))
    (b, ans0, tok0), *rest = results
    for mf, ans, tok in rest:
        check_trees(b, mf, "engine")
        assert ans == ans0 and tok == tok0


# ---------------------------------------------------------------------------
# (f) against the JAX package on 4 forced host devices
# ---------------------------------------------------------------------------
def test_against_the_jax_package_on_four_devices():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(ROOT, "src")
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    env["JAX_PLATFORMS"] = "cpu"
    r = subprocess.run([sys.executable, os.path.abspath(__file__)],
                       capture_output=True, text=True, timeout=600, env=env,
                       cwd=ROOT)
    assert r.returncode == 0, r.stdout[-4000:] + r.stderr[-4000:]
    assert "PARITY OK" in r.stdout


def jax_parity() -> None:
    """The subprocess of ``test_against_the_jax_package_on_four_devices``."""
    import jax

    from repro.config import MemForestConfig as JaxConfig
    from repro.core.memforest import MemForestSystem as JaxSystem
    from repro.data.synthetic import make_workload as jax_workload
    from repro.kernels import ops as jops
    from repro.kernels import shard_ops as jshard
    from repro.launch.mesh import make_data_mesh as jax_mesh

    assert len(jax.devices()) == 4, jax.devices()
    S = 4
    jm, tm = jax_mesh(S), cpu_mesh(S)
    rng = np.random.default_rng(0)

    # upload_sharded: the physical shard-major layout
    host = _rows(rng, 61, 32)
    cap = shard_ops.pad_rows(64, S)
    js = jshard.upload_sharded(host, cap, jm)
    ts = shard_ops.upload_sharded(host, cap, tm)
    np.testing.assert_allclose(ts.physical().numpy(), np.asarray(js),
                               atol=F32_ATOL)
    # sharded_scatter_rows: -1 drops, each shard applies its own rows
    idx = np.full(8, -1, np.int32)
    idx[:5] = [3, 17, 40, 5, 60]
    upd = _rows(rng, 8, 32)
    js = jshard.sharded_scatter_rows(js, idx, upd, mesh=jm)
    shard_ops.sharded_scatter_rows(ts, idx, upd, mesh=tm)
    np.testing.assert_allclose(ts.physical().numpy(), np.asarray(js),
                               atol=F32_ATOL)
    # sharded_topk_sim: the global ids exactly, with planted ties and
    # num_valid short of the rows
    q = np.asarray(jops.normalize_rows(_rows(rng, 6, 32)))
    for nv, k in ((61, 8), (3, 4), (40, 16)):
        jv, ji = jshard.sharded_topk_sim(q, js, k, mesh=jm, num_valid=nv)
        tv, ti = shard_ops.sharded_topk_sim(torch.from_numpy(q), ts, k,
                                            mesh=tm, num_valid=nv)
        assert ti.numpy().tolist() == np.asarray(ji).tolist(), (nv, k)
        np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=F32_ATOL)
    # sharded_tree_refresh
    emb = rng.standard_normal((16, 8, 32)).astype(np.float32)
    mask = (rng.random((16, 8)) < 0.6).astype(np.float32)
    np.testing.assert_allclose(
        shard_ops.sharded_tree_refresh(emb, mask, mesh=tm).numpy(),
        np.asarray(jshard.sharded_tree_refresh(emb, mask, mesh=jm)),
        atol=F32_ATOL)
    # the packed browse form
    qm = _rows(rng, 16, 32)
    np.testing.assert_allclose(
        shard_ops.sharded_browse_scores(emb, qm, mask, mesh=tm).numpy(),
        np.asarray(jshard.sharded_browse_scores(emb, qm, mask, mesh=jm)),
        atol=F32_ATOL)

    # a sharded MemForestSystem in both packages on one workload
    kw = dict(num_entities=5, num_sessions=9, transitions_per_entity=3,
              num_queries=10, seed=11)
    wl_j, wl_t = jax_workload(**kw), make_workload(**kw)
    a = JaxSystem(JaxConfig())
    a.set_mesh(jm)
    b = MemForestSystem(MemForestConfig(), device="cpu")
    b.set_mesh(tm)
    for sj, st in zip(wl_j.sessions, wl_t.sessions):
        a.ingest_session(sj)
        b.ingest_session(st)
    fa, fb = a.forest, b.forest
    assert [(f.fact_id, f.text) for f in fa.facts] == \
        [(f.fact_id, f.text) for f in fb.facts]
    assert list(fa.trees) == list(fb.trees)
    for key, ta in fa.trees.items():
        tb = fb.trees[key]
        assert ta.children == tb.children and ta.level == tb.level \
            and ta.root == tb.root, key
        n = ta._n
        np.testing.assert_allclose(tb.emb[:n], ta.emb[:n], atol=F32_ATOL)
    for mode in MODES:
        ra = a.query_batch(wl_j.queries, mode=mode)
        rb = b.query_batch(wl_t.queries, mode=mode)
        assert [(r.answer, r.evidence) for r in ra] == \
            [(r.answer, r.evidence) for r in rb], mode
    print("PARITY OK")


# ---------------------------------------------------------------------------
# the entry points
# ---------------------------------------------------------------------------
_TIMES = re.compile(r" *\d+(?:\.\d+)?\s*(?:ms|s)\b|speedup [\d.]+x")


def _captured(fn, *args, **kwargs):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        fn(*args, **kwargs)
    return buf.getvalue()


def _untimed(text):
    return [_TIMES.sub("T", ln) for ln in text.splitlines()]


def _jax_serve(monkeypatch, argv):
    from repro.launch import serve as jax_serve
    monkeypatch.setattr(sys, "argv", ["serve"] + argv)
    return _captured(jax_serve.main)


@pytest.mark.parametrize("encoder", ["hashing", "model"])
def test_serve_cli_prints_the_jax_packages_lines(monkeypatch, encoder):
    """The same flags give the same lines, timings stripped. The model
    encoder runs on the JAX package's seeded weights, carried over with
    ``repro_torch.convert`` (the CLI's own init draws other numbers)."""
    from repro_torch.launch import serve

    argv = ["--encoder", encoder, "--sessions", "4", "--queries", "8"]
    want = _jax_serve(monkeypatch, argv)
    params = None
    if encoder == "model":
        import jax

        from repro.configs import get_smoke_config as jax_smoke
        from repro.models import get_model as jax_get_model
        from repro_torch.configs import get_smoke_config
        from repro_torch.convert import transformer_params_from_numpy

        shrink = dict(d_model=128, num_heads=4, num_kv_heads=4, head_dim=32)
        jcfg = jax_smoke("llama3_8b").replace(**shrink)
        jp = jax.tree.map(np.asarray,
                          jax_get_model(jcfg).init(jax.random.key(0)))
        params = transformer_params_from_numpy(
            jp, get_smoke_config("llama3_8b").replace(**shrink),
            device="cpu")
    got = _captured(serve.main, argv + ["--device", "cpu"], params=params)
    assert _untimed(got) == _untimed(want)
    assert sum(ln.startswith(" [") for ln in got.splitlines()) == 8


def test_serve_cli_own_weights_run_on_the_cpu():
    from repro_torch.launch import serve

    out = _captured(serve.main, ["--device", "cpu", "--sessions", "2",
                                 "--queries", "3"])
    assert "backbone: llama3-8b-smoke" in out
    assert sum(ln.startswith(" [") for ln in out.splitlines()) == 3
    assert "accuracy" in out


@pytest.mark.parametrize("entry", ["launch.serve", "examples.quickstart",
                                   "examples.migration_merge",
                                   "examples.serve_memforest",
                                   "examples.train_lm"])
def test_entry_points_want_a_card_unless_told_cpu(entry):
    """With no visible card and no ``--device cpu`` an entry point refuses
    to start."""
    import importlib

    mod = importlib.import_module(f"repro_torch.{entry}")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mod.main([])


def _run_jax_example(name):
    import runpy
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        runpy.run_path(os.path.join(ROOT, "examples", f"{name}.py"),
                       run_name="__main__")
    return buf.getvalue()


@pytest.mark.parametrize("name", ["quickstart", "migration_merge"])
def test_examples_print_the_jax_examples_answers(name):
    import importlib

    mod = importlib.import_module(f"repro_torch.examples.{name}")
    got = _captured(mod.main, ["--device", "cpu"])
    want = _run_jax_example(name)
    assert _untimed(got) == _untimed(want)


def test_serve_memforest_example_runs_on_the_cpu():
    from repro_torch.examples import serve_memforest

    out = _captured(serve_memforest.main, ["--device", "cpu"])
    assert "served 8 decode requests + 12 queries" in out
    assert "hot 2/2" in out


def test_train_lm_example_losses_are_finite():
    from repro_torch.examples import train_lm

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        losses = train_lm.main(["--device", "cpu", "--steps", "3"])
    assert len(losses) == 2 and all(math.isfinite(x) for x in losses)
    assert "done." in buf.getvalue()


if __name__ == "__main__":
    jax_parity()
