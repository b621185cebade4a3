"""Lifecycle maintenance and snapshots of the port against the JAX package:
``repro_torch.core.maintenance`` and ``core/persistence.py`` beside
``repro.core.maintenance`` and ``repro.core.persistence``, on the same seeded
workloads, on the CPU, in one process.

The cases of ``tests/test_maintenance.py`` (deletion, migration merge,
rematerialization, idempotent merges) and ``tests/test_persistence.py``
(save/load with and without derived state), each run in both packages:
structure exactly, node embeddings within 1e-5 (``EMB_ATOL``), answers and
evidence exactly in all six browse modes.

Then the port's node arena (``Forest.node_arena``, the node embeddings on the
device the browse gathers from) after a compaction and after a verbatim copy
into a tree that deletions emptied — both replace a tree under its tree id —
and the serve engine's maintenance lane on both packages' engines.
"""
import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.config import MemForestConfig as JaxConfig
from repro.configs import get_smoke_config as jax_smoke_config
from repro.core import maintenance as jax_maintenance
from repro.core import persistence as jax_persistence
from repro.core.maintenance_plane import MaintenancePlane as JaxPlane
from repro.core.memforest import MemForestSystem as JaxSystem
from repro.data.synthetic import make_workload as jax_workload
from repro.models import get_model as jax_get_model
from repro.serving.engine import ServeEngine as JaxEngine
from repro_torch import MemForestSystem as TorchSystem
from repro_torch.configs import get_smoke_config
from repro_torch.convert import transformer_params_from_numpy
from repro_torch.core import maintenance as torch_maintenance
from repro_torch.core import persistence as torch_persistence
from repro_torch.core.maintenance_plane import MaintenancePlane as TorchPlane
from repro_torch.data.synthetic import make_workload as torch_workload
from repro_torch.models import get_model
from repro_torch.serving.engine import ServeEngine

from test_torch_durability import answers, same_state

KW = dict(num_entities=5, num_sessions=8, transitions_per_entity=3,
          num_queries=20, seed=7)


def _build(which, sessions):
    """A system of the package ``which`` ("jax" or "torch") that ingested
    ``sessions`` one at a time."""
    mf = JaxSystem(JaxConfig()) if which == "jax" else \
        TorchSystem(device="cpu")
    for s in sessions:
        mf.ingest_session(s)
    return mf


@pytest.fixture(scope="module")
def wls():
    """(JAX package's workload, the port's): the same sessions and queries."""
    return jax_workload(**KW), torch_workload(**KW)


def _pair(wls, fn):
    """(port's result, JAX package's result) of ``fn(which, workload)``."""
    wj, wt = wls
    return fn("torch", wt), fn("jax", wj)


def _arena_matches_trees(forest):
    """Every node of every tree has a distinct arena row holding its
    embedding, bitwise."""
    arena, row_maps = forest.node_arena()
    seen = set()
    for tree in forest.trees.values():
        # a tree compacted to no nodes before its first sync has no row map
        rows = row_maps.get(tree.tree_id, np.zeros(0, np.int32))[:tree._n]
        assert (rows >= 0).all() and len(set(rows.tolist())) == tree._n
        assert not seen & set(rows.tolist()), tree.scope_key
        seen |= set(rows.tolist())
        got = arena[torch.from_numpy(rows).long()].numpy()
        assert got.tobytes() == tree.emb[:tree._n].tobytes(), tree.scope_key


# ---------------------------------------------------------------------------
# tests/test_maintenance.py, in both packages
# ---------------------------------------------------------------------------
def test_delete_session_locality(wls):
    def run(which, w):
        mf = _build(which, w.sessions)
        before = mf.scale_stats()
        refreshes_before = mf.forest.summary_refreshes
        stats = mf.delete_session(w.sessions[0].session_id)
        after = mf.scale_stats()
        assert stats["leaves_removed"] > 0
        assert after["facts"] <= before["facts"]
        touched = mf.forest.summary_refreshes - refreshes_before
        assert touched < before["nodes"] * 0.5, (touched, before["nodes"])
        for t in mf.forest.trees.values():
            t.check_invariants()
        return mf, stats, [mf.query(q).answer for q in w.queries]

    (t, st_, at), (j, sj, aj) = _pair(wls, run)
    assert st_ == sj and at == aj
    same_state(t, j, digest=False)


def test_migration_merge_preserves_scale(wls):
    """Paper Table 10: merged state ~= sequentially-built state."""
    def run(which, w):
        half = len(w.sessions) // 2
        seq = _build(which, w.sessions)
        a = _build(which, w.sessions[:half])
        stats = a.merge_from(_build(which, w.sessions[half:]))
        s_seq, s_mig = seq.scale_stats(), a.scale_stats()
        assert abs(s_mig["facts"] - s_seq["facts"]) <= \
            max(1, 0.01 * s_seq["facts"])
        assert abs(s_mig["trees"] - s_seq["trees"]) <= \
            max(2, 0.15 * s_seq["trees"])
        for t in a.forest.trees.values():
            t.check_invariants()
        return a, stats

    (t, st_), (j, sj) = _pair(wls, run)
    assert st_ == sj
    same_state(t, j, digest=False)


def test_migration_merge_answers_queries(wls):
    def run(which, w):
        half = len(w.sessions) // 2
        a = _build(which, w.sessions[:half])
        a.merge_from(_build(which, w.sessions[half:]))
        seq = _build(which, w.sessions)
        got = [a.query(q).answer for q in w.queries]
        same = sum(x == seq.query(q).answer for x, q in zip(got, w.queries))
        assert same >= len(w.queries) * 0.8, f"merged answers diverge: {same}"
        return got

    t, j = _pair(wls, run)
    assert t == j


def test_merge_copies_unmatched_trees_without_refresh(wls):
    def run(which, w):
        a = _build(which, w.sessions[:2])
        b = _build(which, w.sessions[2:4])
        before = a.forest.summary_refreshes
        stats = a.merge_from(b)
        touched = a.forest.summary_refreshes - before
        assert stats["trees_copied"] > 0
        assert touched < sum(t.num_nodes for t in a.forest.trees.values())
        return a, stats, touched

    (t, st_, tt), (j, sj, tj) = _pair(wls, run)
    assert (st_, tt) == (sj, tj)
    same_state(t, j, digest=False)


def test_rematerialize_new_branching(wls):
    def run(which, w):
        mf = _build(which, w.sessions[:4])
        mod = jax_maintenance if which == "jax" else torch_maintenance
        f2 = mod.rematerialize(mf.forest, new_branching=3)
        assert f2.scale_stats()["facts"] == mf.scale_stats()["facts"]
        for t in f2.trees.values():
            t.check_invariants()
            assert all(len(t.children[i]) <= 3 for i in range(t._n)
                       if t.alive[i] and t.level[i] > 0)
        return f2

    t, j = _pair(wls, run)
    same_state(t, j, digest=False)
    assert t.device == torch.device("cpu")


def test_migrate_merge_rerun_with_key_is_noop(wls):
    def run(which, w):
        pers = jax_persistence if which == "jax" else torch_persistence
        half = len(w.sessions) // 2
        a = _build(which, w.sessions[:half])
        b = _build(which, w.sessions[half:])
        assert a.merge_from(b, idempotency_key="mig:ab")[
            "skipped_duplicate"] == 0
        d0, s0 = pers.forest_state_digest(a.forest), a.scale_stats()
        second = a.merge_from(b, idempotency_key="mig:ab")
        assert second["skipped_duplicate"] == 1
        assert second["facts_added"] == second["facts_merged"] == 0
        assert a.scale_stats() == s0
        assert pers.forest_state_digest(a.forest) == d0
        return a

    t, j = _pair(wls, run)
    same_state(t, j, digest=False)


def test_migrate_merge_dedups_sources_and_registry(wls):
    def run(which, w):
        half = len(w.sessions) // 2
        a = _build(which, w.sessions[:half])
        b = _build(which, w.sessions[half:])
        a.merge_from(b)
        a.merge_from(b)
        for f in a.forest.facts:
            assert len(f.sources) == len(set(map(tuple, f.sources)))
        for sid, reg in a.forest.session_registry.items():
            assert len(reg["facts"]) == len(set(reg["facts"])), sid
        return a

    t, j = _pair(wls, run)
    same_state(t, j, digest=False)


def test_rematerialize_does_not_alias_source_forest(wls):
    """rematerialize() returns an independent forest: mutating the copy
    leaves the source forest byte-identical."""
    w = wls[1]
    mf = _build("torch", w.sessions[:4])
    d0 = torch_persistence.forest_state_digest(mf.forest)
    f2 = torch_maintenance.rematerialize(mf.forest, new_branching=4)
    jf = _build("jax", wls[0].sessions[:4])
    jd = jax_persistence.forest_state_digest(jf.forest)
    j2 = jax_maintenance.rematerialize(jf.forest, new_branching=4)
    same_state(f2, j2, digest=False)
    assert f2.fact_emb is not mf.forest.fact_emb
    assert all(c2 is not c1 for c1, c2 in zip(mf.forest.cells, f2.cells))
    assert all(g.sources is not f.sources
               for f, g in zip(mf.forest.facts, f2.facts))
    torch_maintenance.delete_session(f2, w.sessions[0].session_id)
    f2.fact_emb[: len(f2.facts)] = 0.0
    for c in f2.cells:
        c.text = "clobbered"
    assert torch_persistence.forest_state_digest(mf.forest) == d0
    jax_maintenance.delete_session(j2, wls[0].sessions[0].session_id)
    assert jax_persistence.forest_state_digest(jf.forest) == jd


# ---------------------------------------------------------------------------
# tests/test_persistence.py, in both packages
# ---------------------------------------------------------------------------
PKW = dict(num_entities=5, num_sessions=8, transitions_per_entity=3,
           num_queries=20, seed=9)


@pytest.fixture(scope="module")
def built():
    """(port's system, JAX package's, port's workload, JAX's), each
    ingested one session at a time."""
    wj, wt = jax_workload(**PKW), torch_workload(**PKW)
    return _build("torch", wt.sessions), _build("jax", wj.sessions), wt, wj


def _load(which, path, **kw):
    if which == "jax":
        return JaxSystem.load(path, **kw)
    return TorchSystem.load(path, device="cpu", **kw)


def _mode_answers(mf, w, mode="llm+planner"):
    return [mf.query(q, mode=mode).answer for q in w.queries]


def test_roundtrip_with_derived(built, tmp_path):
    t, j, wt, wj = built
    out = {}
    for which, mf, w in (("torch", t, wt), ("jax", j, wj)):
        p = str(tmp_path / f"{which}.mfz")
        mf.save(p)
        mf2 = _load(which, p)
        assert mf2.scale_stats() == mf.scale_stats()
        assert _mode_answers(mf2, w) == _mode_answers(mf, w)
        for tr in mf2.forest.trees.values():
            tr.check_invariants()
        out[which] = mf2
    same_state(out["torch"], out["jax"], digest=False)


def test_rematerialize_derived_from_persistent_state(built, tmp_path):
    """Drop every derived artifact and regenerate it from canonical facts +
    structure (one tree_refresh launch per level) — as the JAX package
    does."""
    t, j, wt, wj = built
    out = {}
    for which, mf, w in (("torch", t, wt), ("jax", j, wj)):
        p = str(tmp_path / f"{which}_thin.mfz")
        mf.save(p, with_derived=False)
        mf2 = _load(which, p, rematerialize_derived=True)
        assert mf2.scale_stats() == mf.scale_stats()
        a1, a2 = _mode_answers(mf, w), _mode_answers(mf2, w)
        assert sum(x == y for x, y in zip(a1, a2)) >= len(a1) * 0.9
        tr = next(iter(mf2.forest.trees.values()))
        for nid in range(tr._n):
            if tr.alive[nid] and tr.level[nid] > 0:
                assert abs(np.linalg.norm(tr.emb[nid]) - 1.0) < 1e-3
        out[which] = (mf2, a2)
    same_state(out["torch"][0], out["jax"][0], digest=False)
    assert out["torch"][1] == out["jax"][1]


def test_load_then_continue_ingesting(built, tmp_path):
    t, j, _, _ = built
    out = {}
    for which, mf in (("torch", t), ("jax", j)):
        p = str(tmp_path / f"{which}2.mfz")
        mf.save(p)
        mf2 = _load(which, p)
        wf = jax_workload if which == "jax" else torch_workload
        extra = wf(num_entities=3, num_sessions=2, num_queries=1, seed=123)
        before = mf2.scale_stats()["facts"]
        for s in extra.sessions:
            mf2.ingest_session(s)
        assert mf2.scale_stats()["facts"] > before
        for tr in mf2.forest.trees.values():
            tr.check_invariants()
        out[which] = mf2
    same_state(out["torch"], out["jax"], digest=False)


def test_deleted_facts_stay_dead_after_save_load(tmp_path):
    """save -> delete -> save -> load must NOT resurrect deleted facts, in
    the host index rows, the device index, or retrieval."""
    kw = dict(num_entities=5, num_sessions=8, transitions_per_entity=3,
              num_queries=20, seed=13)
    out = {}
    for which, wf in (("torch", torch_workload), ("jax", jax_workload)):
        w = wf(**kw)
        mf = JaxSystem(JaxConfig()) if which == "jax" else \
            TorchSystem(device="cpu")
        mf.ingest_batch(w.sessions)
        mf.save(str(tmp_path / f"{which}_pre.mfz"))
        dead = []
        for s in w.sessions:
            mf.delete_session(s.session_id)
            dead = [f.fact_id for f in mf.forest.facts
                    if not mf.forest.fact_alive[f.fact_id]]
            if dead:
                break
        assert dead, "workload produced no fully-dead facts"
        want = [r.answer for r in mf.query_batch(w.queries)]
        p = str(tmp_path / f"{which}_post.mfz")
        mf.save(p)
        mf2 = _load(which, p)
        for fid in dead:
            assert not mf2.forest.fact_alive[fid]
            assert np.linalg.norm(mf2.forest.fact_emb[fid]) == 0.0
            assert mf2.forest.facts[fid].emb is not None
        dev, _n = mf2.forest.fact_index_device()
        devnp = dev.numpy() if which == "torch" else np.asarray(dev)
        for fid in dead:
            assert float(np.abs(devnp[fid]).max()) == 0.0
        for q in w.queries:
            facts, _evidence, _stats = mf2.retriever.retrieve(q.text)
            assert all(mf2.forest.fact_alive[f.fact_id] for f in facts)
        got = [r.answer for r in mf2.query_batch(w.queries)]
        assert got == want
        out[which] = (mf2, dead, got)
    assert out["torch"][1:] == out["jax"][1:]
    same_state(out["torch"][0], out["jax"][0], digest=False)


# ---------------------------------------------------------------------------
# the node arena after a tree is replaced under its tree id
# ---------------------------------------------------------------------------
def _churn(which, w):
    """Ingest, query (the arena syncs every node), delete half the sessions,
    compact every churned tree."""
    mf = JaxSystem(JaxConfig()) if which == "jax" else \
        TorchSystem(device="cpu")
    mf.ingest_batch(w.sessions)
    mf.query_batch(w.queries, mode="llm")
    for s in w.sessions[: len(w.sessions) // 2]:
        mf.delete_session(s.session_id)
    mod = jax_maintenance if which == "jax" else torch_maintenance
    scopes = mod.compaction_candidates(mf.forest, min_dead_fraction=0.3)
    stats = [mod.compact_tree(mf.forest, k) for k in scopes]
    return mf, scopes, stats


def test_arena_after_compaction_matches_trees_and_browse(wls):
    """After compaction the arena holds every tree's rows bitwise and the
    browse answers as the JAX package does, in all six modes. A compaction
    that put the new tree in ``forest.trees`` directly (as the JAX package
    does, having no arena) would leave the old tree's rows under the new
    tree's node ids."""
    wj, wt = wls
    t, scopes, st_ = _churn("torch", wt)
    j, sj, sjs = _churn("jax", wj)
    assert scopes == sj and st_ == sjs
    assert any(s["slots_reclaimed"] > 0 for s in st_)
    at, aj = answers(t, wt.queries), answers(j, wj.queries)
    assert at == aj
    _arena_matches_trees(t.forest)
    same_state(t, j, digest=False)
    # the answers the port gives after a detach (a fresh arena) are the same
    t.detach_device()
    assert answers(t, wt.queries) == at


def test_arena_after_copy_into_an_emptied_tree():
    """A merge copies a source tree verbatim into a destination tree that
    deletions emptied (root < 0, nodes left): the copy overwrites its node
    ids, so the arena rewrites the tree's rows."""
    kw = dict(num_entities=3, num_sessions=4, transitions_per_entity=2,
              num_queries=6, seed=21)
    out = {}
    for which, wf in (("torch", torch_workload), ("jax", jax_workload)):
        w = wf(**kw)
        mf = _build(which, w.sessions[:2])
        mf.query_batch(w.queries, mode="emb")        # arena holds the rows
        victim = next(k for k, tr in mf.forest.trees.items()
                      if tr.kind == "session")
        sid = victim.split(":", 1)[1]
        mf.delete_session(sid)
        assert mf.forest.trees[victim].root < 0
        # the same session id from another seed: the same scope key, other
        # nodes
        other = wf(**{**kw, "seed": 22}).sessions
        src = _build(which, [s for s in other if s.session_id == sid])
        stats = mf.merge_from(src)
        assert stats["trees_copied"] > 0
        assert mf.forest.trees[victim].root >= 0
        out[which] = (mf, w, stats)
    (t, wt, st_), (j, wj, sj) = out["torch"], out["jax"]
    assert st_ == sj
    _arena_matches_trees(t.forest)
    same_state(t, j, digest=False)
    assert answers(t, wt.queries) == answers(j, wj.queries)


def test_arena_reuses_a_replaced_trees_rows():
    """A compacted tree is written into the rows its old nodes held: rounds
    of ingest, deletion and compaction leave the arena at the most nodes
    each tree has had, where fresh rows at every compaction would grow it
    with each round."""
    w = torch_workload(num_entities=3, num_sessions=12,
                       transitions_per_entity=2, num_queries=6, seed=23)
    mf = TorchSystem(device="cpu")
    most = {}

    def sync():
        mf.query_batch(w.queries, mode="emb")       # the arena syncs
        for t in mf.forest.trees.values():
            most[t.tree_id] = max(most.get(t.tree_id, 0), t._n)
        assert mf.forest._arena_used == sum(most.values())
        _arena_matches_trees(mf.forest)

    compacted = 0
    for r in range(3):
        part = w.sessions[4 * r:4 * r + 4]
        mf.ingest_batch(part)
        sync()
        for s in part[:2]:
            mf.delete_session(s.session_id)
        sync()
        for k in torch_maintenance.compaction_candidates(
                mf.forest, min_dead_fraction=0.3):
            compacted += torch_maintenance.compact_tree(
                mf.forest, k)["slots_reclaimed"] > 0
        sync()
    assert compacted >= 3


def test_flush_only_and_kill_fact_match_the_jax_forest(wls):
    """``Forest.flush(only=...)`` refreshes exactly the named dirty trees,
    and ``kill_fact`` zeroes the fact's host and device rows."""
    def run(which, w):
        mf = JaxSystem(JaxConfig()) if which == "jax" else \
            TorchSystem(device="cpu")
        mf.ingest_batch(w.sessions, defer_flush=True)
        some = sorted(mf.forest.dirty_trees)[:3]
        out = mf.forest.flush(only=set(some) | {"not-a-tree"})
        left = sorted(mf.forest.dirty_trees)
        mf.forest.fact_index_device()
        mf.forest.kill_fact(0)
        dev, _ = mf.forest.fact_index_device()
        row = dev[0].numpy() if which == "torch" else np.asarray(dev[0])
        assert not mf.forest.fact_alive[0] and not row.any()
        assert not mf.forest.fact_emb[0].any()
        return mf, out, left

    (t, ot, lt), (j, oj, lj) = _pair(wls, run)
    assert (ot, lt) == (oj, lj)
    same_state(t, j, digest=False)


# ---------------------------------------------------------------------------
# the serve engine's maintenance lane, on both packages' engines
# (tests/test_pipeline_serving.py::test_maintenance_lane_defers_flush_off_
# serve_loop)
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def models():
    jc = jax_smoke_config("llama3_8b").replace(dtype="float32",
                                               param_dtype="float32")
    tc = get_smoke_config("llama3_8b").replace(dtype="float32",
                                               param_dtype="float32")
    jm, tm = jax_get_model(jc), get_model(tc)
    jp = jm.init(jax.random.key(0))
    tp = transformer_params_from_numpy(jax.tree.map(np.asarray, jp), tc,
                                       device="cpu")
    return (jm, jp), (tm, tp)


def test_maintenance_lane_defers_flush_off_serve_loop(models):
    """With a MaintenancePlane attached, ingest drains defer their flush and
    the engine retires refresh work in bounded slices between decode steps
    — answers stay identical to the inline-flush memory, and both packages'
    engines give the same tokens, counters and answers."""
    kw = dict(num_entities=4, num_sessions=6, transitions_per_entity=3,
              num_queries=10, seed=22)
    (jm, jp), (tm, tp) = models
    out = {}
    for which, wf in (("torch", torch_workload), ("jax", jax_workload)):
        w = wf(**kw)
        ref = JaxSystem(JaxConfig()) if which == "jax" else \
            TorchSystem(device="cpu")
        ref.ingest_batch(w.sessions)
        want = [r.answer for r in ref.query_batch(w.queries)]
        mf = JaxSystem(JaxConfig()) if which == "jax" else \
            TorchSystem(device="cpu")
        flushes = []
        if which == "torch":
            real = mf.ingest_batch

            def spy(sessions, **kwargs):
                before = mf.forest.flush_calls
                res = real(sessions, **kwargs)
                flushes.append(mf.forest.flush_calls - before)
                return res

            mf.ingest_batch = spy
        Plane, Engine = (JaxPlane, JaxEngine) if which == "jax" else \
            (TorchPlane, ServeEngine)
        model, params = (jm, jp) if which == "jax" else (tm, tp)
        plane = Plane(mf.forest, flush_trees_per_unit=2)
        eng = Engine(model, params, max_batch=2, max_len=32, memory=mf,
                     maintenance=plane, maintenance_budget=2)
        for s in w.sessions:
            eng.submit_session(s)
        eng.submit([5, 6, 7], max_new_tokens=2)
        eng.run_until_drained()
        m = eng.metrics()
        assert m["maintenance_turns"] > 0
        assert m["maintenance_pending"] == 0
        assert not mf.forest.dirty_trees
        rids = [eng.submit_query(q) for q in w.queries]
        eng.run_until_drained()
        got = [eng.pop_query_result(r).answer for r in rids]
        assert got == want
        if which == "torch":
            assert flushes and not any(flushes)   # no drain flushed inline
        out[which] = (eng, mf, got, m)
    (te, tmf, tg, tmm), (je, jmf, jg, jmm) = out["torch"], out["jax"]
    assert tg == jg
    assert {k: v for k, v in jmm.items() if k in tmm
            and k.startswith(("maintenance", "ingest_", "decode", "query"))
            and not k.endswith("_s")} == \
        {k: v for k, v in tmm.items()
         if k.startswith(("maintenance", "ingest_", "decode", "query"))
         and not k.endswith("_s")}
    assert sorted(r.out_tokens for r in te.finished) == \
        sorted(r.out_tokens for r in je.finished)
    same_state(tmf, jmf, digest=False)


def test_engine_lane_holds_the_plane_lock_with_a_background_worker(models):
    """With the plane's worker running and the engine's budget 0, the
    engine's drains take the plane's lock: a drain cannot run while another
    thread holds it."""
    import threading
    (_, _), (tm, tp) = models
    w = torch_workload(num_entities=3, num_sessions=3, num_queries=3, seed=4)
    mf = TorchSystem(device="cpu")
    plane = TorchPlane(mf.forest)
    eng = ServeEngine(tm, tp, max_batch=2, max_len=32, memory=mf,
                      maintenance=plane, maintenance_budget=0)
    for s in w.sessions:
        eng.submit_session(s)
    held, done = threading.Event(), threading.Event()

    def hold():
        with plane.lock:
            held.set()
            done.wait(timeout=10)

    th = threading.Thread(target=hold)
    th.start()
    held.wait(timeout=10)
    runner = threading.Thread(target=eng.run_until_drained)
    runner.start()
    runner.join(timeout=0.3)
    assert runner.is_alive() and mf.forest.facts == []   # blocked on the lock
    done.set()
    runner.join(timeout=30)
    th.join(timeout=10)
    assert not runner.is_alive() and not th.is_alive()
    assert eng.ingest_sessions == 3 and mf.forest.facts
    plane.start_background(interval_s=0.001)
    plane.stop_background(drain_first=True)
    assert not mf.forest.dirty_trees
    assert eng.metrics()["maintenance_turns"] == 0
