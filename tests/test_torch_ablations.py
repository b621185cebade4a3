"""The write-path ablations of the paper's Figure 6 in the port against the
JAX package, on the same seeded inputs:

- ``MemForestSystem(eager=True)`` (a refresh per insert, Fig. 6a): exact fact
  ids, tree shapes, placement, ``summary_refreshes``, the per-session write
  stats (``llm_dependency_depth`` has no flush depth) and answers in the six
  browse modes; node embeddings and the root index within 1e-5;
- the per-node flush (Fig. 6c), as ``flush(level_parallel=False)`` and as
  ``MemForestConfig(level_parallel=False)``: exact ``kernel_calls``,
  ``refreshes`` and levels of every flush; embeddings within 1e-5;
- ``Forest.eager_refresh_path``'s return values, exactly;
- the host views ``root_index()`` and ``fact_index()``: exact counts, order
  and capacity, matrices within 1e-6, also after a deletion;
- the node arena the browse gathers from, bitwise equal to every tree after
  each eager refresh and after a per-node flush;
- ``benchmarks/bench_tree_scaling.py``'s three sweeps at their smallest sizes
  in the JAX package against ``chip_smoke.py``'s sweeps of the port on the
  CPU: equal counters, root recall and heights.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from benchmarks import bench_tree_scaling as jax_bench
from repro.config import MemForestConfig as JaxConfig
from repro.core.forest import Forest as JaxForest
from repro.core.memforest import MemForestSystem as JaxSystem
from repro.data.synthetic import make_workload
from repro_torch import MemForestConfig, MemForestSystem
from repro_torch.core.forest import Forest
from repro_torch.data.synthetic import make_workload as torch_make_workload

import chip_smoke
from test_torch_memforest import MODES, SharedEncoder, _arena_matches_trees

SEEDS = [11, 3]
BATCH = 4
KW = dict(num_entities=5, num_sessions=10, num_queries=12)


def _workloads(seed):
    return (make_workload(**KW, seed=seed),
            torch_make_workload(**KW, seed=seed))


def _ingest(mf, sessions, **kw):
    stats = []
    for i in range(0, len(sessions), BATCH):
        stats += mf.ingest_batch(sessions[i:i + BATCH], **kw)
    return stats


def _answers(mf, queries):
    return {m: [(r.answer, r.evidence) for r in mf.query_batch(queries, mode=m)]
            for m in MODES}


def _write_sig(stats):
    return [(s.llm_dependency_depth, s.summary_refreshes, s.facts_written,
             s.encoder_calls) for s in stats]


def _same_trees(j, t):
    assert list(t.trees) == list(j.trees)
    for key, tj in j.trees.items():
        tt = t.trees[key]
        assert (tt.kind, tt.children, tt.level, tt.root, tt.parent, tt.text) \
            == (tj.kind, tj.children, tj.level, tj.root, tj.parent,
                tj.text), key
        n = len(tj.level)
        np.testing.assert_allclose(tt.emb[:n], tj.emb[:n], atol=1e-5)


def _root_cache_matches_host(forest):
    """The device root cache holds every root row of the host, normalized."""
    dev, n, order = forest.root_index_device()
    host = forest._root_matrix[:n]
    want = host / np.maximum(np.linalg.norm(host, axis=1, keepdims=True),
                             1e-12)
    np.testing.assert_allclose(dev[:n].numpy(), want, atol=1e-6)
    assert order == forest._tree_order


# ---------------------------------------------------------------------------
# eager mode (Fig. 6a)
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module", params=[(s, v) for s in SEEDS
                                        for v in ("own", "shared")],
                ids=lambda p: f"seed{p[0]}-{p[1]}")
def eager_pair(request):
    seed, variant = request.param
    wl_j, wl_t = _workloads(seed)
    j = JaxSystem(eager=True)
    enc = SharedEncoder() if variant == "shared" else None
    t = MemForestSystem(encoder=enc, device="cpu", eager=True)
    sj, st = _ingest(j, wl_j.sessions), _ingest(t, wl_t.sessions)
    return (j, t, sj, st, _answers(j, wl_j.queries),
            _answers(t, wl_t.queries))


def test_eager_state_and_counters_exact(eager_pair):
    j, t, sj, st, _, _ = eager_pair
    assert [(f.fact_id, f.text, f.value) for f in t.forest.facts] == \
        [(f.fact_id, f.text, f.value) for f in j.forest.facts]
    assert t.scale_stats() == j.scale_stats()
    _same_trees(j.forest, t.forest)
    assert t.forest.placement == j.forest.placement
    assert t.forest.session_registry == j.forest.session_registry
    assert t.forest.summary_refreshes == j.forest.summary_refreshes > 0
    # eager mode flushes nothing: no flush depth in the write stats
    assert t.forest.flush_calls == j.forest.flush_calls == 0
    assert _write_sig(st) == _write_sig(sj)
    assert not t.forest.dirty_trees
    n = len(j.forest._tree_order)
    np.testing.assert_allclose(t.forest._root_matrix[:n],
                               j.forest._root_matrix[:n], atol=1e-5)


@pytest.mark.parametrize("mode", MODES)
def test_eager_answers_exact(eager_pair, mode):
    _, _, _, _, aj, at = eager_pair
    assert at[mode] == aj[mode]


def test_eager_equals_lazy_but_for_the_counters():
    """Eager and lazy ingest of one workload give the same trees, placement
    and answers; eager refreshes more summaries and reports no flush."""
    wl = torch_make_workload(**KW, seed=11)
    lazy, eager = (MemForestSystem(device="cpu", eager=e) for e in (False,
                                                                     True))
    sl, se = _ingest(lazy, wl.sessions), _ingest(eager, wl.sessions)
    _same_trees(lazy.forest, eager.forest)
    assert lazy.forest.placement == eager.forest.placement
    assert _answers(lazy, wl.queries) == _answers(eager, wl.queries)
    assert eager.forest.summary_refreshes > lazy.forest.summary_refreshes
    assert all(a.llm_dependency_depth > b.llm_dependency_depth
               for a, b in zip(sl, se))


def test_eager_arena_and_root_cache_follow_every_refresh():
    """An eager tree refreshes nodes whose children change again one insert
    later: after every insert and its refresh, the node arena equals the
    tree and the device root cache equals the host root rows."""
    rng = np.random.default_rng(5)
    embs = chip_smoke.unit_rows(rng, 80)
    f = Forest(MemForestConfig(embed_dim=chip_smoke.ABLATION_DIM), "cpu")
    for i in range(embs.shape[0]):
        f.insert_item(f"entity:{i % 2}", "entity", "fact", i, float(i),
                      embs[i], f"f{i}")
        f.eager_refresh_path(f"entity:{i % 2}")
        _arena_matches_trees(f)
        _root_cache_matches_host(f)


def test_eager_system_arena_after_each_session():
    wl = torch_make_workload(**KW, seed=3)
    mf = MemForestSystem(device="cpu", eager=True)
    for s in wl.sessions:
        mf.ingest_session(s)
        _arena_matches_trees(mf.forest)
        _root_cache_matches_host(mf.forest)


@pytest.mark.parametrize("n", [1, 9, 64])
def test_eager_refresh_path_returns_the_reference_calls(n):
    embs = chip_smoke.unit_rows(np.random.default_rng(n), n)
    j = JaxForest(JaxConfig(embed_dim=chip_smoke.ABLATION_DIM))
    t = Forest(MemForestConfig(embed_dim=chip_smoke.ABLATION_DIM), "cpu")
    calls = {"jax": [], "torch": []}
    for i in range(n):
        for tag, f in (("jax", j), ("torch", t)):
            f.insert_item("entity:a", "entity", "fact", i, float(i), embs[i],
                          f"f{i}")
            calls[tag].append(f.eager_refresh_path("entity:a"))
    assert calls["torch"] == calls["jax"]
    assert (t.summary_refreshes, t.flush_levels) == \
        (j.summary_refreshes, j.flush_levels) == (sum(calls["jax"]), 0)
    _same_trees(j, t)
    _arena_matches_trees(t)


# ---------------------------------------------------------------------------
# the per-node flush (Fig. 6c)
# ---------------------------------------------------------------------------
def _record_flushes(forest):
    """Wrap ``forest.flush`` to keep what every call returns."""
    seen, orig = [], forest.flush

    def flush(**kw):
        out = orig(**kw)
        seen.append(out)
        return out
    forest.flush = flush
    return seen


@pytest.mark.parametrize("seed", SEEDS)
def test_per_node_flush_argument_matches_reference(seed):
    wl_j, wl_t = _workloads(seed)
    j, t = JaxSystem(), MemForestSystem(device="cpu")
    _ingest(j, wl_j.sessions, defer_flush=True)
    _ingest(t, wl_t.sessions, defer_flush=True)
    oj = j.forest.flush(level_parallel=False)
    ot = t.forest.flush(level_parallel=False)
    assert ot == oj and ot["kernel_calls"] > ot["levels"] > 0
    assert (t.forest.summary_refreshes, t.forest.flush_levels) == \
        (j.forest.summary_refreshes, j.forest.flush_levels)
    _same_trees(j.forest, t.forest)
    _arena_matches_trees(t.forest)
    _root_cache_matches_host(t.forest)
    assert _answers(t, wl_t.queries) == _answers(j, wl_j.queries)


@pytest.mark.parametrize("seed", SEEDS)
def test_per_node_config_matches_reference(seed):
    """``MemForestConfig(level_parallel=False)`` is accepted, and every flush
    of the batched ingest launches once per node, as the reference's."""
    wl_j, wl_t = _workloads(seed)
    j = JaxSystem(JaxConfig(level_parallel=False))
    t = MemForestSystem(MemForestConfig(level_parallel=False), device="cpu")
    lazy = MemForestSystem(device="cpu")
    fj, ft, fl = (_record_flushes(s.forest) for s in (j, t, lazy))
    _ingest(j, wl_j.sessions)
    _ingest(t, wl_t.sessions)
    _ingest(lazy, wl_t.sessions)
    assert ft == fj and len(ft) == len(wl_t.sessions) // BATCH + 1
    assert [o["refreshes"] for o in fl] == [o["refreshes"] for o in ft]
    assert sum(o["kernel_calls"] for o in fl) < \
        sum(o["kernel_calls"] for o in ft)
    _same_trees(j.forest, t.forest)
    _same_trees(lazy.forest, t.forest)
    _arena_matches_trees(t.forest)
    assert _answers(t, wl_t.queries) == _answers(j, wl_j.queries)


# ---------------------------------------------------------------------------
# the host views of the derived indexes
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("seed", SEEDS)
def test_host_index_views_match_reference(seed):
    wl_j, wl_t = _workloads(seed)
    j, t = JaxSystem(), MemForestSystem(encoder=SharedEncoder(), device="cpu")
    _ingest(j, wl_j.sessions)
    _ingest(t, wl_t.sessions)
    for step in ("ingest", "delete"):
        rj, nrj, oj = j.forest.root_index()
        rt, nrt, ot = t.forest.root_index()
        assert (nrt, ot, rt.shape) == (nrj, oj, rj.shape)
        np.testing.assert_allclose(rt[:nrt], rj[:nrj], atol=1e-6)
        fj, nfj = j.forest.fact_index()
        ft, nft = t.forest.fact_index()
        assert (nft, ft.shape) == (nfj, fj.shape)
        np.testing.assert_allclose(ft[:nft], fj[:nfj], atol=1e-6)
        assert t.forest.fact_alive == j.forest.fact_alive
        if step == "ingest":
            sid = wl_j.sessions[0].session_id
            j.delete_session(sid)
            t.delete_session(sid)
    assert not all(t.forest.fact_alive)
    dead = [i for i, a in enumerate(t.forest.fact_alive) if not a]
    assert not t.forest.fact_index()[0][dead].any()


# ---------------------------------------------------------------------------
# bench_tree_scaling's sweeps: the JAX package's bench against the port's
# ---------------------------------------------------------------------------
def _bench_rows(capsys, fn, **kw):
    """{row name: {key: value}} of what one of the bench's sweeps prints."""
    capsys.readouterr()
    fn(**kw)
    rows = {}
    for line in capsys.readouterr().out.splitlines():
        name, _, derived = line.split(",", 2)
        rows[name] = dict(kv.split("=") for kv in derived.split(";"))
    return rows


def test_lazy_vs_eager_sweep_matches_the_bench(capsys):
    want = _bench_rows(capsys, jax_bench.lazy_vs_eager, sizes=(64,))
    (n, lazy, eager), = chip_smoke.lazy_vs_eager(torch, "cpu", sizes=(64,))
    row = want[f"lazy_vs_eager_N{n}"]
    assert (lazy[0].summary_refreshes, eager[0].summary_refreshes) == \
        (int(row["lazy_calls"]), int(row["eager_calls"]))
    # on the CPU every launch is a plain call: one a level, one a node
    assert (lazy[2], eager[2]) == (0, 0)
    assert eager[3] == eager[0].summary_refreshes > lazy[3] > 0
    assert chip_smoke.tree_shape(lazy[0]) == chip_smoke.tree_shape(eager[0])


def test_level_parallel_sweep_matches_the_bench(capsys):
    want = _bench_rows(capsys, jax_bench.level_parallel, sizes=(64,))
    (n, fa, ra, fb, rb), = chip_smoke.level_parallel(torch, "cpu", sizes=(64,))
    row = want[f"level_parallel_N{n}"]
    assert (ra[0]["kernel_calls"], rb[0]["kernel_calls"]) == \
        (int(row["kernel_calls_par"]), int(row["kernel_calls_seq"]))
    assert (ra[3], rb[3]) == (ra[0]["kernel_calls"], rb[0]["kernel_calls"])
    assert chip_smoke.tree_shape(fa) == chip_smoke.tree_shape(fb)
    np.testing.assert_allclose(fa.trees["entity:a"].emb,
                               fb.trees["entity:a"].emb, atol=1e-5)


def test_k_sweep_matches_the_bench(capsys):
    want = _bench_rows(capsys, jax_bench.k_sweep)
    got = chip_smoke.k_sweep(torch, "cpu", checked=chip_smoke.K_CHECKED)
    assert [k for k, *_ in got] == list(chip_smoke.K_SWEEP)
    for k, hits, height, err in got:
        row = want[f"ksweep_k{k}"]
        assert (f"{sum(hits) / len(hits):.3f}", height) == \
            (row["root_recall"], int(row["height"]))
        # the recorded flushes against the plain version: 0 on the CPU
        assert (err == 0.0) if k in chip_smoke.K_CHECKED else err is None


def test_refresh_recorder_restores_the_entry():
    from repro_torch.kernels import ops
    orig = ops.tree_refresh
    f = chip_smoke.one_tree("cpu", chip_smoke.unit_rows(
        np.random.default_rng(0), 20))
    with chip_smoke.RefreshRecorder() as rec:
        f.flush()
    assert ops.tree_refresh is orig
    assert len(rec.calls) == f.flush_levels > 0 and rec.max_err() == 0.0
