"""The slice as a whole: ``repro_torch.MemForestSystem(device="cpu")`` against
the JAX package's ``MemForestSystem`` on the same workload, ingested with
``ingest_batch`` in batches of 4 and queried in all six browse modes.

Exact: fact ids and texts, cells, scale_stats, every tree's children, levels
and root, placement, the session registry, answers and evidence. Within
1e-5: node embeddings and the root index.

Two variants: ``own`` gives each package its own encoder; ``shared`` feeds
both the JAX encoder's embeddings, so a threshold decision (canonical merge
at 0.92, scene routing at 0.60) cannot flip on an ulp of encoder output.
Then the padding and tie rules the main path depends on, which memlint does
not check in the port."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import encoder as jax_encoder
from repro.core.memforest import MemForestSystem as JaxSystem
from repro.data.synthetic import make_workload
from repro_torch import MemForestConfig, MemForestSystem
from repro_torch.core import forest as torch_forest
from repro_torch.core import retrieval as torch_retrieval
from repro_torch.core.encoder import EncoderStats
from repro_torch.core.retrieval import Retriever, _Lane
from repro_torch.data.synthetic import make_workload as torch_make_workload

MODES = ["flat", "root-only", "emb", "emb+planner", "llm", "llm+planner"]
SEEDS = [11, 3, 29]
BATCH = 4


class SharedEncoder:
    """Test-only encoder for the port that returns the JAX encoder's
    embeddings, with the port's own call accounting."""

    def __init__(self):
        self._jax = jax_encoder.HashingEncoder()
        self.dim = self._jax.dim
        self.stats = EncoderStats()

    def encode(self, texts, *, sequential=False):
        out = self._jax.encode(texts, sequential=sequential)
        self.stats.calls += 1
        self.stats.texts += len(texts)
        return np.asarray(out)

    def encode_one(self, text):
        return self.encode([text])[0]


def _ingest(mf, sessions, batch):
    for i in range(0, len(sessions), batch):
        mf.ingest_batch(sessions[i:i + batch])
    return mf


def _answers(mf, queries):
    return {m: [(r.answer, r.evidence) for r in mf.query_batch(queries, mode=m)]
            for m in MODES}


@pytest.fixture(scope="module", params=[(s, v) for s in SEEDS
                                        for v in ("own", "shared")],
                ids=lambda p: f"seed{p[0]}-{p[1]}")
def pair(request):
    seed, variant = request.param
    kw = dict(num_entities=5, num_sessions=10, num_queries=12, seed=seed)
    wl_j, wl_t = make_workload(**kw), torch_make_workload(**kw)
    j = _ingest(JaxSystem(), wl_j.sessions, BATCH)
    enc = SharedEncoder() if variant == "shared" else None
    t = _ingest(MemForestSystem(encoder=enc, device="cpu"), wl_t.sessions,
                BATCH)
    return j, t, _answers(j, wl_j.queries), _answers(t, wl_t.queries)


def test_facts_and_cells_exact(pair):
    j, t, _, _ = pair
    sig = lambda f: (f.fact_id, f.text, f.subject, f.attribute, f.value, f.ts,
                     f.prev_value, list(f.sources))
    assert [sig(f) for f in t.forest.facts] == [sig(f) for f in j.forest.facts]
    assert [(c.cell_id, c.session_id, c.text) for c in t.forest.cells] == \
        [(c.cell_id, c.session_id, c.text) for c in j.forest.cells]
    assert t.scale_stats() == j.scale_stats()


def test_tree_structure_exact(pair):
    j, t, _, _ = pair
    assert list(t.forest.trees) == list(j.forest.trees)
    for key, tj in j.forest.trees.items():
        tt = t.forest.trees[key]
        assert (tt.kind, tt.children, tt.level, tt.root, tt.parent) == \
            (tj.kind, tj.children, tj.level, tj.root, tj.parent), key
        assert tt.text == tj.text, key
    assert t.forest.placement == j.forest.placement
    assert t.forest.session_registry == j.forest.session_registry


def test_embeddings_and_root_index_close(pair):
    j, t, _, _ = pair
    for key, tj in j.forest.trees.items():
        n = len(tj.level)
        np.testing.assert_allclose(t.forest.trees[key].emb[:n], tj.emb[:n],
                                   atol=1e-5)
    n = len(j.forest._tree_order)
    np.testing.assert_allclose(t.forest._root_matrix[:n],
                               j.forest._root_matrix[:n], atol=1e-5)
    root_dev, nt, order = t.forest.root_index_device()
    assert nt == n and order == j.forest._tree_order
    np.testing.assert_allclose(root_dev[:n].numpy(),
                               np.asarray(j.forest.root_index_device()[0])[:n],
                               atol=1e-5)


@pytest.mark.parametrize("mode", MODES)
def test_answers_and_evidence_exact(pair, mode):
    _, _, aj, at = pair
    assert at[mode] == aj[mode]


def test_batch_size_invariance():
    """Ingesting one session per batch gives the state and answers of
    batches of four."""
    kw = dict(num_entities=5, num_sessions=10, num_queries=12, seed=11)
    wl = torch_make_workload(**kw)
    a = _ingest(MemForestSystem(device="cpu"), wl.sessions, 1)
    b = _ingest(MemForestSystem(device="cpu"), wl.sessions, BATCH)
    assert [f.text for f in a.forest.facts] == [f.text for f in b.forest.facts]
    for key, ta in a.forest.trees.items():
        tb = b.forest.trees[key]
        assert (ta.children, ta.level, ta.root) == (tb.children, tb.level,
                                                    tb.root)
    assert _answers(a, wl.queries) == _answers(b, wl.queries)


def test_single_query_matches_batch():
    wl = torch_make_workload(num_entities=4, num_sessions=8, num_queries=10,
                             seed=5)
    mf = _ingest(MemForestSystem(device="cpu"), wl.sessions, BATCH)
    batched = [r.answer for r in mf.query_batch(wl.queries)]
    assert [mf.query(q).answer for q in wl.queries] == batched


def test_device_bytes_and_detach():
    wl = torch_make_workload(num_entities=3, num_sessions=4, num_queries=4,
                             seed=2)
    mf = _ingest(MemForestSystem(device="cpu"), wl.sessions, BATCH)
    before = [r.answer for r in mf.query_batch(wl.queries)]
    held = mf.device_bytes()
    dim = mf.config.embed_dim
    # the node arena: every node of every tree, in the first capacity of
    # 256 rows
    assert sum(t._n for t in mf.forest.trees.values()) <= 256
    assert held == 4 * dim * (mf.forest.fact_emb.shape[0]
                              + mf.forest._root_matrix.shape[0] + 256)
    assert mf.detach_device() == held and mf.device_bytes() == 0
    assert [r.answer for r in mf.query_batch(wl.queries)] == before


# ---------------------------------------------------------------------------
# the node arena the browse gathers from
# ---------------------------------------------------------------------------
def _arena_matches_trees(forest):
    arena, row_maps = forest.node_arena()
    for tree in forest.trees.values():
        rows = row_maps[tree.tree_id][:tree._n]
        assert (rows >= 0).all() and len(set(rows.tolist())) == tree._n
        got = arena[torch.from_numpy(rows).long()].numpy()
        assert got.tobytes() == tree.emb[:tree._n].tobytes(), tree.scope_key
    return arena


def test_arena_rows_equal_every_tree_row():
    """After every ingest round, flush, and a detach followed by a query,
    the arena's rows are every tree's emb rows, bitwise. Rounds after the
    first refresh parents the arena already holds: a refreshed row the sync
    missed would show here."""
    wl = torch_make_workload(num_entities=5, num_sessions=12, num_queries=6,
                             seed=11)
    mf = MemForestSystem(device="cpu")
    syncs = []
    for i in range(0, len(wl.sessions), BATCH):
        mf.ingest_batch(wl.sessions[i:i + BATCH])
        _arena_matches_trees(mf.forest)
        syncs.append(mf.forest.arena_syncs)
        mf.query_batch(wl.queries, mode="emb")
    # one scatter per ingest round, none for a query after it
    assert syncs == list(range(1, len(syncs) + 1))
    assert mf.forest.arena_syncs == len(syncs)
    mf.ingest_batch(wl.sessions[:2], defer_flush=True)
    mf.forest.flush()
    _arena_matches_trees(mf.forest)
    before = [(r.answer, r.evidence) for r in mf.query_batch(wl.queries)]
    mf.detach_device()
    assert mf.forest._arena is None
    after = [(r.answer, r.evidence) for r in mf.query_batch(wl.queries)]
    assert after == before
    _arena_matches_trees(mf.forest)


def test_score_frontier_uploads_no_children_and_no_query_matrix(monkeypatch):
    """A level passes the kernel the arena, an (F, K) row-id matrix, its mask
    and (F,) lane ids, one buffer of F*K*8 + F*4 bytes; the query rows are
    one per lane, the same tensor at every level of a browse. No argument is
    an (F, K, D) array."""
    seen = _record_shapes(monkeypatch, torch_retrieval, "browse_scores_rows")
    calls = []
    spy = torch_retrieval.ops.browse_scores_rows

    def record(arena, rows, q_rows, lane_of, mask):
        calls.append((arena, rows, q_rows, lane_of, mask))
        return spy(arena, rows, q_rows, lane_of, mask)

    monkeypatch.setattr(torch_retrieval.ops, "browse_scores_rows", record)
    wl = torch_make_workload(num_entities=5, num_sessions=10, num_queries=12,
                             seed=11)
    mf = _ingest(MemForestSystem(device="cpu"), wl.sessions, BATCH)
    lanes = []
    real = torch_retrieval.Retriever._browse_lanes
    monkeypatch.setattr(torch_retrieval.Retriever, "_browse_lanes",
                        lambda self, ls: (lanes.append(len(ls)),
                                          real(self, ls))[1])
    mf.query_batch(wl.queries, mode="llm")
    assert len(lanes) == 1 and len(calls) >= 2, "expected a browse of levels"
    D = mf.config.embed_dim
    for shapes in seen:
        assert all(len(sh) <= 2 for sh in shapes)
    for arena, rows, q_rows, lane_of, mask in calls:
        F, K = rows.shape
        assert q_rows is calls[0][2] and q_rows.shape == (lanes[0], D)
        assert arena is calls[0][0]
        store = rows.untyped_storage()
        assert store.nbytes() == F * K * 8 + F * 4
        for t in (lane_of, mask):
            assert t.untyped_storage().data_ptr() == store.data_ptr()


# ---------------------------------------------------------------------------
# padding and tie rules of the main path
# ---------------------------------------------------------------------------
def _record_shapes(monkeypatch, module, name):
    seen = []
    real = getattr(module.ops, name)

    def spy(*args, **kw):
        seen.append(tuple(tuple(a.shape) for a in args))
        return real(*args, **kw)

    monkeypatch.setattr(module.ops, name, spy)
    return seen


def test_refresh_batch_pads_parents_to_a_power_of_two(monkeypatch):
    seen = _record_shapes(monkeypatch, torch_forest, "tree_refresh")
    wl = torch_make_workload(num_entities=5, num_sessions=10, num_queries=4,
                             seed=11)
    mf = _ingest(MemForestSystem(device="cpu"), wl.sessions, BATCH)
    assert seen, "flush launched no tree_refresh"
    K, D = mf.config.branching_factor, mf.config.embed_dim
    for emb_shape, mask_shape in seen:
        P = emb_shape[0]
        assert P & (P - 1) == 0 and emb_shape[1:] == (K, D)
        assert mask_shape == (P, K)
    assert any(s[0][0] > 1 for s in seen)


def test_browse_frontier_pads_f_to_8_and_k_to_4(monkeypatch):
    seen = _record_shapes(monkeypatch, torch_retrieval, "browse_scores_rows")
    wl = torch_make_workload(num_entities=5, num_sessions=10, num_queries=12,
                             seed=11)
    mf = _ingest(MemForestSystem(device="cpu"), wl.sessions, BATCH)
    mf.query_batch(wl.queries, mode="emb")
    mf.query_batch(wl.queries[:1], mode="emb")    # frontiers under 8 entries
    assert seen
    D = mf.config.embed_dim
    for arena, rows, q, lane_of, mask in seen:
        F, K = rows
        assert F >= 8 and F & (F - 1) == 0
        assert K >= 4 and K & (K - 1) == 0
        assert arena[1] == q[1] == D and lane_of == (F,) and mask == (F, K)
    assert min(rows[0] for _, rows, _, _, _ in seen) == 8


def test_index_sync_scatters_with_the_drop_sentinel(monkeypatch):
    """Incremental syncs pad the update to a power of two with the
    out-of-bounds index host.shape[0]; the padding must be dropped and the
    cache must equal the normalized host matrix."""
    wl = torch_make_workload(num_entities=5, num_sessions=10, num_queries=4,
                             seed=11)
    mf = MemForestSystem(device="cpu")
    _ingest(mf, wl.sessions[:4], BATCH)
    mf.query_batch(wl.queries)                   # first upload
    seen = []
    real = torch_forest.ops.scatter_normalize_rows

    def spy(arr, idx, rows):
        seen.append((arr.shape[0], idx.clone()))
        return real(arr, idx, rows)

    monkeypatch.setattr(torch_forest.ops, "scatter_normalize_rows", spy)
    _ingest(mf, wl.sessions[4:7], BATCH)
    fact_dev, n = mf.forest.fact_index_device()
    assert seen
    cap, idx = seen[0]
    assert idx.shape[0] & (idx.shape[0] - 1) == 0
    assert set(idx.tolist()) - set(range(cap)) <= {cap}
    host = torch.from_numpy(mf.forest.fact_emb[:n])
    want = host / (torch.linalg.vector_norm(host, dim=-1, keepdim=True) + 1e-6)
    np.testing.assert_allclose(fact_dev[:n].numpy(), want.numpy(), atol=1e-6)


def test_browse_beam_tie_break_prefers_lowest_child_index():
    """Equal browse scores resolve to the LOWEST child ids: the beam order is
    a stable argsort, as in the JAX package."""
    cfg = MemForestConfig()
    forest = torch_forest.Forest(cfg, "cpu")
    tree = forest.get_tree("t", "entity")
    v = np.zeros(cfg.embed_dim, np.float32)
    v[0] = 1.0
    leaves = [tree._alloc(0, (0.0, 1.0), text=f"leaf{i}", emb=v)
              for i in range(6)]                 # identical embeddings: all tie
    root = tree._alloc(1, (0.0, 1.0), text="root", emb=v)
    tree.children[root] = list(leaves)
    for leaf in leaves:
        tree.parent[leaf] = root
    tree.root = root

    r = Retriever(forest, encoder=None, config=cfg)
    lane = _Lane(0, tree, v, None, q_words=set())
    r._browse_lanes([lane])
    assert set(lane.collected) == set(leaves[:cfg.browse_beam])
