"""The paper's five baselines in the port against the JAX package:
``repro_torch.core.baselines`` beside ``repro.core.baselines``, each
package with its own hashing encoder, on the CPU, in one process.

For each baseline on three seeds, sessions go in one at a time (as
``benchmarks/bench_write_path.py`` drives them): every session's write
counts (encoder calls and tokens, dependency depth, facts written), every
fact store's texts, ids and ``alive`` flags, and every query's answer and
evidence are equal. Then the fact store on its own against the JAX one —
a store below its capacity, k above the store's size, k = 0 (the JAX kernel
returns nothing; the port launches nothing), duplicate rows (they tie and
come out by row id) — Mem0's in-place rewrite reaching the next top-k, one
upload for a batch of adds, and the port's versions of
``tests/test_system.py``'s two baseline claims.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core.baselines import ALL_BASELINES as JAX_BASELINES
from repro.core.baselines.base import FactStore as JaxFactStore
from repro.core.encoder import HashingEncoder as JaxEncoder
from repro.core.types import CanonicalFact as JaxFact
from repro.data.synthetic import make_workload as jax_workload
from repro_torch import MemForestSystem
from repro_torch.core.baselines import ALL_BASELINES, Mem0Like
from repro_torch.core.baselines.base import FactStore
from repro_torch.core.encoder import HashingEncoder
from repro_torch.core.types import CanonicalFact
from repro_torch.data.synthetic import make_workload
from repro_torch.kernels import COUNTS, ops

SEEDS = [3, 11, 29]
STORES = ("store", "cell_store", "recent_store")


def _workload(make, seed):
    return make(num_entities=4, num_sessions=8, transitions_per_entity=3,
                num_queries=16, seed=seed)


def _run(system, wl):
    """Per-session write counts, the stores' contents, and every query's
    answer and evidence."""
    writes = []
    for s in wl.sessions:
        st = system.ingest_session(s)
        writes.append((st.encoder_calls, st.encoder_tokens,
                       st.llm_dependency_depth, st.facts_written))
    stores = {name: ([(f.fact_id, f.text, f.subject, f.attribute, f.value,
                       f.ts) for f in store.facts], list(store.alive),
                     store.emb.shape)
              for name in STORES
              if (store := getattr(system, name, None)) is not None}
    answers = []
    for q in wl.queries:
        r = system.query(q)
        answers.append((r.answer, r.evidence))
    return writes, stores, answers, system.encoder.stats.sequential_calls


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("name", sorted(ALL_BASELINES))
def test_baseline_matches_the_reference(name, seed):
    port = ALL_BASELINES[name](HashingEncoder(dim=256, device="cpu"),
                               device="cpu")
    ref = JAX_BASELINES[name](JaxEncoder(dim=256))
    got = _run(port, _workload(make_workload, seed))
    want = _run(ref, _workload(jax_workload, seed))
    assert got[0] == want[0]                  # write counts, per session
    assert got[1] == want[1] and got[1]       # store contents
    assert got[2] == want[2]                  # answers and evidence
    assert got[3] == want[3]                  # sequential encoder calls


# ---------------------------------------------------------------------------
# the fact store against the JAX one
# ---------------------------------------------------------------------------
def _stores(rows):
    """A port store and a JAX store holding the same rows."""
    port, ref = FactStore(rows.shape[1], "cpu"), JaxFactStore(rows.shape[1])
    for i, r in enumerate(rows):
        for store, Fact in ((port, CanonicalFact), (ref, JaxFact)):
            store.add(Fact(fact_id=-1, text=f"f{i}", subject="", attribute="",
                           value="", ts=0.0, sources=[], emb=None), r)
    return port, ref


def _ids(facts):
    return [f.fact_id for f in facts]


@pytest.mark.parametrize("n", [1, 5, 63, 64, 65, 100, 300])
def test_fact_store_topk_matches_the_reference(n):
    rng = np.random.default_rng(n)
    rows = rng.normal(size=(n, 32)).astype(np.float32)
    port, ref = _stores(rows)
    assert port.emb.shape == ref.emb.shape    # capacity 64 * 2^j > n or = n
    for qi in range(4):
        q = rng.normal(size=32).astype(np.float32)
        for k in (1, 3, 8, 10, n + 5):       # k above the store's size too
            if k > 32:
                continue                      # the kernel's MAX_K
            assert _ids(port.topk(q, k)) == _ids(ref.topk(q, k)), (qi, k)


def test_fact_store_k0_and_empty_make_no_launch():
    rng = np.random.default_rng(0)
    port, ref = _stores(rng.normal(size=(10, 16)).astype(np.float32))
    before = COUNTS["topk_sim"].plain_calls
    q = rng.normal(size=16).astype(np.float32)
    assert port.topk(q, 0) == [] == ref.topk(q, 0)
    empty = FactStore(16, "cpu")
    assert empty.topk(q, 5) == [] == JaxFactStore(16).topk(q, 5)
    assert COUNTS["topk_sim"].plain_calls == before
    with pytest.raises(ValueError, match="k must lie"):
        ops.topk_sim(torch.zeros(1, 16), torch.zeros(10, 16), 0)


def test_fact_store_duplicate_rows_tie_by_row_id():
    rng = np.random.default_rng(1)
    rows = rng.normal(size=(90, 24)).astype(np.float32)
    q = rng.normal(size=24).astype(np.float32)
    for r in (7, 40, 41, 88):                 # one tile, two, the last row
        rows[r] = q * 2.0
    port, ref = _stores(rows)
    got = _ids(port.topk(q, 6))
    assert got[:4] == [7, 40, 41, 88]
    assert got == _ids(ref.topk(q, 6))


def test_in_place_rewrite_reaches_the_next_topk():
    """Mem0 rewrites a row in place (``set_emb``): the next top-k must score
    the new row, though the device copy was synced before the rewrite."""
    rng = np.random.default_rng(2)
    rows = rng.normal(size=(50, 16)).astype(np.float32)
    port, ref = _stores(rows)
    q = rng.normal(size=16).astype(np.float32)
    assert _ids(port.topk(q, 3)) == _ids(ref.topk(q, 3))   # synced once
    port.set_emb(17, q)
    ref.emb[17] = q                           # the JAX baseline's write
    assert _ids(port.topk(q, 3))[0] == 17
    assert _ids(port.topk(q, 3)) == _ids(ref.topk(q, 3))
    np.testing.assert_array_equal(
        port.device_index().numpy(),
        ops.normalize_rows(torch.from_numpy(port.emb)).numpy())


def test_mem0_keeps_its_device_rows_fresh():
    """After Mem0's updates the device copy equals the host rows,
    normalized: every rewrite was marked."""
    wl = make_workload(num_entities=3, num_sessions=6,
                       transitions_per_entity=3, num_queries=4, seed=5)
    m0 = Mem0Like(HashingEncoder(dim=256, device="cpu"), device="cpu")
    for s in wl.sessions:
        m0.ingest_session(s)
    # one sequential call per candidate, one row per added candidate
    assert m0.store.size < m0.encoder.stats.sequential_calls   # updates ran
    np.testing.assert_array_equal(
        m0.store.device_index().numpy(),
        ops.normalize_rows(torch.from_numpy(m0.store.emb)).numpy())


def test_one_upload_per_topk_after_a_batch_of_adds():
    rng = np.random.default_rng(3)
    port, _ = _stores(rng.normal(size=(100, 16)).astype(np.float32))
    q = rng.normal(size=16).astype(np.float32)
    assert port.uploads == 0                  # adds only mark rows
    port.topk(q, 5)
    assert port.uploads == 1 and port.grows == 0
    port.topk(q, 5)
    assert port.uploads == 1                  # nothing new: no upload
    for i in range(40):                       # crosses capacity 128
        port.add(CanonicalFact(fact_id=-1, text=f"g{i}", subject="",
                               attribute="", value="", ts=0.0, sources=[],
                               emb=None), rng.normal(size=16).astype(np.float32))
    port.topk(q, 5)
    assert port.uploads == 2 and port.grows == 1
    assert port.device_index().shape == port.emb.shape == (256, 16)


def test_backend_refuses_an_encoder_on_another_device():
    class CardEncoder:
        device = torch.device("cuda")
        dim = 16

    for cls in ALL_BASELINES.values():
        with pytest.raises(ValueError, match="same device"):
            cls(CardEncoder(), device="cpu")


def test_backend_default_device_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Mem0Like(object())


# ---------------------------------------------------------------------------
# tests/test_system.py's baseline claims, on the port
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def workload():
    return make_workload(num_entities=6, num_sessions=10,
                         transitions_per_entity=3, num_queries=30, seed=3)


def _gold(answer, q):
    return int(answer.strip().lower() == q.gold.strip().lower())


def test_memforest_beats_baselines(workload):
    mf = MemForestSystem(device="cpu")
    for s in workload.sessions:
        mf.ingest_session(s)
    mf_acc = sum(_gold(mf.query(q, final_topk=6).answer, q)
                 for q in workload.queries)
    for name, cls in ALL_BASELINES.items():
        sys_ = cls(HashingEncoder(dim=256, device="cpu"), device="cpu")
        for s in workload.sessions:
            sys_.ingest_session(s)
        acc = sum(_gold(sys_.query(q, final_topk=6).answer, q)
                  for q in workload.queries)
        assert mf_acc >= acc, (name, mf_acc, acc)


def test_mem0_loses_history(workload):
    """The paper's §2.3.2 failure mode: in-place updates destroy the history
    needed for first-value (multi-session) queries."""
    m0 = Mem0Like(HashingEncoder(dim=256, device="cpu"), device="cpu")
    mf = MemForestSystem(device="cpu")
    for s in workload.sessions:
        m0.ingest_session(s)
        mf.ingest_session(s)
    multi = [q for q in workload.queries if q.qtype == "multi_session"]
    assert multi
    m0_acc = sum(_gold(m0.query(q).answer, q) for q in multi)
    mf_acc = sum(_gold(mf.query(q).answer, q) for q in multi)
    assert mf_acc > m0_acc
