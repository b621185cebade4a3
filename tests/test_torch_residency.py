"""Tiered hot/cold tenant residency of the port against the JAX package:
``repro_torch.core.residency`` beside ``repro.core.residency``, on the same
seeded workloads, on the CPU, in one process.

The cases of ``tests/test_residency.py``, each run in both packages:
release_rows, detach and reattach, traffic-aware eviction under the hot
budget and under a byte budget, rehydration that uploads only the
rehydrated tenant's rows, rehydration parity in every browse mode, the
digest gate in both directions, a restarted manager, the digest sidecar,
tenant ids, the serve engine over-subscribed (both packages' engines on the
same weights) and the maintenance plane draining demotions.

Where the reference asserts ``is_deleted()`` on a released JAX buffer, the
port holds a ``weakref`` to each released tensor and asserts that it is
dead: nothing keeps the tensor, so its memory is back with PyTorch's
allocator (the byte count on the card is ``chip_smoke.py``'s check).

Byte figures differ between the packages, and the port states its own: the
port's forest keeps a node arena on the device beside the fact and root
indexes (``Forest.estimated_device_bytes``), so its footprint, byte budget
and ``bytes_released`` exceed the JAX package's by the arena's rows x D x 4.

Then what the port adds: tier decisions, answers and state digests equal to
the JAX package's under a Zipf schedule (``TableEncoder``: both packages get
the same embedding bits), digests that cross between the packages, the
device and encoder checks, the lock order under three threads (the JAX
package's ``repro.analysis.lockcheck`` on the port's plane and manager) and
memlint's ``topk-tiebreak`` and ``rename-fsync`` rules applied to the port.
"""
import ast
import gc
import os
import sys
import threading
import weakref

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.analysis import rules as memlint_rules
from repro.analysis.core import ModuleCtx, Project
from repro.analysis.lockcheck import (BlockingCallWatch, LockOrderGraph,
                                      instrument)
from repro.config import MemForestConfig as JaxMemConfig
from repro.configs import get_smoke_config as jax_smoke_config
from repro.core.maintenance_plane import MaintenancePlane as JaxPlane
from repro.core.memforest import MemForestSystem as JaxSystem
from repro.core.residency import ResidencyConfig as JaxResConfig
from repro.core.residency import ResidencyManager as JaxManager
from repro.core.residency import TenantDigest as JaxDigest
from repro.data.synthetic import make_workload as jax_workload
from repro.kernels import ops as jax_ops
from repro.models import get_model as jax_get_model
from repro.serving.engine import ServeEngine as JaxEngine
from repro_torch import MemForestConfig as TorchMemConfig
from repro_torch import MemForestSystem as TorchSystem
from repro_torch.configs import get_smoke_config
from repro_torch.convert import transformer_params_from_numpy
from repro_torch.core.maintenance_plane import MaintenancePlane as TorchPlane
from repro_torch.core.residency import DIGEST_NAME
from repro_torch.core.residency import ResidencyConfig as TorchResConfig
from repro_torch.core.residency import ResidencyManager as TorchManager
from repro_torch.core.residency import TenantDigest as TorchDigest
from repro_torch.data.synthetic import make_workload as torch_workload
from repro_torch.kernels import ops as torch_ops
from repro_torch.models import get_model
from repro_torch.serving.engine import ServeEngine as TorchEngine

from test_torch_durability import TableEncoder

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
MODES = ["flat", "root-only", "emb", "emb+planner", "llm", "llm+planner"]
ALWAYS_ESCALATE = -99.0     # any digest score clears the gate -> rehydrate
NEVER_ESCALATE = 99.0       # no score clears the gate -> digest answers


class Pkg:
    def __init__(self, name, **parts):
        self.name = name
        self.__dict__.update(parts)

    def manager(self, root, *, encoder=None, **cfg_kw):
        """A manager at ``root`` with the reference test's defaults: hot
        budget 2, every cold query escalating."""
        cfg_kw.setdefault("hot_budget", 2)
        cfg_kw.setdefault("digest_threshold", ALWAYS_ESCALATE)
        return self.Manager(str(root), config=self.ResConfig(**cfg_kw),
                            mem_config=self.MemConfig(), encoder=encoder,
                            **self.where)

    def wl(self, seed, nq=8):
        return self.workload(num_entities=2, num_sessions=3,
                             transitions_per_entity=3, num_queries=nq,
                             seed=seed)


JAX = Pkg("jax", Manager=JaxManager, ResConfig=JaxResConfig,
          MemConfig=JaxMemConfig, Digest=JaxDigest, Plane=JaxPlane,
          system=lambda: JaxSystem(JaxMemConfig()), workload=jax_workload,
          where={})
TORCH = Pkg("torch", Manager=TorchManager, ResConfig=TorchResConfig,
            MemConfig=TorchMemConfig, Digest=TorchDigest, Plane=TorchPlane,
            system=lambda: TorchSystem(device="cpu"), workload=torch_workload,
            where={"device": "cpu"})
PKGS = pytest.mark.parametrize("pkg", [TORCH, JAX], ids=["torch", "jax"])


def _fact_sig(facts):
    return [(f.fact_id, f.text, f.value) for f in facts]


def _device_tensors(forest):
    """Weak references to the forest's device caches: the fact and root
    indexes and the node arena."""
    return [weakref.ref(t) for t in (forest._fact_dev, forest._root_dev,
                                     forest._arena) if t is not None]


def _arena_bytes(forest):
    return 0 if forest._arena is None else \
        forest._arena.numel() * forest._arena.element_size()


# ---------------------------------------------------------------------------
# release_rows: the inverse of grow_rows
# ---------------------------------------------------------------------------
@PKGS
def test_release_rows_frees_and_shrinks(pkg):
    host = np.arange(32, dtype=np.float32).reshape(8, 4)
    if pkg is JAX:
        arr = jnp.asarray(host)
        assert jax_ops.release_rows(arr) is None
        assert arr.is_deleted()
        arr = jnp.asarray(host)
        out = jax_ops.release_rows(arr, keep=4)
        assert arr.is_deleted() and not out.is_deleted()
    else:
        # keep=0 keeps no reference: once the caller drops its own, the
        # tensor is gone
        arr = torch.from_numpy(host.copy())
        ref = weakref.ref(arr)
        assert torch_ops.release_rows(arr) is None
        del arr
        assert ref() is None
        arr = torch.from_numpy(host.copy())
        ref = weakref.ref(arr)
        out = torch_ops.release_rows(arr, keep=4)
        assert out.data_ptr() != ref().data_ptr()   # a fresh, smaller tensor
        del arr
        assert ref() is None
    assert out.shape == (4, 4)
    np.testing.assert_array_equal(np.asarray(out), host[:4])
    ops = jax_ops if pkg is JAX else torch_ops
    assert ops.release_rows(None) is None      # detached cache: no-op


@PKGS
def test_detach_reattach_roundtrip_identical(pkg):
    wl = pkg.wl(3)
    mf = pkg.system()
    mf.ingest_batch(wl.sessions)
    before = [(r.answer, r.evidence) for r in mf.query_batch(wl.queries)]
    assert mf.device_bytes() > 0
    up0 = mf.forest.index_uploads
    refs = _device_tensors(mf.forest) if pkg is TORCH else []

    freed = mf.detach_device()
    assert freed > 0 and mf.device_bytes() == 0
    if pkg is TORCH:
        # the fact and root indexes and the node arena, each released
        assert mf.forest.index_releases == 3 and len(refs) == 3
        gc.collect()
        assert all(r() is None for r in refs)
    else:
        assert mf.forest.index_releases == 2   # fact + root arenas freed

    after = [(r.answer, r.evidence) for r in mf.query_batch(wl.queries)]
    assert after == before                     # transparent reattach
    assert mf.forest.index_uploads == up0 + 2  # one fresh upload per index
    assert mf.device_bytes() > 0


# ---------------------------------------------------------------------------
# budget + eviction policy
# ---------------------------------------------------------------------------
@PKGS
def test_hot_budget_enforced_with_traffic_aware_victim(pkg, tmp_path):
    mgr = pkg.manager(tmp_path / "tenants", hot_budget=2)
    wls = {t: pkg.wl(i, nq=4) for i, t in enumerate(["a", "b", "c"])}
    mgr.ingest("a", wls["a"].sessions)
    mgr.ingest("b", wls["b"].sessions)
    # heat up "a" so "b" is the coldest resident when "c" arrives
    for _ in range(3):
        mgr.query_batch("a", wls["a"].queries[:2])
    mgr.ingest("c", wls["c"].sessions)
    m = mgr.metrics()
    assert m["hot_tenants"] <= 2 and m["evictions"] == 1
    assert mgr.is_resident("a") and mgr.is_resident("c")
    assert not mgr.is_resident("b")            # traffic-aware LRU victim
    mgr.close()


@PKGS
def test_device_byte_budget_triggers_demotion(pkg, tmp_path):
    mgr = pkg.manager(tmp_path / "tenants", hot_budget=8,
                      device_budget_bytes=1)
    mgr.ingest("a", pkg.wl(1).sessions)
    mgr.ingest("b", pkg.wl(2).sessions)
    # count budget allows 8 hot, the byte budget does not: only the hottest
    # tenant survives (the cap never demotes the last resident)
    assert mgr.metrics()["hot_tenants"] == 1
    assert mgr.metrics()["evictions"] >= 1
    mgr.close()


@PKGS
def test_evict_rehydrate_does_not_reupload_other_tenants(pkg, tmp_path):
    """Demoting A and rehydrating it must not touch B's device caches:
    only the rehydrated tenant's rows transfer."""
    mgr = pkg.manager(tmp_path / "tenants", hot_budget=4)
    wla, wlb = pkg.wl(5), pkg.wl(6)
    mgr.ingest("a", wla.sessions)
    mgr.ingest("b", wlb.sessions)
    mgr.query_batch("a", wla.queries)          # materialize device caches
    mgr.query_batch("b", wlb.queries)
    forest_b = mgr.acquire("b").forest
    up_b = forest_b.index_uploads
    rows_b = forest_b.index_row_updates
    arena_b = getattr(forest_b, "arena_syncs", None)

    assert mgr.demote("a")
    assert not mgr.is_resident("a")
    mgr.query_batch("b", wlb.queries)          # B untouched by A's eviction
    assert forest_b.index_uploads == up_b
    assert forest_b.index_row_updates == rows_b

    mgr.query_batch("a", wla.queries)          # rehydrates A (escalate gate)
    forest_a = mgr.acquire("a").forest
    assert forest_a.index_uploads == 2         # exactly A's two fresh uploads
    assert forest_b.index_uploads == up_b      # and still nothing on B
    assert forest_b.index_row_updates == rows_b
    if pkg is TORCH:                           # nor B's node arena
        assert forest_b.arena_syncs == arena_b
        assert forest_a.arena_syncs == 1
    assert mgr.metrics()["rehydrations"] == 1
    mgr.close()


# ---------------------------------------------------------------------------
# rehydration parity: every browse mode, byte-identical
# ---------------------------------------------------------------------------
def _rehydration_round(pkg, root):
    """Answers and retrieval signatures in all six modes before a demotion
    and after the rehydration that the next query pays."""
    wl = pkg.workload(num_entities=4, num_sessions=6,
                      transitions_per_entity=3, num_queries=12, seed=21)
    mgr = pkg.manager(root, hot_budget=4)
    mgr.ingest("t", wl.sessions)
    texts = [q.text for q in wl.queries]

    def signature(store):
        return {m: [(_fact_sig(f), e) for f, e, _ in
                    store.retriever.retrieve_batch(texts, mode=m)]
                for m in MODES}

    def answers():
        return {m: [(r.answer, r.evidence) for r in
                    mgr.query_batch("t", wl.queries, mode=m)]
                for m in MODES}

    before = signature(mgr.acquire("t"))
    before_ans = answers()
    assert mgr.demote("t")
    assert not mgr.is_resident("t")
    after_ans = answers()                      # first touch rehydrates
    after = signature(mgr.acquire("t"))
    rehydrations = mgr.metrics()["rehydrations"]
    mgr.close()
    return before, before_ans, after, after_ans, rehydrations


@PKGS
def test_rehydration_parity_all_modes(pkg, tmp_path):
    # snapshots carry derived state, so the round trip is exact, not just
    # semantically equivalent
    before, before_ans, after, after_ans, n = _rehydration_round(
        pkg, tmp_path / "tenants")
    assert after == before
    assert after_ans == before_ans
    assert n == 1


def test_rehydrated_answers_equal_across_packages(tmp_path):
    """After an evict and a rehydration, the port answers as the JAX
    package does in all six modes: the same evidence and fact ids."""
    t = _rehydration_round(TORCH, tmp_path / "torch")
    j = _rehydration_round(JAX, tmp_path / "jax")
    assert t == j


# ---------------------------------------------------------------------------
# digest escalation gate
# ---------------------------------------------------------------------------
@PKGS
def test_digest_answers_below_threshold_without_rehydration(pkg, tmp_path):
    wl = pkg.wl(31)
    mgr = pkg.manager(tmp_path / "tenants", digest_threshold=NEVER_ESCALATE)
    mgr.ingest("t", wl.sessions)
    mgr.demote("t")
    res = mgr.query_batch("t", wl.queries)
    assert len(res) == len(wl.queries)
    assert not mgr.is_resident("t")            # never paid the rehydration
    m = mgr.metrics()
    assert m["digest_answers"] == len(wl.queries) and m["rehydrations"] == 0
    assert m["device_bytes"] == 0
    # digest evidence is root-only grade: root summaries, non-empty
    assert any(r.evidence for r in res)
    mgr.close()


@PKGS
def test_digest_gate_escalates_above_threshold(pkg, tmp_path):
    wl = pkg.wl(32)
    mgr = pkg.manager(tmp_path / "tenants", digest_threshold=ALWAYS_ESCALATE)
    mgr.ingest("t", wl.sessions)
    mgr.demote("t")
    want = [r.answer for r in mgr.query_batch("t", wl.queries)]
    m = mgr.metrics()
    assert mgr.is_resident("t")                # escalated to the full store
    assert m["rehydrations"] == 1 and m["digest_answers"] == 0
    assert m["digest_escalations"] == 1
    # escalated answers are full-fidelity (match a plain system)
    ref = pkg.system()
    ref.ingest_batch(wl.sessions)
    assert want == [r.answer for r in ref.query_batch(wl.queries)]
    mgr.close()


@PKGS
def test_digest_answers_match_root_only_grade(pkg, tmp_path):
    """The digest is the root summaries: its answers must equal root-only
    browse over the same forest for queries that stay below the gate."""
    wl = pkg.wl(33)
    mgr = pkg.manager(tmp_path / "tenants", digest_threshold=NEVER_ESCALATE)
    mgr.ingest("t", wl.sessions)
    root_only = [r.answer for r in
                 mgr.query_batch("t", wl.queries, mode="root-only")]
    mgr.demote("t")
    digest = [r.answer for r in mgr.query_batch("t", wl.queries)]
    agree = sum(int(a == b) for a, b in zip(digest, root_only))
    assert agree >= len(wl.queries) // 2       # same evidence tier
    mgr.close()


# ---------------------------------------------------------------------------
# restart + persistence of the cold tier
# ---------------------------------------------------------------------------
@PKGS
def test_manager_restart_resumes_cold_tenants(pkg, tmp_path):
    wl = pkg.wl(41)
    mgr = pkg.manager(tmp_path / "tenants")
    mgr.ingest("t", wl.sessions, idempotency_key="t:i0")
    want_digest = mgr.state_digest("t")
    want = [r.answer for r in mgr.query_batch("t", wl.queries)]
    mgr.demote("t")
    mgr.close()

    # fresh process: tenants rediscovered COLD, digest sidecar loaded
    m2 = pkg.manager(tmp_path / "tenants", digest_threshold=NEVER_ESCALATE)
    assert m2.tenant_ids() == ["t"]
    assert not m2.is_resident("t")
    assert m2.metrics()["digest_bytes"] > 0
    assert m2.metrics()["device_bytes"] == 0
    m2.query_batch("t", wl.queries[:2])        # served from the digest
    assert m2.metrics()["digest_answers"] == 2 and not m2.is_resident("t")
    # full rehydration is still exact
    assert m2.state_digest("t") == want_digest
    assert [r.answer for r in m2.query_batch("t", wl.queries)] == want
    m2.close()


@PKGS
def test_tenant_digest_roundtrip(pkg):
    emb = np.random.default_rng(0).normal(size=(3, 8)).astype(np.float32)
    d = pkg.Digest(emb, ["alpha", "beta", "gamma"])
    d2 = pkg.Digest.from_bytes(d.to_bytes())
    np.testing.assert_array_equal(d2.emb, emb)
    assert d2.texts == d.texts and d2.nbytes() == d.nbytes()


@PKGS
def test_invalid_tenant_id_rejected(pkg, tmp_path):
    mgr = pkg.manager(tmp_path / "tenants")
    with pytest.raises(ValueError):
        mgr.acquire("..")
    with pytest.raises(ValueError):
        mgr.acquire("a/b")


# ---------------------------------------------------------------------------
# serving integration
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def models():
    """llama3's smoke config in float32, the JAX package's weights given to
    both engines."""
    jc = jax_smoke_config("llama3_8b").replace(dtype="float32",
                                               param_dtype="float32")
    tc = get_smoke_config("llama3_8b").replace(dtype="float32",
                                               param_dtype="float32")
    jm, tm = jax_get_model(jc), get_model(tc)
    jp = jm.init(jax.random.key(0))
    tp = transformer_params_from_numpy(jax.tree.map(np.asarray, jp), tc,
                                       device="cpu")
    return {"jax": (jm, jp), "torch": (tm, tp)}


def _over_subscribed(pkg, models, root):
    model, params = models[pkg.name]
    Engine = JaxEngine if pkg is JAX else TorchEngine
    mgr = pkg.manager(root, hot_budget=2)
    eng = Engine(model, params, max_batch=4, max_len=64, residency=mgr)
    assert mgr.auto_enforce is False           # engine owns the drain

    wls = {f"t{i}": pkg.wl(50 + i, nq=4) for i in range(5)}
    for tid, w in wls.items():
        for s in w.sessions:
            eng.submit_session(s, tenant=tid)
    # decode traffic rides alongside: eviction must not block it
    rng = np.random.default_rng(0)
    for _ in range(4):
        eng.submit(list(rng.integers(3, 400, size=5)), max_new_tokens=3)
    done = eng.run_until_drained()
    assert len(done) == 4 and all(r.out_tokens for r in done)

    rids = {tid: [eng.submit_query(q, tenant=tid, mode="llm")
                  for q in w.queries] for tid, w in wls.items()}
    eng.run_until_drained()
    answers = {tid: [(r.answer, r.evidence) for r in
                     (eng.pop_query_result(rid) for rid in rids[tid])]
               for tid in wls}
    m = eng.metrics()
    for key in ("hot_tenants", "evictions", "rehydrations", "digest_answers",
                "device_bytes", "device_bytes_est"):
        assert key in m
    assert m["hot_tenants"] <= 2               # budget drained on the lane
    assert m["evictions"] >= 3
    assert m["residency_turns"] > 0
    assert m["queries_served"] == sum(len(w.queries) for w in wls.values())
    tokens = sorted((r.req_id, r.out_tokens) for r in eng.finished)
    mgr.close()
    return tokens, answers, m


def test_serve_engine_multi_tenant_over_subscription(models, tmp_path):
    """Both packages' engines over-subscribed with five tenants at a hot
    budget of two: the same decoded tokens, answers and residency
    figures. Byte figures are the port's own (its node arena)."""
    tt, ta, tm = _over_subscribed(TORCH, models, tmp_path / "torch")
    jt, ja, jm = _over_subscribed(JAX, models, tmp_path / "jax")
    assert [[int(x) for x in t] for _, t in tt] == \
        [[int(x) for x in t] for _, t in jt]
    assert ta == ja
    keys = ("tenants", "hot_tenants", "cold_tenants", "evictions",
            "rehydrations", "digest_answers", "digest_escalations",
            "digest_bytes", "residency_turns", "ingest_batches",
            "ingest_sessions", "query_batches", "queries_served",
            "decode_steps", "decoded_tokens")
    assert {k: tm[k] for k in keys} == {k: jm[k] for k in keys}
    assert tm["bytes_released"] > jm["bytes_released"]


@PKGS
def test_maintenance_plane_drains_residency_demotions(pkg, tmp_path):
    mgr = pkg.manager(tmp_path / "tenants", hot_budget=1)
    mgr.auto_enforce = False                   # plane owns enforcement
    mgr.ingest("a", pkg.wl(61).sessions)
    mgr.ingest("b", pkg.wl(62).sessions)
    assert mgr.over_budget() == 1
    plane = pkg.Plane(mgr.acquire("b").forest, residency=mgr)
    assert plane.pending() >= 1
    plane.drain()
    assert plane.demotions_done >= 1
    assert plane.metrics()["maintenance_demotions"] == plane.demotions_done
    assert mgr.over_budget() == 0
    assert mgr.metrics()["hot_tenants"] == 1
    mgr.close()


# ---------------------------------------------------------------------------
# what the port adds: device memory given back, the reference's decisions
# ---------------------------------------------------------------------------
def test_demotion_releases_every_device_tensor(tmp_path):
    """After a demotion nothing holds the tenant's tensors: the fact and
    root indexes and the node arena are dead, the manager holds no store,
    and the bytes released are the port's footprint, which exceeds the JAX
    package's by the arena's bytes."""
    wl = TORCH.wl(5)
    mgr = TORCH.manager(tmp_path / "torch", hot_budget=4)
    mgr.ingest("a", wl.sessions)
    mgr.query_batch("a", wl.queries)           # materialize all three
    forest = mgr.acquire("a").forest
    refs = _device_tensors(forest)
    held = forest.device_bytes()
    arena = _arena_bytes(forest)
    assert len(refs) == 3 and held == forest.estimated_device_bytes() > 0
    assert mgr.demote("a")
    gc.collect()
    assert all(r() is None for r in refs)
    assert forest.device_bytes() == 0 and mgr.metrics()["device_bytes"] == 0
    assert mgr._tenants["a"].store is None
    assert mgr.bytes_released == held

    jmgr = JAX.manager(tmp_path / "jax", hot_budget=4)
    jmgr.ingest("a", JAX.wl(5).sessions)
    jmgr.query_batch("a", JAX.wl(5).queries)
    assert jmgr.demote("a")
    assert mgr.bytes_released - jmgr.bytes_released == arena
    mgr.close()
    jmgr.close()


N_TENANTS, HOT, EVENTS, BATCH = 8, 2, 24, 2


def _zipf_schedule(nq):
    rng = np.random.default_rng(7)
    p = 1.0 / np.arange(1, N_TENANTS + 1, dtype=np.float64) ** 1.5
    p /= p.sum()
    ranks = rng.choice(N_TENANTS, size=EVENTS, p=p)
    return [(int(r), [(e * BATCH + j) % nq for j in range(BATCH)])
            for e, r in enumerate(ranks)]


def _tiered_run(pkg, root, threshold):
    """Every tenant ingested, then a Zipf schedule of query events: per
    event the tenant, whether its queries came from the digest, which
    tenants were resident after it, and the answers with their evidence;
    then every tenant's state digest."""
    wls = [pkg.workload(num_entities=2, num_sessions=3,
                        transitions_per_entity=2, num_queries=6,
                        seed=1000 + i) for i in range(N_TENANTS)]
    mgr = pkg.manager(root, encoder=TableEncoder(), hot_budget=HOT,
                      digest_threshold=threshold)
    for i, w in enumerate(wls):
        mgr.ingest(f"t{i}", w.sessions, idempotency_key=f"t{i}:i0")
    log = []
    for rank, qi in _zipf_schedule(len(wls[0].queries)):
        before = mgr.digest_answers
        res = mgr.query_batch(f"t{rank}", [wls[rank].queries[j] for j in qi])
        log.append((rank, mgr.digest_answers > before,
                    [t for t in mgr.tenant_ids() if mgr.is_resident(t)],
                    [(r.answer, r.evidence) for r in res]))
    m = mgr.metrics()
    digests = [mgr.state_digest(f"t{i}") for i in range(N_TENANTS)]
    mgr.close()
    return log, digests, m


def test_tier_decisions_and_digests_equal_the_reference(tmp_path):
    """The same tenants and Zipf schedule through both packages' managers:
    the same demotions, the same digest-or-escalate decision for every cold
    query, the same answers and evidence, the same state digests."""
    t_log, t_dig, t_m = _tiered_run(TORCH, tmp_path / "torch", 0.45)
    j_log, j_dig, j_m = _tiered_run(JAX, tmp_path / "jax", 0.45)
    assert t_log == j_log
    assert t_dig == j_dig
    keys = ("evictions", "rehydrations", "digest_answers",
            "digest_escalations", "digest_bytes", "hot_tenants")
    assert {k: t_m[k] for k in keys} == {k: j_m[k] for k in keys}
    # the schedule takes both branches of the gate
    assert t_m["digest_answers"] > 0 and t_m["digest_escalations"] > 0


@pytest.mark.parametrize("writer", ["torch", "jax"])
def test_digest_reads_in_the_other_package(tmp_path, writer):
    """A digest sidecar written by one package's demotion reads in the
    other's restarted manager, and the sidecar's bytes are equal."""
    src, dst = (TORCH, JAX) if writer == "torch" else (JAX, TORCH)
    root = tmp_path / "tenants"
    wl = src.wl(41)
    mgr = src.manager(root, encoder=TableEncoder())
    mgr.ingest("t", wl.sessions, idempotency_key="t:i0")
    want_digest = mgr.state_digest("t")
    assert mgr.demote("t")
    mgr.close()
    with open(root / "t" / DIGEST_NAME, "rb") as f:
        blob = f.read()
    other = dst.Digest.from_bytes(blob)
    assert other.to_bytes() == blob

    m2 = dst.manager(root, encoder=TableEncoder(),
                     digest_threshold=NEVER_ESCALATE)
    assert m2.tenant_ids() == ["t"] and not m2.is_resident("t")
    got = [(r.answer, r.evidence) for r in m2.query_batch("t", wl.queries)]
    assert m2.metrics()["digest_answers"] == len(wl.queries)
    m3 = src.manager(tmp_path / "again", encoder=TableEncoder(),
                     digest_threshold=NEVER_ESCALATE)
    m3.ingest("t", wl.sessions, idempotency_key="t:i0")
    m3.demote("t")
    assert got == [(r.answer, r.evidence)
                   for r in m3.query_batch("t", wl.queries)]
    assert m2.state_digest("t") == want_digest
    m2.close()
    m3.close()


def test_manager_refuses_an_encoder_on_another_device(tmp_path):
    class CardEncoder(TableEncoder):
        device = torch.device("cuda")

    with pytest.raises(ValueError, match="same device"):
        TorchManager(str(tmp_path / "t"), encoder=CardEncoder(),
                     device="cpu")


def test_manager_default_device_needs_a_card(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TorchManager(str(tmp_path / "t"))


@PKGS
def test_engine_refuses_tenant_without_a_manager(pkg, models):
    model, params = models[pkg.name]
    Engine = JaxEngine if pkg is JAX else TorchEngine
    eng = Engine(model, params, max_batch=2, max_len=32, memory=pkg.system())
    w = pkg.wl(3)
    with pytest.raises(RuntimeError, match="ResidencyManager"):
        eng.submit_session(w.sessions[0], tenant="t")
    with pytest.raises(RuntimeError, match="ResidencyManager"):
        eng.submit_query(w.queries[0], tenant="t")
    assert not eng.ingest_queue and not eng.query_queue


# ---------------------------------------------------------------------------
# lock order under three threads (tests/test_lockcheck.py's harness)
# ---------------------------------------------------------------------------
EVICTIONS = 12       # the third thread's ingest + enforce rounds


def test_serve_stack_lock_graph_is_acyclic_under_concurrent_load(tmp_path,
                                                                  models):
    """The port's engine traffic with ``tenant=`` on the caller thread, its
    plane's background worker draining demotions, and evictions from a
    third thread, on locks the JAX package's lockcheck instruments: the
    graph is acyclic with no (residency, plane) edge, and the only blocking
    calls under a lock are the sanctioned fsyncs."""
    wl = TORCH.workload(num_entities=4, num_sessions=8,
                        transitions_per_entity=2, num_queries=6, seed=23)
    mgr = TORCH.manager(tmp_path / "tenants", hot_budget=2,
                        digest_threshold=0.35)
    mgr.ingest("t0", wl.sessions[:2], idempotency_key="seed")
    plane = TORCH.Plane(mgr.acquire("t0").forest, flush_trees_per_unit=2,
                        residency=mgr)

    g = LockOrderGraph()
    instrument(plane, g, "plane")
    instrument(mgr, g, "residency")

    model, params = models["torch"]
    eng = TorchEngine(model, params, max_batch=2, max_len=32,
                      residency=mgr, maintenance=plane, maintenance_budget=2)
    # one intra-op thread: three Python threads each driving a pool of
    # OpenMP threads, at a 10 us switch interval, spin for minutes
    old = sys.getswitchinterval(), torch.get_num_threads()
    torch.set_num_threads(1)
    sys.setswitchinterval(1e-5)       # force frequent thread switches
    errors = []
    try:
        with BlockingCallWatch(g):
            plane.start_background(interval_s=0.001, budget_per_wake=2)

            def evictor():
                try:
                    for i in range(EVICTIONS):
                        mgr.ingest(f"ev{i % 3}",
                                   [wl.sessions[i % len(wl.sessions)]],
                                   idempotency_key=f"ev:{i}")
                        mgr.enforce_budget(4)
                except Exception as e:      # reported below
                    errors.append(e)

            ev = threading.Thread(target=evictor)
            ev.start()
            try:
                for s in wl.sessions:
                    eng.submit_session(s, tenant="t0")
                rids = [eng.submit_query(q, tenant="t0") for q in wl.queries]
                eng.submit([5, 6, 7], max_new_tokens=2)
                eng.run_until_drained()
                results = [eng.pop_query_result(r) for r in rids]
            finally:
                ev.join(timeout=120)
                plane.stop_background(drain_first=True)
    finally:
        sys.setswitchinterval(old[0])
        torch.set_num_threads(old[1])
    assert not ev.is_alive() and not errors, errors
    assert all(r is not None for r in results)
    mgr.close()

    held_names = {n for e in g.edges for n in e} | \
        {n for held, _ in g.blocking_calls for n in held}
    assert "residency" in held_names
    g.assert_acyclic()
    assert ("residency", "plane") not in g.edges
    allowed = {(("residency",), "os.fsync"),
               (("plane", "residency"), "os.fsync")}
    assert set(g.blocking_calls) <= allowed, set(g.blocking_calls) - allowed


# ---------------------------------------------------------------------------
# memlint's tie-break and rename rules, applied to the port
# ---------------------------------------------------------------------------
# topk-tiebreak is scoped to repro/kernels/, repro/core/retrieval.py and
# repro/core/residency.py: it does not reach src/repro_torch/. The port's
# residency module and the baselines' fact store are checked here under the
# reference path of the same module.
PORT_AS_REFERENCE = {
    "core/residency.py": "src/repro/core/residency.py",
    "core/baselines/base.py": "src/repro/core/baselines/base.py",
}
PORT_RULES = ("topk-tiebreak", "rename-fsync")


def _lint_as_reference(src, rel, rules=PORT_RULES):
    ctx = ModuleCtx(rel, rel, src, ast.parse(src), Project(REPO))
    for rule_id in rules:
        ctx._rule_id = rule_id
        getattr(memlint_rules, rule_id.replace("-", "_"))(ctx)
    sup = ctx.suppressions()
    return [f for f in ctx.findings
            if f.rule not in sup.get(f.line, set())
            and "*" not in sup.get(f.line, set())]


@pytest.mark.parametrize("port_file", sorted(PORT_AS_REFERENCE))
def test_port_passes_memlint_tiebreak_and_rename_rules(port_file):
    with open(os.path.join(REPO, "src", "repro_torch", port_file)) as f:
        src = f.read()
    found = _lint_as_reference(src, PORT_AS_REFERENCE[port_file])
    assert not found, "\n".join(f.render() for f in found)


def test_port_lint_finds_planted_tiebreak_and_rename_faults():
    """An unstable argsort planted in a copy of the port's residency module
    and a rename without fsync_dir planted in another are found."""
    with open(os.path.join(REPO, "src/repro_torch/core/residency.py")) as f:
        src = f.read()
    planted = src.replace('np.argsort(-sims[qi], kind="stable")',
                          "np.argsort(-sims[qi])")
    assert planted != src
    found = _lint_as_reference(planted, "src/repro/core/residency.py")
    assert [f.rule for f in found] == ["topk-tiebreak"]
    planted = src.replace("        ckpt.fsync_dir(t.path)\n", "")
    assert planted != src
    found = _lint_as_reference(planted, "src/repro/core/residency.py")
    assert [f.rule for f in found] == ["rename-fsync"]
    assert "_write_digest" in found[0].message
