"""The durable write path and the maintenance plane of the port against the
JAX package: ``repro_torch.core.journal`` and ``core/maintenance_plane.py``
beside ``repro.core.journal`` and its plane, on the same seeded workloads,
on the CPU, in one process.

The cases of ``tests/test_durability.py``, each run in both packages (or the
port's side against the JAX package's result): WAL framing, exactly-once
keys, snapshot + journal-tail recovery, deferred-flush snapshots, journaled
compaction, the crash sweeps over every durability boundary, the property
test, the residency manager's demote-and-rehydrate sweep, and the plane in
cooperative and background mode.

How the packages are compared. Under ``TableEncoder`` (below) both packages
embed every text to the same float32 bits, so their state digests must be
equal. With each package's own ``HashingEncoder`` the structure is compared
exactly (facts, cells, trees, placement, registry, applied keys) and node
embeddings within ``EMB_ATOL`` = 1e-5. Answers and evidence are compared
exactly in all six browse modes.

Then what the port adds: snapshots and journals that cross between the
packages, demotion of the device caches, memlint's determinism and journal
rules applied to the port (their path scopes keep them from it), and a
threaded stress test of the background plane.
"""
import ast
import os
import sys
import tempfile
import time
import types
import zlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

try:
    from hypothesis import given, settings, strategies as st
except ImportError:           # in-repo fallback (tests/_propcheck.py)
    from _propcheck import given, settings, strategies as st

from repro import obs as jax_obs
from repro.analysis import rules as memlint_rules
from repro.analysis.core import ModuleCtx, Project
from repro.config import MemForestConfig as JaxConfig
from repro.core import maintenance as jax_maintenance
from repro.core import persistence as jax_persistence
from repro.core.journal import DurableMemForest as JaxDurable
from repro.core.journal import JournalWriter as JaxWriter
from repro.core.journal import read_journal as jax_read_journal
from repro.core.maintenance_plane import MaintenancePlane as JaxPlane
from repro.core.memforest import MemForestSystem as JaxSystem
from repro.data.synthetic import make_workload as jax_workload
from repro.runtime.fault_tolerance import CrashInjector as JaxInjector
from repro.runtime.fault_tolerance import SimulatedCrash as JaxCrash
from repro_torch import MemForestSystem as TorchSystem
from repro_torch import obs as torch_obs
from repro_torch.core import maintenance as torch_maintenance
from repro_torch.core import persistence as torch_persistence
from repro_torch.core.journal import JOURNAL_NAME
from repro_torch.core.journal import DurableMemForest as TorchDurable
from repro_torch.core.journal import JournalWriter as TorchWriter
from repro_torch.core.journal import read_journal as torch_read_journal
from repro_torch.core.maintenance_plane import MaintenancePlane as TorchPlane
from repro_torch.data.synthetic import make_workload as torch_workload
from repro_torch.runtime.fault_tolerance import CrashInjector as TorchInjector
from repro_torch.runtime.fault_tolerance import SimulatedCrash as TorchCrash

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
MODES = ["flat", "root-only", "emb", "emb+planner", "llm", "llm+planner"]
EMB_ATOL = 1e-5        # node embeddings, each package's own encoder


# ---------------------------------------------------------------------------
# the two packages behind one interface
# ---------------------------------------------------------------------------
class TableEncoder:
    """Test-only encoder given to both packages: each word maps to a vector
    drawn from a generator seeded with (seed, crc32 of the word), a text to
    the L2-normalized sum of its words' vectors, in float32. Both packages
    get the same bits for every text, so their state digests can be equal;
    shared words keep texts similar, so recall and browse still choose."""

    def __init__(self, dim: int = 256, seed: int = 0):
        self.dim = dim
        self.seed = seed
        self.stats = types.SimpleNamespace(calls=0, tokens=0, texts=0,
                                           sequential_calls=0)
        self._words = {}

    def _word(self, w):
        v = self._words.get(w)
        if v is None:
            v = np.random.default_rng(
                [self.seed, zlib.crc32(w.encode())]).standard_normal(self.dim)
            self._words[w] = v
        return v

    def encode(self, texts, *, sequential=False):
        out = np.zeros((len(texts), self.dim), np.float32)
        for i, text in enumerate(texts):
            v = sum(self._word(w) for w in (text.lower().split() or [""]))
            out[i] = v / (np.linalg.norm(v) + 1e-9)
        self.stats.calls += 1
        self.stats.texts += len(texts)
        self.stats.tokens += sum(len(t.split()) for t in texts)
        if sequential:
            self.stats.sequential_calls += len(texts)
        return out

    def encode_one(self, text):
        return self.encode([text])[0]


def _encoder(kind):
    return TableEncoder() if kind == "table" else None


class Pkg:
    """One package's durable path: ``system``, ``open`` and ``durable``
    build a memory on the CPU with the given encoder."""

    def __init__(self, name, **parts):
        self.name = name
        self.__dict__.update(parts)

    def system(self, enc="hashing"):
        return self.make_system(_encoder(enc))

    def durable(self, root, enc="hashing", **kw):
        return self.Durable(self.system(enc), root, **kw)

    def open(self, root, enc="hashing", **kw):
        return self.open_store(root, encoder=_encoder(enc), **kw)


JAX = Pkg("jax", make_system=lambda e: JaxSystem(JaxConfig(), e),
          Durable=JaxDurable, open_store=JaxDurable.open, Plane=JaxPlane,
          Injector=JaxInjector, Crash=JaxCrash, maintenance=jax_maintenance,
          persistence=jax_persistence, read_journal=jax_read_journal,
          Writer=JaxWriter, workload=jax_workload, obs=jax_obs)
TORCH = Pkg("torch", make_system=lambda e: TorchSystem(encoder=e,
                                                        device="cpu"),
            Durable=TorchDurable,
            open_store=lambda root, **kw: TorchDurable.open(
                root, device="cpu", **kw),
            Plane=TorchPlane, Injector=TorchInjector, Crash=TorchCrash,
            maintenance=torch_maintenance, persistence=torch_persistence,
            read_journal=torch_read_journal, Writer=TorchWriter,
            workload=torch_workload, obs=torch_obs)


def wl(pkg):
    return pkg.workload(num_entities=4, num_sessions=6,
                        transitions_per_entity=2, num_queries=8, seed=11)


def merge_wl(pkg):
    return pkg.workload(num_entities=3, num_sessions=2,
                        transitions_per_entity=2, num_queries=2, seed=12)


def forest_of(x):
    """The forest of a system or store, or ``x`` itself if it is one."""
    return getattr(x, "forest", x)


def answers(system, queries):
    return {m: [(r.answer, r.evidence)
                for r in system.query_batch(queries, mode=m)] for m in MODES}


def same_state(t, j, *, digest):
    """The port's memory ``t`` holds the JAX package's ``j``'s state:
    structure exactly, node embeddings within EMB_ATOL, and (``digest``:
    both got the same embeddings) equal state digests."""
    ft, fj = forest_of(t), forest_of(j)
    sig = lambda f: (f.fact_id, f.text, f.subject, f.attribute,  # noqa: E731
                     f.value, f.ts, f.prev_value,
                     [tuple(s) for s in f.sources])
    assert [sig(f) for f in ft.facts] == [sig(f) for f in fj.facts]
    assert ft.fact_alive == fj.fact_alive
    assert [(c.cell_id, c.session_id, c.chunk_idx, c.text) for c in ft.cells] \
        == [(c.cell_id, c.session_id, c.chunk_idx, c.text) for c in fj.cells]
    assert ft._tree_order == fj._tree_order and list(ft.trees) == list(fj.trees)
    for key, tj in fj.trees.items():
        tt = ft.trees[key]
        assert (tt.tree_id, tt.kind, tt._n, tt.root, tt.parent, tt.children,
                tt.level, tt.payload, tt.alive, tt.start_ts, tt.end_ts,
                tt.text, tt.dirty) == \
            (tj.tree_id, tj.kind, tj._n, tj.root, tj.parent, tj.children,
             tj.level, tj.payload, tj.alive, tj.start_ts, tj.end_ts,
             tj.text, tj.dirty), key
        np.testing.assert_allclose(tt.emb[:tt._n], tj.emb[:tj._n],
                                   atol=EMB_ATOL, err_msg=key)
    assert ft.placement == fj.placement
    assert ft.session_registry == fj.session_registry
    assert ft.applied_ops == fj.applied_ops
    assert ft.dirty_trees == fj.dirty_trees
    if digest:
        assert t.state_digest() == j.state_digest()


def _build(pkg, sessions, enc="hashing"):
    mf = pkg.system(enc)
    mf.ingest_batch(list(sessions))
    return mf


def _plan(w, mw):
    """The op mix every recovery test replays: batched ingests, a targeted
    deletion, and a migration merge — each with a stable client key so
    retries after a simulated crash dedup instead of double-applying."""
    return [
        ("ingest", "client:i0", w.sessions[:2]),
        ("ingest", "client:i1", w.sessions[2:4]),
        ("delete", "client:d0", w.sessions[0].session_id),
        ("merge", "client:m0", mw.sessions),
        ("ingest", "client:i2", w.sessions[4:]),
    ]


def _apply(pkg, store, op, enc="hashing"):
    kind, key, arg = op
    if kind == "ingest":
        store.ingest_batch(arg, idempotency_key=key)
    elif kind == "delete":
        store.delete_session(arg, idempotency_key=key)
    elif kind == "compact":
        for scope in sorted(pkg.maintenance.compaction_candidates(
                store.forest, min_dead_fraction=0.01)):
            store.compact_tree(scope, idempotency_key=f"{key}:{scope}")
    elif kind == "demote":
        store.demote()
    else:
        store.merge_from(_build(pkg, arg, enc), idempotency_key=key)


def _run_uninterrupted(pkg, root, ops, enc="hashing", **kw):
    store = pkg.durable(root, enc, **kw)
    for op in ops:
        _apply(pkg, store, op, enc)
    store.close()
    return store


def _run_with_crash_then_recover(pkg, root, ops, crash_at, enc="hashing",
                                 snapshot_every=2):
    """Client-side retry loop: on SimulatedCrash the in-memory store is
    discarded (process death), recovery reopens from disk, and the unacked
    op is retried under its original idempotency key."""
    store = pkg.durable(root, enc, snapshot_every=snapshot_every,
                        crash=pkg.Injector(crash_at))
    crashes = 0
    for op in ops:
        while True:
            try:
                _apply(pkg, store, op, enc)
                break
            except pkg.Crash:
                crashes += 1
                store.close()
                store = pkg.open(root, enc, snapshot_every=snapshot_every)
    store.close()
    return store, crashes


def _both(fn):
    """(port's result, JAX package's result) of ``fn(pkg)``."""
    return fn(TORCH), fn(JAX)


# ---------------------------------------------------------------------------
# journal framing
# ---------------------------------------------------------------------------
def test_journal_frame_roundtrip(tmp_path):
    recs = [{"seq": i, "op": "ingest_batch", "key": f"k{i}",
             "payload": {"x": [i] * i, "f": 0.5 * i, "b": bytes(i)}}
            for i in range(1, 4)]
    paths = {}
    for pkg in (TORCH, JAX):
        p = paths[pkg.name] = str(tmp_path / f"{pkg.name}.waj")
        w = pkg.Writer(p)
        for r in recs:
            w.append(r)
        w.close()
    # the frames are byte-identical, and each package reads the other's
    with open(paths["torch"], "rb") as a, open(paths["jax"], "rb") as b:
        assert a.read() == b.read()
    assert torch_read_journal(paths["jax"]) == recs
    assert jax_read_journal(paths["torch"]) == recs == \
        torch_read_journal(paths["torch"])


def test_journal_torn_tail_ends_replay_cleanly(tmp_path):
    def fresh(name):
        p = str(tmp_path / name)
        w = TorchWriter(p)
        for i in range(3):
            w.append({"seq": i + 1, "op": "delete_session", "key": f"k{i}",
                      "payload": {"session_id": "s" * 40}})
        w.close()
        return p

    def seqs(p):
        got = [r["seq"] for r in torch_read_journal(p)]
        assert got == [r["seq"] for r in jax_read_journal(p)]
        return got

    p = fresh("trunc.waj")                     # crash mid-append
    with open(p, "rb+") as f:
        f.truncate(os.path.getsize(p) - 7)
    assert seqs(p) == [1, 2]

    p = fresh("crc.waj")                       # corrupt (CRC-failing) tail
    with open(p, "rb+") as f:
        f.seek(-1, os.SEEK_END)
        f.write(b"\xff")
    assert seqs(p) == [1, 2]

    p = fresh("short.waj")                     # header promising too much
    with open(p, "ab") as f:
        f.write(b"\xff\xff\xff\x7f garbage")
    assert seqs(p) == [1, 2, 3]


def test_missing_journal_reads_empty(tmp_path):
    assert torch_read_journal(str(tmp_path / "nope.waj")) == [] == \
        jax_read_journal(str(tmp_path / "nope.waj"))


def test_recovery_truncates_torn_tail_before_appending(tmp_path):
    """A torn tail frame must be cut on open(): appends landing AFTER the
    garbage would be fsync-acked yet dropped by every later scan."""
    def run(pkg):
        w = wl(pkg)
        root = str(tmp_path / pkg.name)
        store = pkg.durable(root, "table")
        store.ingest_batch(w.sessions[:2], idempotency_key="i0")
        store.close()
        jpath = os.path.join(root, JOURNAL_NAME)
        with open(jpath, "ab") as f:                # crash mid-append
            f.write(b"\xde\xad\xbe\xef torn frame garbage")
        torn_size = os.path.getsize(jpath)
        rec = pkg.open(root, "table")
        assert os.path.getsize(jpath) < torn_size   # tail truncated
        rec.ingest_batch(w.sessions[2:4], idempotency_key="i1")
        want = rec.state_digest()
        rec.close()
        rec2 = pkg.open(root, "table")              # i1 survives THIS one
        assert rec2.ops_replayed == 2
        assert rec2.state_digest() == want
        rec2.close()
        return rec2

    t, j = _both(run)
    same_state(t, j, digest=True)


# ---------------------------------------------------------------------------
# exactly-once idempotency
# ---------------------------------------------------------------------------
def test_duplicate_delivery_applies_exactly_once(tmp_path):
    def run(pkg):
        w = wl(pkg)
        root = str(tmp_path / pkg.name)
        store = pkg.durable(root, "table")
        assert store.ingest_batch(w.sessions[:2],
                                  idempotency_key="hook:1") is not None
        d0, n0 = store.state_digest(), store.scale_stats()
        assert store.ingest_batch(w.sessions[:2],
                                  idempotency_key="hook:1") is None
        assert store.duplicates_skipped == 1
        assert store.state_digest() == d0 and store.scale_stats() == n0
        assert len(pkg.read_journal(os.path.join(root, JOURNAL_NAME))) == 1
        store.close()
        return store

    t, j = _both(run)
    same_state(t, j, digest=True)


def test_journaled_merge_idempotent_under_key(tmp_path):
    def run(pkg):
        store = pkg.durable(str(tmp_path / pkg.name), "table")
        store.ingest_batch(wl(pkg).sessions[:2], idempotency_key="i")
        src = _build(pkg, merge_wl(pkg).sessions, "table")
        assert store.merge_from(src, idempotency_key="m") is not None
        d0 = store.state_digest()
        assert store.merge_from(src, idempotency_key="m") is None
        assert store.state_digest() == d0
        store.close()
        return store

    t, j = _both(run)
    same_state(t, j, digest=True)


def test_durable_path_matches_plain_system(tmp_path):
    """Journaling is a shell: answers and scale are identical to running the
    same lifecycle directly on a MemForestSystem — and equal the JAX
    package's."""
    def run(pkg):
        w, mw = wl(pkg), merge_wl(pkg)
        ops = _plan(w, mw)
        store = _run_uninterrupted(pkg, str(tmp_path / pkg.name), ops)
        plain = pkg.system()
        for kind, _key, arg in ops:
            if kind == "ingest":
                plain.ingest_batch(arg)
            elif kind == "delete":
                plain.delete_session(arg)
            else:
                plain.merge_from(_build(pkg, arg))
        assert store.scale_stats() == plain.scale_stats()
        got = answers(store, w.queries)
        assert got == answers(plain, w.queries)
        return store, got

    (t, at), (j, aj) = _both(run)
    same_state(t, j, digest=False)
    assert at == aj


# ---------------------------------------------------------------------------
# recovery: snapshot + journal tail
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("enc", ["table", "hashing"])
def test_recovery_replays_snapshot_plus_tail(tmp_path, enc):
    def run(pkg):
        w = wl(pkg)
        ops = _plan(w, merge_wl(pkg))
        root = str(tmp_path / pkg.name)
        store = pkg.durable(root, enc)
        for op in ops[:2]:
            _apply(pkg, store, op, enc)
        store.checkpoint()                  # snapshot covers the first two
        for op in ops[2:]:
            _apply(pkg, store, op, enc)
        want_digest = store.state_digest()
        want = answers(store, w.queries)
        store.close()                       # "crash" after the last append
        rec = pkg.open(root, enc)
        assert rec.ops_replayed == len(ops) - 2
        assert rec.state_digest() == want_digest
        got = answers(rec, w.queries)
        assert got == want
        for t in rec.forest.trees.values():
            t.check_invariants()
        rec.close()
        return rec, got

    (t, at), (j, aj) = _both(run)
    same_state(t, j, digest=enc == "table")
    assert at == aj


def test_recovery_is_pure_replay_without_snapshot(tmp_path):
    """No checkpoint ever taken: open() rebuilds the whole state from the
    journal alone — including the merge, whose source forest rides inside
    its journal record."""
    def run(pkg):
        root = str(tmp_path / pkg.name)
        ops = _plan(wl(pkg), merge_wl(pkg))
        want = _run_uninterrupted(pkg, root, ops, "table").state_digest()
        rec = pkg.open(root, "table")
        assert rec.ops_replayed == len(ops)
        assert rec.state_digest() == want
        rec.close()
        return rec

    t, j = _both(run)
    same_state(t, j, digest=True)


def test_checkpoint_under_deferred_flush_recovers_fresh_summaries(tmp_path):
    """A snapshot taken while flushes are deferred carries the dirty marks,
    so the restored store's first reader repairs the stale summaries."""
    def run(pkg):
        w = wl(pkg)
        ref = _build(pkg, w.sessions)                # inline flush
        want = answers(ref, w.queries)
        root = str(tmp_path / pkg.name)
        store = pkg.durable(root)
        store.ingest_batch(w.sessions, idempotency_key="i", defer_flush=True)
        assert store.forest.dirty_trees
        store.checkpoint()
        store.close()
        rec = pkg.open(root)
        assert rec.ops_replayed == 0
        assert rec.forest.dirty_trees
        assert any(t.dirty for t in rec.forest.trees.values())
        restored = (rec.forest.dirty_trees.copy(),
                    {k: set(t.dirty) for k, t in rec.forest.trees.items()})
        got = answers(rec, w.queries)
        assert got == want
        assert not rec.forest.dirty_trees            # reader paid the flush
        rec.close()
        return rec, got, restored

    (t, at, rt), (j, aj, rj) = _both(run)
    assert rt == rj
    same_state(t, j, digest=False)
    assert at == aj


def test_journaled_compaction_recovers_and_dedups(tmp_path):
    def run(pkg):
        w = wl(pkg)
        root = str(tmp_path / pkg.name)
        store = pkg.durable(root, "table")
        store.ingest_batch(w.sessions, idempotency_key="i")
        for s in w.sessions[:3]:
            store.delete_session(s.session_id,
                                 idempotency_key=f"d:{s.session_id}")
        scopes = sorted(pkg.maintenance.compaction_candidates(
            store.forest, min_dead_fraction=0.01))
        assert scopes
        for scope in scopes:
            assert store.compact_tree(scope,
                                      idempotency_key=f"c:{scope}") is not None
            assert store.compact_tree(scope,
                                      idempotency_key=f"c:{scope}") is None
        want = store.state_digest()
        n_records = len(pkg.read_journal(os.path.join(root, JOURNAL_NAME)))
        store.close()
        rec = pkg.open(root, "table")
        assert rec.ops_replayed == n_records
        assert rec.state_digest() == want
        for t in rec.forest.trees.values():
            t.check_invariants()
        rec.close()
        return rec, scopes

    (t, st_), (j, sj) = _both(run)
    assert st_ == sj
    same_state(t, j, digest=True)


def test_snapshot_gc_honors_small_keep_counts(tmp_path):
    for pkg in (TORCH, JAX):
        w = wl(pkg)
        for keep in (0, 1):
            root = str(tmp_path / f"{pkg.name}{keep}")
            store = pkg.durable(root, keep_snapshots=keep)
            for i in range(3):
                store.ingest_batch(w.sessions[i:i + 1],
                                   idempotency_key=f"i{i}")
                store.checkpoint()
            snaps = [n for n in os.listdir(root) if n.startswith("snapshot_")]
            # the LATEST-pointed snapshot itself is always retained
            assert len(snaps) == max(keep, 1), (pkg.name, keep)
            store.close()


def test_reopen_is_stable_fixed_point(tmp_path):
    def run(pkg):
        root = str(tmp_path / pkg.name)
        want = _run_uninterrupted(pkg, root, _plan(wl(pkg), merge_wl(pkg)),
                                  "table", snapshot_every=2).state_digest()
        a = pkg.open(root, "table")
        da = a.state_digest()
        a.checkpoint()
        a.close()
        b = pkg.open(root, "table")
        assert b.ops_replayed == 0
        assert da == want == b.state_digest()
        b.close()
        return b

    t, j = _both(run)
    same_state(t, j, digest=True)


# ---------------------------------------------------------------------------
# crash injection: every durability boundary (the port's sweep; the JAX
# package's uninterrupted run as the structure to reach)
# ---------------------------------------------------------------------------
def _sweep(tmp_path, ops_of, window=None):
    """The port's crash sweep over ``ops_of(pkg)``: every recovered digest
    equals the port's uninterrupted digest, and the uninterrupted state
    equals the JAX package's (table encoder: equal digests). ``window``
    picks the kill points from the probe's trace. Returns the probe."""
    ref = _run_uninterrupted(TORCH, str(tmp_path / "ref"), ops_of(TORCH),
                             "table", snapshot_every=2)
    jref = _run_uninterrupted(JAX, str(tmp_path / "jref"), ops_of(JAX),
                              "table", snapshot_every=2)
    same_state(ref, jref, digest=True)
    want = ref.state_digest()

    probe = TorchInjector(None)
    _run_uninterrupted(TORCH, str(tmp_path / "probe"), ops_of(TORCH),
                       "table", snapshot_every=2, crash=probe)
    jprobe = JaxInjector(None)
    _run_uninterrupted(JAX, str(tmp_path / "jprobe"), ops_of(JAX), "table",
                       snapshot_every=2, crash=jprobe)
    assert probe.trace == jprobe.trace      # the same durability events
    points = window(probe) if window else range(1, probe.events + 1)
    fired = 0
    for k in points:
        store, crashes = _run_with_crash_then_recover(
            TORCH, str(tmp_path / f"crash_{k:02d}"), ops_of(TORCH), k,
            "table")
        fired += crashes
        assert crashes >= 1, f"kill point #{k} never fired"
        assert store.state_digest() == want, \
            f"state diverged after crash at event #{k} ({probe.trace[k - 1]})"
    assert fired == len(points)
    return probe


def test_crash_sweep_every_durability_boundary(tmp_path):
    probe = _sweep(tmp_path, lambda pkg: _plan(wl(pkg), merge_wl(pkg)))
    assert probe.events >= 3 * 5            # submit/append/apply per op
    assert "snapshot:commit" in probe.trace and "journal:rotate" in probe.trace


def test_crash_sweep_journaled_compaction(tmp_path):
    def ops(pkg):
        base = _plan(wl(pkg), merge_wl(pkg))
        return base[:3] + [("compact", "client:c0", None)] + base[3:]

    def window(probe):
        n = probe.trace.count("submit:compact_tree")
        assert n > 0
        lo = probe.trace.index("submit:compact_tree")
        return range(lo + 1, min(lo + 3 * n + 4, probe.events) + 1)

    _sweep(tmp_path, ops, window)


def test_crash_sweep_demotion_boundary(tmp_path):
    """Demotion (snapshot + LATEST flip + journal rotation + freeing the
    device caches and the node arena) changes NO persistent state: a kill
    anywhere in its window recovers the uninterrupted digest."""
    def ops(pkg):
        base = _plan(wl(pkg), merge_wl(pkg))
        return base[:3] + [("demote", None, None)] + base[3:]

    def window(probe):
        return range(probe.trace.index("demote:begin") + 1,
                     probe.trace.index("demote:commit") + 2)

    _sweep(tmp_path, ops, window)


def test_crash_sweep_manager_demote_and_rehydrate(tmp_path):
    """The residency manager's lifecycle under the same sweep: a kill at
    every boundary of the demotion (digest write + checkpoint-class
    demotion) and of the cold query's rehydration; a restarted manager
    recovers the uninterrupted answers and digest. Rehydration IS the
    crash-recovery open, so this also pins that equivalence. The port's
    durability events, answers and digest equal the JAX package's (table
    encoder)."""
    from repro.core.residency import ResidencyConfig as JaxResConfig
    from repro.core.residency import ResidencyManager as JaxManager
    from repro_torch.core.residency import ResidencyConfig, ResidencyManager

    def build(pkg, root, crash=None):
        if pkg is JAX:
            return JaxManager(root, config=JaxResConfig(
                hot_budget=2, digest_threshold=-99.0),
                mem_config=JaxConfig(), encoder=TableEncoder(), crash=crash)
        return ResidencyManager(root, config=ResidencyConfig(
            hot_budget=2, digest_threshold=-99.0), encoder=TableEncoder(),
            device="cpu", crash=crash)

    def lifecycle(pkg, mgr):
        w = wl(pkg)
        mgr.ingest("t", w.sessions[:4], idempotency_key="i0")
        mgr.demote("t")
        return [(r.answer, r.evidence) for r in mgr.query_batch("t", w.queries)]

    def reference(pkg, name):
        mgr = build(pkg, str(tmp_path / name))
        ans = lifecycle(pkg, mgr)             # demote -> escalate -> rehydrate
        digest = mgr.state_digest("t")
        mgr.close()
        probe = pkg.Injector(None)
        mgr = build(pkg, str(tmp_path / f"{name}_probe"), crash=probe)
        w = wl(pkg)
        mgr.ingest("t", w.sessions[:4], idempotency_key="i0")
        events_ingest = probe.events          # covered by the core sweep
        mgr.demote("t")
        mgr.query_batch("t", w.queries)
        mgr.close()
        return ans, digest, probe, events_ingest

    want_ans, want_digest, probe, first = reference(TORCH, "ref")
    j_ans, j_digest, j_probe, _ = reference(JAX, "jref")
    assert (want_ans, want_digest, probe.trace) == \
        (j_ans, j_digest, j_probe.trace)
    for ev in ("demote:digest", "demote:begin", "demote:commit",
               "rehydrate:begin", "rehydrate:commit"):
        assert ev in probe.trace

    for k in range(first + 1, probe.events + 1):
        root = str(tmp_path / f"crash_{k:02d}")
        mgr = build(TORCH, root, crash=TORCH.Injector(k))
        with pytest.raises(TorchCrash):       # process death mid-transition
            lifecycle(TORCH, mgr)
        mgr.close()
        rec = build(TORCH, root)              # fresh process over the dir
        assert rec.tenant_ids() == ["t"]
        assert [(r.answer, r.evidence) for r in
                rec.query_batch("t", wl(TORCH).queries)] == want_ans
        assert rec.state_digest("t") == want_digest, \
            f"state diverged after crash at event #{k} ({probe.trace[k - 1]})"
        rec.close()


@settings(max_examples=4, deadline=None)
@given(crash_at=st.integers(min_value=1, max_value=60),
       rot=st.integers(min_value=0, max_value=4))
def test_prop_any_crash_prefix_recovers_state_identical(crash_at, rot):
    """Property: for ANY op ordering and ANY kill point, snapshot + journal
    tail + client retry reconverges to the uninterrupted run's digest — the
    port's, which equals the JAX package's."""
    def ops(pkg):
        w = pkg.workload(num_entities=3, num_sessions=4,
                         transitions_per_entity=2, num_queries=2,
                         seed=100 + rot)
        mw = pkg.workload(num_entities=2, num_sessions=2,
                          transitions_per_entity=2, num_queries=1,
                          seed=200 + rot)
        o = _plan(w, mw)
        return o[rot:] + o[:rot]

    base = tempfile.mkdtemp(prefix="memforest_torch_prop_")
    want = _run_uninterrupted(TORCH, os.path.join(base, "ref"), ops(TORCH),
                              "table", snapshot_every=2)
    jwant = _run_uninterrupted(JAX, os.path.join(base, "jref"), ops(JAX),
                               "table", snapshot_every=2)
    store, _ = _run_with_crash_then_recover(
        TORCH, os.path.join(base, "crash"), ops(TORCH), crash_at, "table")
    assert store.state_digest() == want.state_digest() == \
        jwant.state_digest()
    same_state(store, jwant, digest=True)


# ---------------------------------------------------------------------------
# maintenance plane
# ---------------------------------------------------------------------------
def test_plane_drains_deferred_flush_equivalently():
    def run(pkg):
        w = wl(pkg)
        want = answers(_build(pkg, w.sessions), w.queries)
        mf = pkg.system()
        plane = pkg.Plane(mf.forest, flush_trees_per_unit=3)
        mf.ingest_batch(w.sessions, defer_flush=True)
        assert mf.forest.dirty_trees and plane.pending() > 0
        first = plane.run_some(1)
        assert first["units"] == 1 and plane.trees_flushed <= 3
        plane.drain()
        assert not mf.forest.dirty_trees and plane.pending() == 0
        got = answers(mf, w.queries)
        assert got == want
        assert plane.metrics()["maintenance_trees_flushed"] >= \
            len(mf.forest.trees) // 2
        for t in mf.forest.trees.values():
            t.check_invariants()
        return mf, got, plane.units_run

    (t, at, ut), (j, aj, uj) = _both(run)
    assert ut == uj
    same_state(t, j, digest=False)
    assert at == aj


def test_plane_queued_merge_runs_off_serve_path():
    def run(pkg):
        w = wl(pkg)
        mf = _build(pkg, w.sessions)
        before = mf.scale_stats()["facts"]
        plane = pkg.Plane(mf.forest)
        plane.schedule_merge(_build(pkg, merge_wl(pkg).sessions),
                             idempotency_key="pm")
        assert plane.pending() >= 1
        plane.drain()
        assert plane.merges_done == 1
        assert mf.scale_stats()["facts"] > before
        assert "pm" in mf.forest.applied_ops
        assert not mf.forest.dirty_trees
        return mf, answers(mf, w.queries)

    (t, at), (j, aj) = _both(run)
    same_state(t, j, digest=False)
    assert at == aj


def test_plane_compaction_reclaims_tombstoned_slots():
    def run(pkg):
        w = wl(pkg)
        mf = _build(pkg, w.sessions)
        for s in w.sessions[:4]:
            mf.delete_session(s.session_id)
        plane = pkg.Plane(mf.forest, compact_min_dead_fraction=0.01)
        queued = plane.schedule_compaction()
        assert queued > 0
        nodes_before = mf.scale_stats()["nodes"]
        plane.drain()
        assert plane.compactions_done == queued
        assert plane.slots_reclaimed > 0
        assert mf.scale_stats()["nodes"] <= nodes_before
        for t in mf.forest.trees.values():
            t.check_invariants()
        return mf, answers(mf, w.queries), plane.metrics()

    (t, at, mt), (j, aj, mj) = _both(run)
    assert mt == {k: v for k, v in mj.items() if k in mt}
    same_state(t, j, digest=False)
    assert at == aj


def test_plane_compaction_rides_durable_journal(tmp_path):
    def run(pkg):
        w = wl(pkg)
        root = str(tmp_path / pkg.name)
        store = pkg.durable(root, "table")
        store.ingest_batch(w.sessions, idempotency_key="i")
        for s in w.sessions[:4]:
            store.delete_session(s.session_id,
                                 idempotency_key=f"d:{s.session_id}")
        plane = pkg.Plane(store.forest, compact_min_dead_fraction=0.01,
                          durable=store)
        queued = plane.schedule_compaction()
        assert queued > 0
        before = len(pkg.read_journal(os.path.join(root, JOURNAL_NAME)))
        plane.drain()
        assert plane.compactions_done == queued
        assert len(pkg.read_journal(os.path.join(root, JOURNAL_NAME))) == \
            before + queued
        want = store.state_digest()
        store.close()
        rec = pkg.open(root, "table")
        assert rec.state_digest() == want
        rec.close()
        return rec

    t, j = _both(run)
    same_state(t, j, digest=True)


def test_plane_background_thread_mode():
    def run(pkg):
        w = wl(pkg)
        want = answers(_build(pkg, w.sessions), w.queries)
        mf = pkg.system()
        plane = pkg.Plane(mf.forest)
        plane.start_background(interval_s=0.001, budget_per_wake=2)
        try:
            with plane.lock:
                mf.ingest_batch(w.sessions, defer_flush=True)
        finally:
            plane.stop_background(drain_first=True)
        assert not mf.forest.dirty_trees
        assert plane.units_run > 0
        got = answers(mf, w.queries)
        assert got == want
        return mf, got

    (t, at), (j, aj) = _both(run)
    same_state(t, j, digest=False)
    assert at == aj


def test_crash_injector_events_ride_trace_sink(tmp_path):
    """Every durability tick mirrors into the trace sink as a
    ``durability/<event>`` point event, in the order of ``probe.trace``, and
    the snapshot protocol's events nest under their ``journal.checkpoint``
    span — in both packages, with the same event sequence."""
    def run(pkg):
        sink = pkg.obs.MemorySink()
        pkg.obs.enable_tracing(sink)
        try:
            probe = pkg.Injector(None, obs=pkg.obs.Observability())
            store = pkg.open(str(tmp_path / pkg.name), crash=probe,
                             snapshot_every=2)
            for op in _plan(wl(pkg), merge_wl(pkg)):
                _apply(pkg, store, op)
            store.checkpoint()
            store.close()
        finally:
            pkg.obs.disable_tracing()
        evs = sink.events("durability/")
        assert [e["name"] for e in evs] == \
            ["durability/" + t for t in probe.trace]
        assert [e["attrs"]["n"] for e in evs] == list(range(1, probe.events + 1))
        ts = [e["ts"] for e in evs]
        assert ts == sorted(ts)
        ckpt_ids = {r["span"] for r in sink.spans("journal.checkpoint")}
        assert ckpt_ids
        by_name = {}
        for e in evs:
            by_name.setdefault(e["name"], []).append(e)
        for name in ("durability/snapshot:begin", "durability/snapshot:commit",
                     "durability/journal:rotate"):
            assert by_name[name], name
            assert all(e["span"] in ckpt_ids for e in by_name[name]), name
        for b, c, r in zip(by_name["durability/snapshot:begin"],
                           by_name["durability/snapshot:commit"],
                           by_name["durability/journal:rotate"]):
            assert b["span"] == c["span"] == r["span"]
            assert b["ts"] < c["ts"] < r["ts"]
        return probe.trace

    t, j = _both(run)
    assert t == j


def test_plane_merge_rides_durable_journal(tmp_path):
    def run(pkg):
        root = str(tmp_path / pkg.name)
        store = pkg.durable(root, "table")
        store.ingest_batch(wl(pkg).sessions, idempotency_key="i")
        plane = pkg.Plane(store.forest, durable=store)
        plane.schedule_merge(_build(pkg, merge_wl(pkg).sessions, "table"),
                             idempotency_key="pm")
        plane.drain()
        assert plane.merges_done == 1
        recs = pkg.read_journal(os.path.join(root, JOURNAL_NAME))
        assert any(r["op"] == "migrate_merge" and r["key"] == "pm"
                   for r in recs)
        assert "pm" in store.forest.applied_ops
        want = store.state_digest()
        store.close()
        rec = pkg.open(root, "table")
        assert rec.state_digest() == want
        assert "pm" in rec.forest.applied_ops
        rec.close()
        return rec

    t, j = _both(run)
    same_state(t, j, digest=True)


# ---------------------------------------------------------------------------
# what crosses between the packages
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("with_derived", [True, False])
@pytest.mark.parametrize("writer", ["torch", "jax"])
def test_snapshot_loads_in_the_other_package(tmp_path, writer, with_derived):
    """A snapshot written by either package loads in the other: equal
    digests (table encoder), equal structure, equal answers; a thin
    snapshot regenerates the derived state in the reader."""
    src_pkg, dst_pkg = (TORCH, JAX) if writer == "torch" else (JAX, TORCH)
    w = wl(src_pkg)
    src = _build(src_pkg, w.sessions[:4], "table")
    src.delete_session(w.sessions[0].session_id)
    src.merge_from(_build(src_pkg, merge_wl(src_pkg).sessions, "table"),
                   idempotency_key="m")
    src.ingest_batch(w.sessions[4:])
    path = str(tmp_path / "snap.mfz")
    src.save(path, with_derived=with_derived)

    def load(pkg):
        kw = dict(encoder=TableEncoder(),
                  rematerialize_derived=not with_derived)
        if pkg is TORCH:
            return TorchSystem.load(path, device="cpu", **kw)
        return JaxSystem.load(path, **kw)

    # the reader's package and the writer's own restore hold one state
    dst, own = load(dst_pkg), load(src_pkg)
    assert dst.state_digest() == own.state_digest() == src.state_digest()
    t, j = (dst, own) if dst_pkg is TORCH else (own, dst)
    same_state(t, j, digest=True)
    assert answers(dst, wl(dst_pkg).queries) == answers(own, w.queries)


@pytest.mark.parametrize("writer", ["torch", "jax"])
def test_journal_replays_in_the_other_package(tmp_path, writer):
    """A store written by one package (snapshot + journal tail with an
    ingest, a deletion, a merge and a compaction) opens in the other, which
    replays the tail to the writer's digest."""
    src_pkg, dst_pkg = (TORCH, JAX) if writer == "torch" else (JAX, TORCH)
    root = str(tmp_path / "store")
    ops = _plan(wl(src_pkg), merge_wl(src_pkg))
    store = src_pkg.durable(root, "table")
    for op in ops[:2]:
        _apply(src_pkg, store, op, "table")
    store.checkpoint()
    for op in ops[2:] + [("compact", "c", None)]:
        _apply(src_pkg, store, op, "table")
    want = store.state_digest()
    tail = len(src_pkg.read_journal(os.path.join(root, JOURNAL_NAME)))
    store.close()
    rec = dst_pkg.open(root, "table")
    assert tail >= len(ops) - 1 and rec.ops_replayed == tail
    assert rec.state_digest() == want
    t, j = (rec, store) if dst_pkg is TORCH else (store, rec)
    same_state(t, j, digest=True)
    rec.close()


def test_demote_frees_the_device_caches_and_reopens(tmp_path):
    """Demotion frees the fact and root indexes and the node arena; the
    estimate equals what a fresh upload holds, and answers survive."""
    w = wl(TORCH)
    store = TORCH.durable(str(tmp_path / "s"), "table")
    store.ingest_batch(w.sessions, idempotency_key="i")
    want = answers(store, w.queries)
    held = store.device_bytes()
    assert held == store.forest.estimated_device_bytes() > 0
    name, freed = store.demote()
    assert freed == held and store.device_bytes() == 0
    assert store.forest._arena is None
    assert answers(store, w.queries) == want
    assert store.device_bytes() == store.forest.estimated_device_bytes()
    store.close()
    rec = TORCH.open(str(tmp_path / "s"), "table")
    assert rec.ops_replayed == 0 and answers(rec, w.queries) == want


def test_background_worker_failure_reaches_the_caller():
    mf = TORCH.system()
    plane = TorchPlane(mf.forest)
    plane.schedule_merge(object(), idempotency_key="bad")   # not a forest
    plane.start_background(interval_s=0.001)
    plane._thread.join(timeout=10)
    assert not plane._thread.is_alive()
    with pytest.raises(AttributeError):
        plane.stop_background()


def test_background_plane_stress_keeps_arena_and_answers():
    """The worker flushes while this thread ingests, deletes and queries,
    all under ``plane.lock``, with a short switch interval so the threads
    interleave finely: the node arena stays equal to every tree's rows
    bitwise, the worker launched the refreshes, and the final answers equal
    an inline run's."""
    w = TORCH.workload(num_entities=5, num_sessions=12,
                       transitions_per_entity=2, num_queries=8, seed=5)
    ref = _build(TORCH, w.sessions)
    for s in w.sessions[:3]:
        ref.delete_session(s.session_id)
    want = answers(ref, w.queries)

    mf = TORCH.system()
    plane = TorchPlane(mf.forest, flush_trees_per_unit=2)
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    plane.start_background(interval_s=0.0005, budget_per_wake=1)
    try:
        for i in range(0, len(w.sessions), 3):
            with plane.lock:
                mf.ingest_batch(w.sessions[i:i + 3], defer_flush=True)
            time.sleep(0.005)                 # the worker takes the lock
            if i % 2:
                with plane.lock:              # flushes what is left first
                    mf.query_batch(w.queries[:2], mode="emb")
        with plane.lock:
            for s in w.sessions[:3]:
                torch_maintenance.delete_session(mf.forest, s.session_id,
                                                 flush=False)
        with plane.lock:
            worker_units = plane.units_run
    finally:
        plane.stop_background(drain_first=True)
        sys.setswitchinterval(old)
    assert worker_units > 0                   # the worker flushed meanwhile
    arena, rows = mf.forest.node_arena()
    for tree in mf.forest.trees.values():
        got = arena[torch.from_numpy(rows[tree.tree_id][:tree._n]).long()]
        assert got.numpy().tobytes() == tree.emb[:tree._n].tobytes()
    assert answers(mf, w.queries) == want


# ---------------------------------------------------------------------------
# memlint's determinism and journal checks, applied to the port
# ---------------------------------------------------------------------------
# memlint scopes replay-determinism to files ending in repro/core/journal.py
# and repro/core/persistence.py, and journaled-mutation to paths holding
# "repro/": neither reaches src/repro_torch/. The port's files are checked
# here under the reference path of the same module, so the rules apply.
PORT_AS_REFERENCE = {
    "core/journal.py": "src/repro/core/journal.py",
    "core/persistence.py": "src/repro/core/persistence.py",
    "core/maintenance_plane.py": "src/repro/core/maintenance_plane.py",
    "core/memforest.py": "src/repro/core/memforest.py",
    "serving/engine.py": "src/repro/serving/engine.py",
}
PORT_RULES = ("replay-determinism", "journaled-mutation")


def _lint_as_reference(src: str, rel: str):
    """Findings of the two rules on ``src`` checked as the file ``rel``,
    with the sweep's inline suppressions applied."""
    ctx = ModuleCtx(rel, rel, src, ast.parse(src), Project(REPO))
    for rule_id in PORT_RULES:
        ctx._rule_id = rule_id
        getattr(memlint_rules, rule_id.replace("-", "_"))(ctx)
    sup = ctx.suppressions()
    return [f for f in ctx.findings
            if f.rule not in sup.get(f.line, set())
            and "*" not in sup.get(f.line, set())]


@pytest.mark.parametrize("port_file", sorted(PORT_AS_REFERENCE))
def test_port_passes_memlint_determinism_and_journal_rules(port_file):
    path = os.path.join(REPO, "src", "repro_torch", port_file)
    with open(path) as f:
        src = f.read()
    found = _lint_as_reference(src, PORT_AS_REFERENCE[port_file])
    assert not found, "\n".join(f.render() for f in found)


def test_port_lint_finds_a_planted_violation(tmp_path):
    """The same check finds an unordered-set iteration planted in a copy of
    the port's journal, and a direct mutator call planted in a copy of its
    engine."""
    with open(os.path.join(REPO, "src/repro_torch/core/journal.py")) as f:
        journal = f.read()
    planted = journal + ("\n\ndef _planted(forest):\n"
                         "    for k in forest.dirty_trees:\n"
                         "        print(k)\n")
    copy = tmp_path / "journal.py"
    copy.write_text(planted)
    found = _lint_as_reference(copy.read_text(), "src/repro/core/journal.py")
    assert [f.rule for f in found] == ["replay-determinism"]
    assert "dirty_trees" in found[0].message

    with open(os.path.join(REPO, "src/repro_torch/serving/engine.py")) as f:
        engine = f.read()
    planted = engine + ("\n\ndef _planted(forest):\n"
                        "    maintenance.compact_tree(forest, 'k')\n")
    found = _lint_as_reference(planted, "src/repro/serving/engine.py")
    assert [f.rule for f in found] == ["journaled-mutation"]

