"""Tiered hot/cold tenant residency with transparent rehydration.

Counterpart of the JAX package's ``core/residency.py``. One
:class:`ResidencyManager` owns a directory of per-tenant durable forests
(``<root>/<tenant_id>/``, each a full ``DurableMemForest`` store) and keeps
at most ``hot_budget`` of them HOT: forest in memory, journal open, index
caches and node arena on the device. Everything else is COLD: a compressed
snapshot + LATEST marker on disk (written by ``DurableMemForest.demote()``,
a checkpoint-class durable event) plus a small always-resident *digest*,
the tenant's root summaries and L2-normalized root embeddings, in host
memory.

The tiering is transparent at the API: ``ingest``/``query_batch`` on a cold
tenant rehydrate it with exactly ``DurableMemForest.open()`` (snapshot +
journal-tail replay, the path a crash takes), and the forest's device caches
re-upload lazily on the first index access. Eviction is traffic-aware LRU:
every touch bumps a tenant's exponentially-decayed heat, and when the
resident set exceeds the budget (count or device bytes) the lowest-heat
resident is demoted. Under a ``ServeEngine`` the enforcement runs on its
residency lane or on the maintenance plane, so eviction never blocks a
decode step.

Demotion gives the card its memory back: ``Forest.detach_device`` drops the
fact and root indexes and the node arena, the manager drops the store, and
no span or metric keeps a tensor. The memory returns to PyTorch's caching
allocator (``torch.cuda.memory_allocated`` falls by the tenant's
``device_bytes``); it stays reserved for the next rehydration, and nothing
here calls ``torch.cuda.empty_cache``, which would synchronise the device.

Confidence-gated escalation: a query against a cold tenant first scores
against the digest, in numpy on the host, so a cold tenant costs no device
traffic. Only when the best digest score clears ``digest_threshold`` does
the manager pay the full rehydration; otherwise it answers from the digest
(root-only-grade evidence), counted in ``digest_answers``.

The digest sidecar (``<tenant>/DIGEST``: msgpack through the port's codec,
tagged compression, tmp+fsync+rename) is DERIVED state, rebuilt at every
demotion, and reads in either package: a stale or missing digest only
affects escalation routing, never correctness; with no digest a cold query
always escalates.
"""
from __future__ import annotations

import os
import threading
import time
from dataclasses import dataclass
from typing import Any, Dict, List, Optional

import numpy as np

from repro_torch import compression
from repro_torch.config import MemForestConfig
from repro_torch.core import codec
from repro_torch.core.journal import JOURNAL_NAME, DurableMemForest
from repro_torch.core.retrieval import answer_query
from repro_torch.core.types import CanonicalFact, QueryResult
from repro_torch.data import templates as T
from repro_torch.device import check_encoder_device, resolve_device
from repro_torch.obs import Observability, get_obs
from repro_torch.runtime import checkpoint as ckpt

DIGEST_NAME = "DIGEST"


@dataclass(frozen=True)
class ResidencyConfig:
    """Knobs for the hot/cold tenant tier.

    * ``hot_budget`` — max tenant forests resident at once.
    * ``device_budget_bytes`` — optional cap on the summed device footprint
      of the resident set (0 = count budget only). A tenant's footprint is
      the larger of what its caches hold and what they would hold once
      materialized (``Forest.estimated_device_bytes``: the fact and root
      indexes and the node arena), so a hot tenant counts even before its
      caches materialize.
    * ``traffic_decay`` — per-touch multiplicative decay applied to every
      OTHER tenant's heat (exponential decay on a global touch clock);
      eviction picks the lowest effective heat, ties broken
      least-recently-touched.
    * ``digest_threshold`` — cold-query escalation gate: best digest score
      >= threshold pays the full rehydration, below it the digest answers.
      Set to a value > 1 to force digest answers, negative to force
      rehydration (queries always escalate when no digest exists).
    """
    hot_budget: int = 4
    device_budget_bytes: int = 0
    traffic_decay: float = 0.98
    digest_threshold: float = 0.35
    fsync: bool = False
    snapshot_every: int = 0
    keep_snapshots: int = 2


class TenantDigest:
    """The always-resident cold-tier sketch, on the host: one row per tree
    root — L2-normalized root embedding + root summary text. A few KB per
    tenant, so many cold tenants stay addressable."""

    __slots__ = ("emb", "texts")

    def __init__(self, emb: np.ndarray, texts: List[str]):
        self.emb = emb                    # (T, D) f32, L2-normalized rows
        self.texts = texts                # (T,) root summaries

    @classmethod
    def from_forest(cls, forest) -> "TenantDigest":
        rows: List[np.ndarray] = []
        texts: List[str] = []
        for scope_key in forest._tree_order:
            tree = forest.trees[scope_key]
            if tree.root < 0:
                continue
            e = tree.root_emb().astype(np.float32)
            rows.append(e / (np.linalg.norm(e) + 1e-6))
            texts.append(tree.text[tree.root][:200])
        dim = forest.config.embed_dim
        emb = np.stack(rows) if rows else np.zeros((0, dim), np.float32)
        return cls(emb, texts)

    def to_bytes(self) -> bytes:
        return compression.compress(codec.packb({
            "dim": int(self.emb.shape[1]),
            "emb": self.emb.astype(np.float32).tobytes(),
            "texts": list(self.texts),
        }))

    @classmethod
    def from_bytes(cls, payload: bytes) -> "TenantDigest":
        doc = codec.unpackb(compression.decompress(payload))
        dim = int(doc["dim"])
        emb = np.frombuffer(doc["emb"], np.float32).reshape(-1, dim).copy()
        return cls(emb, list(doc["texts"]))

    def nbytes(self) -> int:
        return int(self.emb.nbytes) + sum(len(t) for t in self.texts)


class _Tenant:
    __slots__ = ("tenant_id", "path", "store", "digest", "heat", "last_touch",
                 "demoted")

    def __init__(self, tenant_id: str, path: str):
        self.tenant_id = tenant_id
        self.path = path
        self.store: Optional[DurableMemForest] = None
        self.digest: Optional[TenantDigest] = None
        self.heat = 0.0                   # decayed at touch-clock resolution
        self.last_touch = 0               # global touch-clock stamp
        self.demoted = False              # demoted at least once (on disk)


class ResidencyManager:
    """Fixed device budget of hot tenant forests + transparent rehydration.

    ``device`` (None: the CUDA card) is where every hot tenant's forest
    runs; the one ``encoder`` shared by every tenant and by the digest gate
    must run there too (default: a ``HashingEncoder`` on it).

    ``auto_enforce=True`` (standalone use) demotes over-budget tenants at
    the end of every ingest/query call; a ``ServeEngine`` sets it False and
    drains ``enforce_budget`` on its residency lane instead, so demotion
    work (snapshot + device free) never sits on the decode path.

    Thread-safe: one RLock guards the tenant table, so the maintenance
    plane's background thread can evict while the serve thread queries. A
    caller that also holds a ``MaintenancePlane``'s lock takes that lock
    first, then this one, never the reverse. ``crash=`` accepts a
    :class:`repro_torch.runtime.fault_tolerance.CrashInjector` ticked at
    rehydration boundaries (demotion boundaries tick inside
    ``DurableMemForest.demote``).
    """

    def __init__(self, root_dir: str, *, config: Optional[ResidencyConfig] = None,
                 mem_config: Optional[MemForestConfig] = None, encoder=None,
                 device=None, crash=None, auto_enforce: bool = True,
                 obs: Optional[Observability] = None):
        from repro_torch.core.encoder import HashingEncoder

        self.root = root_dir
        self.config = config or ResidencyConfig()
        self.mem_config = mem_config or MemForestConfig()
        self.device = resolve_device(device)
        # ONE encoder shared by every tenant store and the digest gate —
        # encoders are stateless apart from call/token counters
        if encoder is None:
            encoder = HashingEncoder(dim=self.mem_config.embed_dim,
                                     device=self.device)
        check_encoder_device(encoder, self.device, "ResidencyManager")
        self.encoder = encoder
        self.crash = crash
        self.auto_enforce = auto_enforce
        self.lock = threading.RLock()
        self._tenants: Dict[str, _Tenant] = {}
        self._clock = 0
        # counters live in the registry (residency/* namespace) and read
        # back through the properties below. Demote, rehydrate and digest
        # answer each run under a span whose attributes are plain numbers
        # and ids: no span keeps a tensor alive past a demotion.
        self.obs = get_obs(obs)
        reg = self.obs.registry
        self._m_evictions = reg.counter("residency/evictions")
        self._m_rehydrations = reg.counter("residency/rehydrations")
        self._m_digest_answers = reg.counter("residency/digest_answers")
        self._m_digest_escalations = reg.counter("residency/digest_escalations")
        self._m_bytes_released = reg.counter("residency/bytes_released")
        os.makedirs(root_dir, exist_ok=True)
        self._scan_existing()

    # ------------------------------------------------------------------
    # registry-backed counters
    # ------------------------------------------------------------------
    @property
    def evictions(self) -> int:
        return self._m_evictions.value

    @property
    def rehydrations(self) -> int:
        return self._m_rehydrations.value

    @property
    def digest_answers(self) -> int:
        return self._m_digest_answers.value

    @property
    def digest_escalations(self) -> int:
        return self._m_digest_escalations.value

    @property
    def bytes_released(self) -> int:
        return self._m_bytes_released.value

    # ------------------------------------------------------------------
    # tenant table
    # ------------------------------------------------------------------
    def _scan_existing(self) -> None:
        """Register on-disk tenants as COLD entries (digest loaded when the
        sidecar exists) — a restarted manager resumes with every tenant
        addressable and zero device bytes."""
        for name in sorted(os.listdir(self.root)):
            p = os.path.join(self.root, name)
            if not os.path.isdir(p):
                continue
            if not (ckpt.read_latest(p)
                    or os.path.exists(os.path.join(p, JOURNAL_NAME))):
                continue
            t = _Tenant(name, p)
            t.demoted = True
            dpath = os.path.join(p, DIGEST_NAME)
            if os.path.exists(dpath):
                with open(dpath, "rb") as f:
                    t.digest = TenantDigest.from_bytes(f.read())
            self._tenants[name] = t

    def _get(self, tenant_id: str) -> _Tenant:
        t = self._tenants.get(tenant_id)
        if t is None:
            if os.sep in tenant_id or tenant_id in ("", ".", ".."):
                raise ValueError(f"tenant id {tenant_id!r} is not a valid "
                                 "directory name")
            t = _Tenant(tenant_id, os.path.join(self.root, tenant_id))
            self._tenants[tenant_id] = t
        return t

    def _touch(self, t: _Tenant) -> None:
        self._clock += 1
        t.heat = self._effective_heat(t) + 1.0
        t.last_touch = self._clock

    def _effective_heat(self, t: _Tenant) -> float:
        return t.heat * self.config.traffic_decay ** (self._clock - t.last_touch)

    def _tick(self, event: str) -> None:
        if self.crash is not None:
            self.crash.tick(event)

    # ------------------------------------------------------------------
    # residency transitions
    # ------------------------------------------------------------------
    def _rehydrate(self, t: _Tenant) -> None:
        """Cold -> hot: exactly the crash-recovery open (snapshot +
        journal-tail replay) on the manager's device. Device caches
        re-upload lazily on the first index access, so only THIS tenant's
        rows ever transfer."""
        was_cold = t.demoted or ckpt.read_latest(t.path) is not None \
            or os.path.exists(os.path.join(t.path, JOURNAL_NAME))
        with self.obs.span("residency.rehydrate", tenant=t.tenant_id):
            self._tick("rehydrate:begin")
            cfg = self.config
            store = DurableMemForest.open(
                t.path, config=self.mem_config, encoder=self.encoder,
                device=self.device, fsync=cfg.fsync,
                snapshot_every=cfg.snapshot_every, crash=self.crash,
                keep_snapshots=cfg.keep_snapshots, obs=self.obs)
            t.store = store
            self._tick("rehydrate:commit")
        if was_cold:
            self._m_rehydrations.inc()
        t.demoted = False

    def _demote(self, t: _Tenant) -> None:
        """Hot -> cold: flush pending derived work, rebuild + durably write
        the digest sidecar, then the checkpoint-class demotion (snapshot +
        LATEST flip + journal rotation + device-cache free), then drop the
        store: after this, nothing of the manager holds the tenant's
        tensors.

        The freed blocks go back to the caching allocator at once, though a
        launch queued earlier on the default stream (the serve thread's, or
        this thread's) may still read them: the allocator hands them out
        again only to work queued on that stream after those launches, so
        a later rehydration never overwrites rows a queued launch reads."""
        store = t.store
        assert store is not None
        freed = self._footprint(t)
        with self.obs.span("residency.demote", tenant=t.tenant_id,
                           bytes=freed):
            if store.forest.dirty_trees:
                # digest + snapshot must capture fresh root summaries; flush
                # is derived-only work (never journaled), safe at any point
                store.forest.flush()
            digest = TenantDigest.from_forest(store.forest)
            self._tick("demote:digest")
            self._write_digest(t, digest)
            store.demote()                # ticks demote:begin/commit inside
            store.close()
        t.store = None
        t.digest = digest
        t.demoted = True
        self._m_evictions.inc()
        self._m_bytes_released.inc(freed)

    def _write_digest(self, t: _Tenant, digest: TenantDigest) -> None:
        path = os.path.join(t.path, DIGEST_NAME)
        os.makedirs(t.path, exist_ok=True)
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:
            f.write(digest.to_bytes())
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
        ckpt.fsync_dir(t.path)

    # ------------------------------------------------------------------
    # public API
    # ------------------------------------------------------------------
    def acquire(self, tenant_id: str) -> DurableMemForest:
        """Touch + return the tenant's hot store, rehydrating if cold. Does
        NOT enforce the budget — callers (or the residency lane) do."""
        with self.lock:
            t = self._get(tenant_id)
            self._touch(t)
            if t.store is None:
                self._rehydrate(t)
            return t.store

    def ingest(self, tenant_id: str, sessions, *,
               idempotency_key: Optional[str] = None,
               defer_flush: bool = False):
        """Durable exactly-once ingest on the tenant's journal (rehydrates
        a cold tenant first — writes always land in the real store)."""
        with self.lock:
            store = self.acquire(tenant_id)
            out = store.ingest_batch(sessions, idempotency_key=idempotency_key,
                                     defer_flush=defer_flush)
        if self.auto_enforce:
            self.enforce_budget()
        return out

    def query_batch(self, tenant_id: str, queries, *, mode: Optional[str] = None,
                    final_topk: Optional[int] = None) -> List[QueryResult]:
        """Tiered read path. Hot tenant: the normal batched query. Cold
        tenant: digest gate first — escalate (rehydrate + full query) only
        when the digest's best score clears the threshold, else answer from
        the digest (mode is moot there: the digest IS root-only evidence)."""
        with self.lock:
            t = self._get(tenant_id)
            self._touch(t)
            if t.store is None:
                res = self._digest_answer(t, queries, final_topk)
                if res is not None:
                    self._m_digest_answers.inc(len(queries))
                    return res
                if t.digest is not None and t.digest.emb.shape[0]:
                    self._m_digest_escalations.inc()
                self._rehydrate(t)
            out = t.store.query_batch(queries, mode=mode, final_topk=final_topk)
        if self.auto_enforce:
            self.enforce_budget()
        return out

    def query(self, tenant_id: str, q, *, mode: Optional[str] = None,
              final_topk: Optional[int] = None) -> QueryResult:
        return self.query_batch(tenant_id, [q], mode=mode,
                                final_topk=final_topk)[0]

    def demote(self, tenant_id: str) -> bool:
        """Explicitly demote one tenant (True if it was resident)."""
        with self.lock:
            t = self._tenants.get(tenant_id)
            if t is None or t.store is None:
                return False
            self._demote(t)
            return True

    def state_digest(self, tenant_id: str) -> str:
        """Persistent-state identity hash for one tenant (rehydrates)."""
        return self.acquire(tenant_id).state_digest()

    # ------------------------------------------------------------------
    # budget enforcement (traffic-aware LRU)
    # ------------------------------------------------------------------
    def _residents(self) -> List[_Tenant]:
        return [t for t in self._tenants.values() if t.store is not None]

    def _footprint(self, t: _Tenant) -> int:
        f = t.store.forest
        return max(f.device_bytes(), f.estimated_device_bytes())

    def over_budget(self) -> int:
        """How many demotions the budget currently calls for (0 = within)."""
        with self.lock:
            res = self._residents()
            over = max(0, len(res) - self.config.hot_budget)
            cap = self.config.device_budget_bytes
            if cap and len(res) > 1:
                total = sum(self._footprint(t) for t in res)
                sized = sorted((self._footprint(t) for t in res), reverse=True)
                n = 0
                while total > cap and n < len(sized) - 1:
                    total -= sized[n]
                    n += 1
                over = max(over, n)
            return over

    def enforce_budget(self, max_demotions: Optional[int] = None) -> int:
        """Demote lowest-heat residents until within budget (or the per-call
        cap — the engine passes its residency budget so one drain turn
        stays bounded). Returns demotions performed."""
        done = 0
        with self.lock:
            while self.over_budget() and (max_demotions is None
                                          or done < max_demotions):
                res = self._residents()
                if len(res) <= 1 and len(res) <= self.config.hot_budget:
                    break
                victim = min(res, key=lambda t: (self._effective_heat(t),
                                                 t.last_touch, t.tenant_id))
                self._demote(victim)
                done += 1
        return done

    # ------------------------------------------------------------------
    # introspection
    # ------------------------------------------------------------------
    def is_resident(self, tenant_id: str) -> bool:
        with self.lock:
            t = self._tenants.get(tenant_id)
            return t is not None and t.store is not None

    def tenant_ids(self) -> List[str]:
        with self.lock:
            return sorted(self._tenants)

    def metrics(self) -> Dict[str, Any]:
        """The manager's figures, its transition counters read from the
        registry."""
        with self.lock:
            res = self._residents()
            return {
                "tenants": len(self._tenants),
                "hot_tenants": len(res),
                "cold_tenants": len(self._tenants) - len(res),
                "hot_budget": self.config.hot_budget,
                "evictions": self._m_evictions.value,
                "rehydrations": self._m_rehydrations.value,
                "digest_answers": self._m_digest_answers.value,
                "digest_escalations": self._m_digest_escalations.value,
                "device_bytes": sum(t.store.forest.device_bytes()
                                    for t in res),
                "device_bytes_est": sum(self._footprint(t) for t in res),
                "digest_bytes": sum(t.digest.nbytes()
                                    for t in self._tenants.values()
                                    if t.digest is not None),
                "bytes_released": self._m_bytes_released.value,
            }

    def close(self) -> None:
        """Close every hot store's journal (no demotion — state stays hot
        on disk exactly as the journal + last snapshot describe it)."""
        with self.lock:
            for t in self._tenants.values():
                if t.store is not None:
                    t.store.close()
                    t.store = None

    def __enter__(self) -> "ResidencyManager":
        return self

    def __exit__(self, *exc) -> bool:
        self.close()
        return False

    # ------------------------------------------------------------------
    # digest gate (numpy on the host: a cold tenant costs no device work)
    # ------------------------------------------------------------------
    def _digest_answer(self, t: _Tenant, queries,
                       final_topk: Optional[int]) -> Optional[List[QueryResult]]:
        """Score the batch against the tenant digest. Returns answers when
        the best score stays BELOW the escalation threshold (low confidence
        that rehydration would surface more than the digest already holds);
        None means escalate — also when no digest exists (unknown tenant
        content must not be answered from nothing)."""
        digest = t.digest
        if digest is None or digest.emb.shape[0] == 0:
            return None
        with self.obs.span("residency.digest_answer", tenant=t.tenant_id,
                           queries=len(queries)) as sp:
            return self._digest_answer_scored(t, queries, final_topk, sp)

    def best_digest_score(self, tenant_id: str, queries) -> Optional[float]:
        """The best digest score of ``queries`` for a cold tenant: what the
        escalation gate compares with ``digest_threshold``. None when the
        tenant is hot or has no digest (the gate does not run)."""
        with self.lock:
            t = self._tenants.get(tenant_id)
            if t is None or t.store is not None or t.digest is None \
                    or t.digest.emb.shape[0] == 0:
                return None
            return float(self._digest_sims(t.digest, queries).max())

    def _digest_sims(self, digest: TenantDigest, queries) -> np.ndarray:
        q_embs = self.encoder.encode([q.text for q in queries])
        qn = q_embs / (np.linalg.norm(q_embs, axis=-1, keepdims=True) + 1e-6)
        return qn @ digest.emb.T                      # (Q, T)

    def _digest_answer_scored(self, t: _Tenant, queries,
                              final_topk: Optional[int],
                              sp) -> Optional[List[QueryResult]]:
        digest = t.digest
        t0 = time.perf_counter()
        calls0 = self.encoder.stats.calls
        sims = self._digest_sims(digest, queries)
        if float(sims.max()) >= self.config.digest_threshold:
            sp.set(answered=False)                    # escalating
            return None
        sp.set(answered=True)
        topk = final_topk or self.mem_config.final_topk
        rows_k = min(self.mem_config.forest_recall_topk, digest.emb.shape[0])
        out: List[QueryResult] = []
        t1 = time.perf_counter()
        for qi, q in enumerate(queries):
            order = np.argsort(-sims[qi], kind="stable")[:rows_k]
            evidence = [digest.texts[i] for i in order]
            facts: List[CanonicalFact] = []
            for i in order:
                # same lossy summary re-extraction as root-only mode
                # (retrieval._facts_from_summaries)
                for cand in T.parse_statement(digest.texts[i], ("digest", 0)):
                    facts.append(CanonicalFact(
                        fact_id=-1, text=cand.text, subject=cand.subject,
                        attribute=cand.attribute, value=cand.value, ts=cand.ts,
                        prev_value=cand.prev_value, sources=[cand.source],
                        emb=None))
            out.append(QueryResult(
                answer=answer_query(q, facts[:topk]),
                evidence=evidence,
                retrieval_s=(t1 - t0) / max(len(queries), 1),
                answer_s=(time.perf_counter() - t1) / max(len(queries), 1),
                encoder_calls=self.encoder.stats.calls - calls0,
            ))
        return out
