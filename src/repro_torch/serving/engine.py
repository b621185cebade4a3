"""Batched serving engine: continuous batching + prefill reuse, with
MemForest's ingest and query lanes riding the same loop.

Counterpart of the JAX package's ``serving/engine.py``. Continuous batching:
a fixed slot array; finished sequences are evicted and queued requests
admitted between decode steps. Each admission prefills a full-width,
right-aligned token block, and its slots' cache rows are copied into the
live cache, so active decodes are untouched.

Ingest lane: whole sessions queued with ``submit_session`` drain between
decode steps as ONE ``ingest_batch`` per engine iteration. Query lane:
retrieval requests queued with ``submit_query`` drain as ONE ``query_batch``
per iteration. Decode, ingest and query traffic share the loop.

Maintenance lane: when built with a ``maintenance`` plane
(core/maintenance_plane.py), ingest drains stop flushing inline
(``defer_flush=True``) and the engine instead runs ``maintenance_budget``
units of maintenance work — summary refresh, compaction, queued merges — per
step. Every access of the ingest and query lanes to the memory holds the
plane's lock (``_memory_lock``): the plane's background thread, when
started, writes the forest and its device caches in place.

Residency lane: pass ``residency=ResidencyManager(...)``
(core/residency.py) and ``submit_session``/``submit_query`` accept a
``tenant=`` id routed through the hot/cold tier: cold tenants rehydrate
inside the drains (queries may answer from the digest instead), and budget
enforcement (demotion: snapshot + freeing the tenant's device caches) runs
as its own bounded drain after the maintenance lane, so eviction never sits
on a decode step. ``tenant=None`` requests use the engine's single
``memory`` as before. The tenant drains hold the plane's lock too, when a
plane is attached (its worker may flush or demote a tenant's forest): the
plane's lock first, then the manager's.

Multi-device serve: pass ``sharded=ShardedServeConfig(devices=N)`` to shard
the memory system's serve path over a 1-D data mesh of N cards
(``launch.mesh.make_data_mesh`` + ``MemForestSystem.set_mesh``): fact-index
rows round-robin across cards with shard-local top-k + candidate merge, the
browse frontier and the flush batches split over the same axis. Results are
exactly identical to single-device serve (kernels/shard_ops.py); with fewer
than 2 cards the config degrades to the mesh=None path. A mesh over one
card (``DataMesh(("cuda:0",) * S)``) goes to ``memory.set_mesh`` directly.

KV cache and prefill reuse. The model writes each decode step's K/V rows
(and, for rwkv6 and zamba2, its recurrent state) into the live cache IN
PLACE (``models.transformer.decode_step`` and its counterparts). The
prefix cache keeps whole prefill results ``(logits, cache)``; the live cache
is therefore always the engine's own copy (a cloned tree when an admission
adopts a prefill result), so a decode step never writes into a stored
entry and a later prefix hit replays the prefill as it was computed.

Observability: the same ``serve/*`` counters and histograms as the JAX
engine, and the same spans (``engine.step``, ``engine.admit``,
``engine.prefill``, ``engine.decode``, ``engine.drain.ingest``,
``engine.drain.query``, ``engine.drain.maintenance``,
``engine.drain.residency``) through ``repro_torch.obs``.
"""
from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.launch.mesh import make_data_mesh
from repro_torch.models.factory import Model
from repro_torch.obs import Observability, get_obs


@dataclass
class Request:
    req_id: int
    prompt_tokens: List[int]
    max_new_tokens: int = 8
    prefix_key: Optional[str] = None    # shared-prefix cache key
    out_tokens: List[int] = field(default_factory=list)
    submitted_s: float = 0.0
    finished_s: float = 0.0


class PrefixCache:
    """Prefill reuse cache for shared prompt prefixes.

    One entry per (prefix_key, padded admission signature): the prefill of a
    whole right-aligned token block. Prefill is a pure function of the
    padded token matrix, so when an admission with the same prefix_key
    reproduces the same block, the cached (logits, KV) are reused and the
    prefill is skipped. Entries are never written after they are stored (the
    engine clones what it adopts). Eviction is FIFO over ``max_entries``."""

    def __init__(self, max_entries: int = 4):
        self.entries: Dict[Tuple, Tuple] = {}
        self.max_entries = max_entries
        self.hits = 0
        self.misses = 0

    def get(self, key: str, sig: Tuple):
        e = self.entries.get((key, sig))
        if e is not None:
            self.hits += 1
            return e
        self.misses += 1
        return None

    def put(self, key: str, sig: Tuple, logits, cache) -> None:
        if len(self.entries) >= self.max_entries:
            self.entries.pop(next(iter(self.entries)))
        self.entries[(key, sig)] = (logits, cache)


@dataclass(frozen=True)
class ShardedServeConfig:
    """Multi-device serve knobs. ``devices=0`` means all visible cards;
    anything that resolves to <2 cards falls back to single-device."""
    devices: int = 0
    axis: str = "data"


class ServeEngine:
    def __init__(self, model: Model, params, *, max_batch: int = 8,
                 max_len: int = 512, eos_id: int = 2,
                 memory=None, max_ingest_batch: int = 16,
                 max_query_batch: int = 32,
                 maintenance=None, maintenance_budget: int = 1,
                 sharded: Optional[ShardedServeConfig] = None,
                 residency=None, residency_budget: int = 1,
                 obs: Optional[Observability] = None):
        self.model = model
        self.params = params
        self.device = params["embed"].device
        self.max_batch = max_batch
        self.max_len = max_len
        self.eos_id = eos_id
        self.queue: List[Request] = []
        self.active: List[Optional[Request]] = [None] * max_batch
        self.finished: List[Request] = []
        self.cache = None
        self._last_logits = None
        self.prefix_cache = PrefixCache()
        self._next_id = 0
        self.obs = get_obs(obs)
        reg = self.obs.registry
        self._m_steps = reg.counter("serve/decode_steps")
        self._m_decoded = reg.counter("serve/decoded_tokens")
        self._m_occupancy = reg.counter("serve/occupancy_sum")
        self._m_prefills = reg.counter("serve/prefills")
        self._m_prefills_reused = reg.counter("serve/prefills_reused")
        self._m_ingest_batches = reg.counter("serve/ingest_batches")
        self._m_ingest_sessions = reg.counter("serve/ingest_sessions")
        self._m_query_batches = reg.counter("serve/query_batches")
        self._m_queries_served = reg.counter("serve/queries_served")
        self._m_maintenance_turns = reg.counter("serve/maintenance_turns")
        self._m_residency_turns = reg.counter("serve/residency_turns")
        self._h_ingest_wait = reg.histogram("serve/ingest_wait_s")
        self._h_query_wait = reg.histogram("serve/query_wait_s")
        self._h_decode_request = reg.histogram("serve/decode_request_s")
        self.memory = memory
        # multi-device serve: attach a data mesh to the memory system so the
        # ingest/query drains below run the sharded serve path transparently
        self.serve_mesh = None
        if sharded is not None and memory is not None:
            self.serve_mesh = make_data_mesh(sharded.devices, sharded.axis)
            memory.set_mesh(self.serve_mesh, sharded.axis)
        self.max_ingest_batch = max_ingest_batch
        self.ingest_queue: List = []
        self.max_query_batch = max_query_batch
        self.query_queue: List = []
        self.query_results: Dict[int, object] = {}
        # maintenance lane: with a plane attached, ingest drains defer their
        # flush and the engine drains `maintenance_budget` units of refresh/
        # compaction/merge work per step instead
        self.maintenance = maintenance
        self.maintenance_budget = maintenance_budget
        # residency lane: the engine owns budget enforcement (auto_enforce
        # off) and demotes at most `residency_budget` tenants a step, after
        # the serve lanes
        self.residency = residency
        self.residency_budget = residency_budget
        if residency is not None:
            residency.auto_enforce = False

    # ------------------------------------------------------------------
    # registry-backed counters (attribute access)
    # ------------------------------------------------------------------
    @property
    def steps(self) -> int:
        return self._m_steps.value

    @property
    def decoded_tokens(self) -> int:
        return self._m_decoded.value

    @property
    def occupancy_sum(self) -> float:
        return self._m_occupancy.value

    @property
    def prefills(self) -> int:
        return self._m_prefills.value

    @property
    def prefills_reused(self) -> int:
        return self._m_prefills_reused.value

    @property
    def ingest_batches(self) -> int:
        return self._m_ingest_batches.value

    @property
    def ingest_sessions(self) -> int:
        return self._m_ingest_sessions.value

    @property
    def query_batches(self) -> int:
        return self._m_query_batches.value

    @property
    def queries_served(self) -> int:
        return self._m_queries_served.value

    @property
    def maintenance_turns(self) -> int:
        return self._m_maintenance_turns.value

    @property
    def residency_turns(self) -> int:
        return self._m_residency_turns.value

    # ------------------------------------------------------------------
    def submit(self, prompt_tokens: List[int], max_new_tokens: int = 8,
               prefix_key: Optional[str] = None) -> int:
        r = Request(self._next_id, list(prompt_tokens), max_new_tokens,
                    prefix_key, submitted_s=time.perf_counter())
        self._next_id += 1
        self.queue.append(r)
        return r.req_id

    def _check_destination(self, tenant: Optional[str]) -> None:
        if tenant is not None:
            if self.residency is None:
                raise RuntimeError(
                    "tenant= requires a ResidencyManager (residency=)")
        elif self.memory is None:
            raise RuntimeError("ServeEngine was built without a memory system")

    def submit_session(self, session, *, tenant: Optional[str] = None) -> None:
        """Queue a session for the ingest lane. ``tenant`` routes the write
        through the residency tier (rehydrating a cold tenant on drain);
        None targets the engine's single memory system."""
        self._check_destination(tenant)
        self.ingest_queue.append((tenant, session, time.perf_counter()))

    def _memory_lock(self):
        """Forest-access guard: the maintenance plane's lock when one is
        attached (its background worker may be writing the forest), a no-op
        otherwise."""
        if self.maintenance is not None:
            return self.maintenance.lock
        return contextlib.nullcontext()

    def _drain_ingest(self) -> int:
        """One ingest-lane turn: everything queued (capped) goes through a
        single batched write per destination — the shared memory system, or
        one ``ResidencyManager.ingest`` per tenant (cold tenants rehydrate
        here, inside the drain). With a maintenance plane attached the
        shared system's flush is deferred to the plane. Returns sessions
        ingested."""
        if not self.ingest_queue:
            return 0
        batch = self.ingest_queue[: self.max_ingest_batch]
        del self.ingest_queue[: len(batch)]
        with self.obs.span("engine.drain.ingest", sessions=len(batch)):
            groups: Dict[Optional[str], List] = {}
            for tenant, session, _t in batch:
                groups.setdefault(tenant, []).append(session)
            for tenant, sessions in groups.items():
                with self._memory_lock():
                    if tenant is not None:
                        self.residency.ingest(tenant, sessions)
                    elif self.maintenance is not None:
                        self.memory.ingest_batch(sessions, defer_flush=True)
                    else:
                        self.memory.ingest_batch(sessions)
                self._m_ingest_batches.inc()
        now = time.perf_counter()
        for _tenant, _session, t in batch:
            self._h_ingest_wait.record(now - t)
        self._m_ingest_sessions.inc(len(batch))
        return len(batch)

    def submit_query(self, query, *, mode: Optional[str] = None,
                     final_topk: Optional[int] = None,
                     tenant: Optional[str] = None) -> int:
        """Queue a retrieval request for the query lane. ``tenant`` routes
        through the residency tier (digest answer or rehydration on drain);
        None targets the engine's single memory system. The result lands in
        ``query_results[req_id]`` after the engine step that drains it."""
        self._check_destination(tenant)
        rid = self._next_id
        self._next_id += 1
        self.query_queue.append((rid, tenant, query, mode, final_topk,
                                 time.perf_counter()))
        return rid

    def pop_query_result(self, req_id: int):
        """Consume a finished query's result (None if not served yet)."""
        return self.query_results.pop(req_id, None)

    def _drain_queries(self) -> int:
        """One query-lane turn: everything queued (capped) goes through one
        ``query_batch`` per distinct (tenant, mode, topk) group, usually
        exactly one. Tenant groups run through the residency tier (digest
        gate or rehydration, here inside the drain). Returns queries
        answered."""
        if not self.query_queue:
            return 0
        batch = self.query_queue[: self.max_query_batch]
        del self.query_queue[: len(batch)]
        with self.obs.span("engine.drain.query", queries=len(batch)):
            groups: Dict[Tuple, List] = {}
            for rid, tenant, q, mode, topk, _t in batch:
                groups.setdefault((tenant, mode, topk), []).append((rid, q))
            for (tenant, mode, topk), items in groups.items():
                qs = [q for _, q in items]
                with self._memory_lock():
                    if tenant is not None:
                        res = self.residency.query_batch(
                            tenant, qs, mode=mode, final_topk=topk)
                    else:
                        res = self.memory.query_batch(qs, mode=mode,
                                                      final_topk=topk)
                for (rid, _q), r in zip(items, res):
                    self.query_results[rid] = r
                self._m_query_batches.inc()
        now = time.perf_counter()
        for rec in batch:
            self._h_query_wait.record(now - rec[5])
        self._m_queries_served.inc(len(batch))
        return len(batch)

    # ------------------------------------------------------------------
    def _admit(self) -> List[Request]:
        """Fill free slots from the queue. New slots are prefilled as a
        full-width batch and their cache rows COPIED into the live cache;
        active decodes are untouched (continuous batching)."""
        free = [i for i, a in enumerate(self.active) if a is None]
        if not free or not self.queue:
            return []
        admitted_slots: List[int] = []
        for i in free:
            if not self.queue:
                break
            self.active[i] = self.queue.pop(0)
            admitted_slots.append(i)

        B = self.max_batch
        L = max(max(len(self.active[i].prompt_tokens) for i in admitted_slots),
                2)
        toks = np.zeros((B, L), np.int64)
        for i in admitted_slots:
            p = self.active[i].prompt_tokens
            toks[i, L - len(p):] = p          # right-align
        # prefill reuse: when every admitted request carries the same
        # prefix_key and this admission reproduces a cached padded token
        # block, the prefill is skipped (prefill is a pure function of the
        # block). Stored entries are never written: see the adoption below.
        pkeys = {self.active[i].prefix_key for i in admitted_slots}
        pkey = pkeys.pop() if len(pkeys) == 1 else None
        sig = (tuple(admitted_slots), toks.tobytes()) if pkey is not None else None
        hit = self.prefix_cache.get(pkey, sig) if pkey is not None else None
        self._m_prefills.inc()
        if hit is not None:
            logits, new_cache = hit
            self._m_prefills_reused.inc()
        else:
            with self.obs.span("engine.prefill", slots=len(admitted_slots),
                               width=int(L)):
                logits, new_cache = self.model.prefill(
                    self.params,
                    {"tokens": torch.from_numpy(toks).to(self.device)},
                    self.max_len)
            if pkey is not None:
                self.prefix_cache.put(pkey, sig, logits, new_cache)

        if self.cache is None:
            # the live cache is written in place by every decode step: adopt
            # a copy, never a tree the prefix cache may hand out again
            self.cache = {k: v.clone() for k, v in new_cache.items()}
            self._last_logits = logits.clone()
        else:
            slots = torch.tensor(admitted_slots, dtype=torch.long,
                                 device=self.device)
            self._merge(new_cache, slots)
            self._last_logits[slots] = logits[slots]
        return [self.active[i] for i in admitted_slots]

    def _merge(self, new_cache, slots: torch.Tensor) -> None:
        """Copy the admitted slots' rows of a prefill's cache into the live
        cache, IN PLACE, by the reference's rule for every entry: shaped
        (num_layers, B, ...) -> along axis 1; else shaped (B, ...) -> along
        axis 0; else left as it is. The last case is zamba2's per-application
        KV caches (G, B, ...): the reference leaves them stale (or, when G
        equals B, merges them along the group axis), and the port matches it
        (ROADMAP.md, section 3)."""
        B = self.max_batch
        num_layers = self.model.cfg.num_layers
        for key, old in self.cache.items():
            if old.dim() >= 2 and old.shape[0] == num_layers \
                    and old.shape[1] == B:
                old[:, slots] = new_cache[key][:, slots]
            elif old.dim() >= 1 and old.shape[0] == B:
                old[slots] = new_cache[key][slots]

    # ------------------------------------------------------------------
    def step(self) -> int:
        """One engine iteration: admit + one decode step for all active,
        then one ingest-lane, one query-lane, one maintenance-lane and one
        residency-lane drain.
        Returns the number of finished decode requests. Every phase runs
        under its own span."""
        with self.obs.span("engine.step"):
            with self.obs.span("engine.admit"):
                self._admit()
            act = [a for a in self.active if a is not None]
            if not act:
                self._drain_ingest()
                self._drain_queries()
                self._drain_maintenance()
                self._drain_residency()
                return 0
            self._m_occupancy.inc(len(act) / self.max_batch)
            self._m_steps.inc()

            with self.obs.span("engine.decode", lanes=len(act)):
                # greedy next token from the last logits, on the device
                next_tok = torch.argmax(self._last_logits, dim=-1)
                # the one sanctioned sync: greedy sampling must read the
                # token ids before Python can append them to lane buffers
                host_tok = next_tok.tolist()  # memlint: ignore[host-sync]
                for i, a in enumerate(self.active):
                    if a is None:
                        continue
                    a.out_tokens.append(host_tok[i])
                    self._m_decoded.inc()
                self._last_logits, self.cache = self.model.decode(
                    self.params, {"tokens": next_tok}, self.cache)

            finished = 0
            for i, a in enumerate(self.active):
                if a is None:
                    continue
                if len(a.out_tokens) >= a.max_new_tokens or a.out_tokens[-1] == self.eos_id:
                    a.finished_s = time.perf_counter()
                    self._h_decode_request.record(a.finished_s - a.submitted_s)
                    self.finished.append(a)
                    self.active[i] = None
                    finished += 1
            self._drain_ingest()
            self._drain_queries()
            self._drain_maintenance()
            self._drain_residency()
            return finished

    def _drain_maintenance(self) -> int:
        """One maintenance-lane turn: a bounded slice of refresh/compaction/
        merge work (no-op when no plane is attached, or when its budget is
        0 because the plane runs its own background thread)."""
        if self.maintenance is None or self.maintenance_budget <= 0:
            return 0
        if self.maintenance.pending() == 0:
            return 0
        with self.obs.span("engine.drain.maintenance"):
            done = self.maintenance.run_some(self.maintenance_budget)["units"]
        if done:
            self._m_maintenance_turns.inc()
        return done

    def _drain_residency(self) -> int:
        """One residency-lane turn: demote at most ``residency_budget``
        over-budget tenants (snapshot + freeing their device caches), under
        the plane's lock when a plane is attached."""
        if self.residency is None or self.residency_budget <= 0:
            return 0
        if self.residency.over_budget() == 0:
            return 0
        with self.obs.span("engine.drain.residency"), self._memory_lock():
            done = self.residency.enforce_budget(self.residency_budget)
        if done:
            self._m_residency_turns.inc()
        return done

    # ------------------------------------------------------------------
    def run_until_drained(self, max_steps: int = 10000) -> List[Request]:
        for _ in range(max_steps):
            if not self.queue and not self.ingest_queue \
                    and not self.query_queue \
                    and all(a is None for a in self.active):
                # cooperative maintenance keeps stepping until its backlog
                # (deferred flushes, compactions, merges) is drained too,
                # and residency until the hot set is back within budget
                if (self.maintenance is None or self.maintenance_budget <= 0
                        or self.maintenance.pending() == 0) \
                        and (self.residency is None
                             or self.residency_budget <= 0
                             or self.residency.over_budget() == 0):
                    break
            self.step()
        return self.finished

    def metrics(self) -> Dict[str, float]:
        """Flat metrics dict, read through the registry: every counter
        below is a ``serve/*`` registry counter."""
        steps = self._m_steps.value
        return {
            "decode_steps": steps,
            "decoded_tokens": self._m_decoded.value,
            "mean_occupancy": self._m_occupancy.value / max(steps, 1),
            "prefix_hits": self.prefix_cache.hits,
            "prefix_misses": self.prefix_cache.misses,
            "prefills": self._m_prefills.value,
            "prefills_reused": self._m_prefills_reused.value,
            "ingest_batches": self._m_ingest_batches.value,
            "ingest_sessions": self._m_ingest_sessions.value,
            "mean_ingest_batch": self._m_ingest_sessions.value
            / max(self._m_ingest_batches.value, 1),
            "query_batches": self._m_query_batches.value,
            "queries_served": self._m_queries_served.value,
            "mean_query_batch": self._m_queries_served.value
            / max(self._m_query_batches.value, 1),
            # per-request wait distributions (seconds)
            "ingest_wait_p50_s": self._h_ingest_wait.quantile(0.5),
            "ingest_wait_p99_s": self._h_ingest_wait.quantile(0.99),
            "query_wait_p50_s": self._h_query_wait.quantile(0.5),
            "query_wait_p99_s": self._h_query_wait.quantile(0.99),
            "maintenance_turns": self._m_maintenance_turns.value,
            "residency_turns": self._m_residency_turns.value,
            "serve_devices": (self.serve_mesh.size
                              if self.serve_mesh is not None else 1),
            **(self.maintenance.metrics() if self.maintenance is not None else {}),
            # hot_tenants, evictions, rehydrations, digest_answers,
            # device_bytes(_est), ...
            **(self.residency.metrics() if self.residency is not None else {}),
        }

    def latency_summary(self) -> Dict[str, Dict[str, float]]:
        """Per-phase span-duration summaries (populated while tracing is
        enabled): {span name: {count, mean_s, p50_s, p90_s, p99_s, ...}}."""
        return self.obs.registry.latency_summary()


class BatchedEncoderServer:
    """The extraction front-end: batches chunk-encode requests from many
    concurrent sessions into single forwards, with shared-prefix
    accounting."""

    def __init__(self, encoder, shared_prefix: str = "[extract facts] "):
        self.encoder = encoder
        self.shared_prefix = shared_prefix
        self.prefix_tokens_saved = 0

    def encode_chunks(self, chunk_texts: List[str]) -> np.ndarray:
        # prefix is shared: tokens for it are paid once per batch, not per chunk
        n = len(chunk_texts)
        if n == 0:
            return np.zeros((0, self.encoder.dim), np.float32)
        prefix_tok = max(len(self.shared_prefix.split()), 1)
        self.prefix_tokens_saved += prefix_tok * (n - 1)
        return self.encoder.encode([self.shared_prefix + t for t in chunk_texts])
