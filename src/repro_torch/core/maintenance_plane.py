"""Async maintenance plane: summary refresh, compaction, and merge work off
the serve loop.

Counterpart of the JAX package's ``core/maintenance_plane.py``. The serve
path only *marks* work — ingest leaves trees dirty (``defer_flush=True``),
deletions tombstone leaves, merge requests queue — and the
:class:`MaintenancePlane` drains it in bounded slices:

  * **cooperative mode** (default): :meth:`run_some` executes up to
    ``budget`` work units; :class:`repro_torch.serving.engine.ServeEngine`
    calls it once per decode step, so refresh launches interleave with the
    decode cadence instead of blocking an ingest or query drain.
  * **background mode**: :meth:`start_background` runs the same drain on a
    worker thread under ``self.lock``. The port writes its device caches in
    place (``Forest._sync_device``, ``Forest.node_arena``), so EVERY access
    to the forest from another thread — ingest, deletion, a query and the
    arena sync inside it, a checkpoint — must hold ``self.lock`` too (the
    serve engine does so through ``_memory_lock``). The worker launches on
    the device's default stream, as the serve thread does: launches of the
    two threads never overlap on the device, and the kernels' per-stream
    scratch (``kernels._build.counters``) stays one buffer.

One work unit = one queued merge, or one tree compaction, or one bounded
flush slice (``flush_trees_per_unit`` dirty trees through
``Forest.flush(only=...)``: one ``tree_refresh`` launch per tree level of
the slice), or, with a ``ResidencyManager`` attached, one demotion of an
over-budget tenant. Chunked flushing is state-equivalent to one full flush because
dirty paths never cross trees.

Correctness under laziness is unchanged: a reader that arrives before the
plane catches up pays the remaining flush itself (read-triggered refresh in
``MemForestSystem.query``), so answers never see stale mandatory state.
"""
from __future__ import annotations

import threading
import time
from collections import deque
from typing import Deque, Dict, Optional, Tuple

from repro_torch.core import maintenance
from repro_torch.core.forest import Forest
from repro_torch.obs import Observability, get_obs

WORKER_NAME = "memforest-maint"


class MaintenancePlane:
    def __init__(self, forest: Forest, *, flush_trees_per_unit: int = 4,
                 compact_min_dead_fraction: float = 0.3, durable=None,
                 residency=None, obs: Optional[Observability] = None):
        """``durable``: a :class:`repro_torch.core.journal.DurableMemForest`
        wrapping the same forest. When given, merges and compactions run
        through its journaled ops — both rewrite persistent state, so on a
        durable store they must be journaled for crash recovery to
        reproduce the pre-crash digest.

        ``residency``: a :class:`repro_torch.core.residency.ResidencyManager`.
        When given, one over-budget tenant demotion counts as a work unit
        (lowest priority — after merges, compaction and flush), so a worker
        thread evicts off the serve thread. The manager has its own lock,
        taken inside this plane's: plane, then manager, never the reverse."""
        self.forest = forest
        self.durable = durable
        self.residency = residency
        self.flush_trees_per_unit = flush_trees_per_unit
        self.compact_min_dead_fraction = compact_min_dead_fraction
        self.lock = threading.RLock()
        self._merge_q: Deque[Tuple[Forest, Optional[str]]] = deque()
        self._compact_q: Deque[str] = deque()
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self._worker_error: Optional[Exception] = None
        # counters live in the registry (maintenance/* namespace) and read
        # back through the properties below
        self.obs = get_obs(obs)
        reg = self.obs.registry
        self._m_units = reg.counter("maintenance/units_run")
        self._m_flushed = reg.counter("maintenance/trees_flushed")
        self._m_merges = reg.counter("maintenance/merges_done")
        self._m_compactions = reg.counter("maintenance/compactions_done")
        self._m_reclaimed = reg.counter("maintenance/slots_reclaimed")
        self._m_demotions = reg.counter("maintenance/demotions_done")

    # ------------------------------------------------------------------
    # registry-backed counters
    # ------------------------------------------------------------------
    @property
    def units_run(self) -> int:
        return self._m_units.value

    @property
    def trees_flushed(self) -> int:
        return self._m_flushed.value

    @property
    def merges_done(self) -> int:
        return self._m_merges.value

    @property
    def compactions_done(self) -> int:
        return self._m_compactions.value

    @property
    def slots_reclaimed(self) -> int:
        return self._m_reclaimed.value

    @property
    def demotions_done(self) -> int:
        return self._m_demotions.value

    # ------------------------------------------------------------------
    # scheduling
    # ------------------------------------------------------------------
    def schedule_merge(self, src, *, idempotency_key: Optional[str] = None) -> None:
        """Queue a migration merge (src: Forest or MemForestSystem)."""
        with self.lock:
            self._merge_q.append((getattr(src, "forest", src), idempotency_key))

    def schedule_compaction(self, scope_key: Optional[str] = None) -> int:
        """Queue one tree — or scan the forest for every tombstone-heavy
        tree — for compaction. Returns how many were queued."""
        with self.lock:
            if scope_key is not None:
                self._compact_q.append(scope_key)
                return 1
            cands = maintenance.compaction_candidates(
                self.forest, min_dead_fraction=self.compact_min_dead_fraction)
            queued = [k for k in cands if k not in self._compact_q]
            self._compact_q.extend(queued)
            return len(queued)

    def pending(self) -> int:
        """Outstanding work units (approximate for flush slices)."""
        with self.lock:
            flush_units = -(-len(self.forest.dirty_trees) //
                            max(self.flush_trees_per_unit, 1))
            resid_units = self.residency.over_budget() \
                if self.residency is not None else 0
            return len(self._merge_q) + len(self._compact_q) + flush_units \
                + resid_units

    # ------------------------------------------------------------------
    # draining
    # ------------------------------------------------------------------
    def _run_one(self) -> bool:
        """One work unit; returns False when there was nothing to do.
        Priority: merges (they add dirty trees), then compactions, then a
        flush slice — so structural work lands before its summaries
        regenerate — and a tenant demotion last."""
        if self._merge_q:
            src, key = self._merge_q.popleft()
            with self.obs.span("maintenance.merge"):
                if self.durable is not None:
                    # ride the journal: a crash mid-merge must replay it
                    self.durable.merge_from(src, idempotency_key=key,
                                            flush=False)
                else:
                    # non-durable deployment — there is no journal to ride
                    maintenance.migrate_merge(self.forest, src,  # memlint: ignore[journaled-mutation]
                                              idempotency_key=key, flush=False)
            self._m_merges.inc()
            return True
        if self._compact_q:
            scope = self._compact_q.popleft()
            if scope in self.forest.trees:
                with self.obs.span("maintenance.compaction", scope=scope):
                    if self.durable is not None:
                        stats = self.durable.compact_tree(scope)
                    else:
                        # non-durable deployment — no journal to ride
                        stats = maintenance.compact_tree(self.forest, scope)  # memlint: ignore[journaled-mutation]
                self._m_reclaimed.inc(stats["slots_reclaimed"])
                self._m_compactions.inc()
            return True
        if self.forest.dirty_trees:
            chunk = set(sorted(self.forest.dirty_trees)
                        [: self.flush_trees_per_unit])
            with self.obs.span("maintenance.flush_slice", trees=len(chunk)):
                self.forest.flush(only=chunk)
            self._m_flushed.inc(len(chunk))
            return True
        if self.residency is not None \
                and self.residency.enforce_budget(1):
            self._m_demotions.inc()
            return True
        return False

    def run_some(self, budget: int = 1) -> Dict[str, int]:
        """Drain up to ``budget`` work units. Safe from any thread (takes
        the plane lock). Returns {"units": executed, "pending": left}."""
        done = 0
        with self.lock:
            for _ in range(max(budget, 0)):
                if not self._run_one():
                    break
                done += 1
                self._m_units.inc()
            return {"units": done, "pending": self.pending()}

    def drain(self, max_units: int = 100000) -> int:
        """Run until no work remains; returns units executed."""
        total = 0
        while max_units > 0:
            step = self.run_some(min(max_units, 64))
            total += step["units"]
            max_units -= max(step["units"], 1)
            if step["units"] == 0:
                break
        return total

    # ------------------------------------------------------------------
    # background worker mode
    # ------------------------------------------------------------------
    def start_background(self, *, interval_s: float = 0.002,
                         budget_per_wake: int = 4) -> None:
        """Move draining to a worker thread (named ``WORKER_NAME``).
        Serve-side forest access must then also hold ``self.lock``
        (ServeEngine does when built with a plane). A failed unit stops the
        worker; :meth:`stop_background` raises its exception."""
        if self._thread is not None:
            return
        self._stop.clear()
        self._worker_error = None

        def loop():
            try:
                while not self._stop.is_set():
                    if self.run_some(budget_per_wake)["units"] == 0:
                        time.sleep(interval_s)
            except Exception as e:    # handed to the caller of stop_background
                self._worker_error = e

        self._thread = threading.Thread(target=loop, name=WORKER_NAME,
                                        daemon=True)
        self._thread.start()

    def stop_background(self, *, drain_first: bool = True) -> None:
        """Stop the worker (first draining what is left on the calling
        thread, unless ``drain_first=False``); raise the exception a unit of
        the worker failed with, if one did."""
        if self._thread is None:
            return
        if self._worker_error is None and drain_first:
            self.drain()
        self._stop.set()
        self._thread.join(timeout=5.0)
        self._thread = None
        err, self._worker_error = self._worker_error, None
        if err is not None:
            raise err

    def metrics(self) -> Dict[str, int]:
        """The plane's counters, read from the registry."""
        return {
            "maintenance_units": self._m_units.value,
            "maintenance_trees_flushed": self._m_flushed.value,
            "maintenance_merges": self._m_merges.value,
            "maintenance_compactions": self._m_compactions.value,
            "maintenance_slots_reclaimed": self._m_reclaimed.value,
            "maintenance_demotions": self._m_demotions.value,
            "maintenance_pending": self.pending(),
        }
