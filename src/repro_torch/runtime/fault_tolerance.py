"""Fault tolerance: failure detection, checkpoint/restart, straggler
mitigation, elastic re-meshing, and crash injection for the durable write
path.

A copy of the JAX package's ``runtime/fault_tolerance.py``. The control
plane runs against an injectable clock and worker set, so its logic is
testable on one CPU; ``launch/train.py`` wires the straggler accounting to
real steps, and ``FaultTolerantRunner`` restarts a step loop from a
checkpoint. ``ElasticScaler.replan`` names the (data, model) or (pod,
data, model) mesh that the cards still available can hold; the restart
onto it is ``runtime.checkpoint.restore`` with the shardings of
``train_state_shardings`` on a mesh of that shape
(``launch.mesh.make_mesh``), which lays the ZeRO-1 moments and the error
state out by that mesh's ``zero1_shardings``.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple


# ---------------------------------------------------------------------------
# failure detection
# ---------------------------------------------------------------------------
class HeartbeatMonitor:
    """Workers report heartbeats; miss `timeout_s` -> declared failed."""

    def __init__(self, workers: Sequence[str], timeout_s: float = 10.0,
                 clock: Callable[[], float] = time.monotonic):
        self.timeout_s = timeout_s
        self.clock = clock
        self.last_seen: Dict[str, float] = {w: clock() for w in workers}
        self.failed: set = set()

    def beat(self, worker: str) -> None:
        if worker not in self.failed:
            self.last_seen[worker] = self.clock()

    def check(self) -> List[str]:
        now = self.clock()
        newly = [
            w for w, t in self.last_seen.items()
            if w not in self.failed and now - t > self.timeout_s
        ]
        self.failed.update(newly)
        return newly

    @property
    def healthy(self) -> List[str]:
        return [w for w in self.last_seen if w not in self.failed]


# ---------------------------------------------------------------------------
# straggler mitigation
# ---------------------------------------------------------------------------
@dataclass
class StragglerEvent:
    step: int
    worker: str
    duration_s: float
    deadline_s: float
    action: str          # "backup_dispatched" | "observed"


class StragglerMitigator:
    """Per-step duration tracking with a rolling median deadline. A worker
    exceeding `factor` x median gets its shard re-dispatched to a backup
    (speculative execution: first result wins)."""

    def __init__(self, factor: float = 3.0, window: int = 32,
                 min_samples: int = 5):
        self.factor = factor
        self.window = window
        self.min_samples = min_samples
        self.durations: List[float] = []
        self.events: List[StragglerEvent] = []

    def record(self, duration_s: float) -> None:
        self.durations.append(duration_s)
        if len(self.durations) > self.window:
            self.durations.pop(0)

    def deadline(self) -> Optional[float]:
        if len(self.durations) < self.min_samples:
            return None
        s = sorted(self.durations)
        return s[len(s) // 2] * self.factor

    def check(self, step: int, worker: str,
              duration_s: float) -> Optional[StragglerEvent]:
        dl = self.deadline()
        self.record(duration_s)
        if dl is not None and duration_s > dl:
            ev = StragglerEvent(step, worker, duration_s, dl,
                                "backup_dispatched")
            self.events.append(ev)
            return ev
        return None


# ---------------------------------------------------------------------------
# elastic re-meshing
# ---------------------------------------------------------------------------
# allowed (pod, data, model) configurations, largest first; `model` is kept
# constant so parameter shardings stay valid and only DP width changes
DEFAULT_LADDER: Tuple[Tuple[int, int, int], ...] = (
    (2, 16, 16), (1, 16, 16), (1, 8, 16), (1, 4, 16),
)


class ElasticScaler:
    def __init__(self, ladder: Sequence[Tuple[int, int, int]] = DEFAULT_LADDER):
        self.ladder = list(ladder)

    def pick(self, devices_available: int) -> Optional[Tuple[int, int, int]]:
        for shape in self.ladder:
            need = shape[0] * shape[1] * shape[2]
            if devices_available >= need:
                return shape
        return None

    def replan(self, devices_available: int):
        """Returns (mesh_shape, axis_names) or None if unservable."""
        shape = self.pick(devices_available)
        if shape is None:
            return None
        if shape[0] == 1:
            return (shape[1], shape[2]), ("data", "model")
        return shape, ("pod", "data", "model")


# ---------------------------------------------------------------------------
# crash injection (durable write path)
# ---------------------------------------------------------------------------

class SimulatedCrash(RuntimeError):
    """Raised by CrashInjector at the configured durability event. Test
    harnesses treat it as process death: the in-memory system is discarded
    and recovery must proceed from disk alone."""


class CrashInjector:
    """Deterministic kill-point hook for the durable write path.

    The journaled store (core/journal.py) calls ``tick(event)`` at every
    durability transition — after a journal append, after an op applies to
    the in-memory forest, before a snapshot commits, after the journal
    rotates. ``crash_at=k`` raises :class:`SimulatedCrash` at the k-th event
    (1-based), so a sweep over k exercises a kill at EVERY boundary the
    exactly-once recovery contract must survive. ``crash_at=None`` records
    the event trace without crashing (used to size the sweep).

    ``obs`` (a :class:`repro_torch.obs.Observability`) mirrors every tick
    into the trace sink as a ``durability/<event>`` point event under
    whichever span is open at the time (e.g. ``journal.append`` or
    ``journal.checkpoint``)."""

    def __init__(self, crash_at: Optional[int] = None, obs=None):
        self.crash_at = crash_at
        self.obs = obs
        self.events = 0
        self.fired = False
        self.trace: List[str] = []

    def tick(self, event: str) -> None:
        if self.fired:
            return
        self.events += 1
        self.trace.append(event)
        if self.obs is not None:
            self.obs.event("durability/" + event, n=self.events)
        if self.crash_at is not None and self.events >= self.crash_at:
            self.fired = True
            raise SimulatedCrash(f"injected crash at event #{self.events} ({event})")


# ---------------------------------------------------------------------------
# driver-side recovery orchestration
# ---------------------------------------------------------------------------
@dataclass
class RecoveryLog:
    restarts: int = 0
    straggler_backups: int = 0
    remesh_events: List[Tuple[int, Tuple[int, ...]]] = field(
        default_factory=list)


class FaultTolerantRunner:
    """Wraps a step function with checkpoint/restart + straggler accounting.

    `inject_failure(at_step)` is the test hook: the runner loses its worker
    at that step, restores the last checkpoint (``restore_fn() -> (state,
    step)``) and carries on from its step. ``save_fn(state, step)`` runs
    every ``checkpoint_every`` steps. The duration of a step is the host's
    time for the call: with the port's train step, which does not wait for
    the card, that is the time to queue it."""

    def __init__(self, step_fn, save_fn, restore_fn, *,
                 checkpoint_every: int = 50,
                 mitigator: Optional[StragglerMitigator] = None):
        self.step_fn = step_fn
        self.save_fn = save_fn
        self.restore_fn = restore_fn
        self.checkpoint_every = checkpoint_every
        self.mitigator = mitigator or StragglerMitigator()
        self.log = RecoveryLog()
        self._failures: Dict[int, str] = {}

    def inject_failure(self, at_step: int, worker: str = "worker_7") -> None:
        self._failures[at_step] = worker

    def run(self, state, start_step: int, num_steps: int, batch_fn):
        step = start_step
        while step < start_step + num_steps:
            if step in self._failures:
                del self._failures[step]
                self.log.restarts += 1
                state, restored_step = self.restore_fn()
                step = restored_step
                continue
            t0 = time.perf_counter()
            state, metrics = self.step_fn(state, batch_fn(step))
            dur = time.perf_counter() - t0
            ev = self.mitigator.check(step, "worker_0", dur)
            if ev is not None:
                self.log.straggler_backups += 1
            step += 1
            if step % self.checkpoint_every == 0:
                self.save_fn(state, step)
        return state, step
