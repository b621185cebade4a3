"""Crash injection for the durable write path.

A copy of ``SimulatedCrash`` and ``CrashInjector`` from the JAX package's
``runtime/fault_tolerance.py``; the rest of that module (stragglers,
elastic re-meshing, the restarting runner) comes with training (ROADMAP.md,
queue 1, item 7).
"""
from __future__ import annotations

from typing import List, Optional


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
