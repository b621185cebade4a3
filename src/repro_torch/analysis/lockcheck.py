"""Dynamic lock-order checking for the port's serve stack (a copy of the JAX
package's ``analysis/lockcheck.py``).

The engine serve thread, the maintenance plane's background worker, and
the residency manager share two RLocks (``MaintenancePlane.lock``,
``ResidencyManager.lock``) plus small leaf locks inside the observability
layer. Nothing enforces an acquisition order — a refactor that makes the
residency manager call back into the plane while the plane's worker holds
its own lock and is evicting a tenant would deadlock only under loaded
concurrency, which tests rarely produce. This module makes the order an
asserted property instead:

  * :class:`CheckedLock` — a Lock/RLock wrapper that reports every
    acquire/release to a shared :class:`LockOrderGraph`.
  * :class:`LockOrderGraph` — records the union acquisition graph across
    threads (edge ``A -> B`` = some thread acquired B while holding A;
    re-entrant re-acquisition adds no edge) and finds cycles — the static
    precondition of an ABBA deadlock, detectable even when the schedule
    happened not to interleave fatally.
  * :class:`BlockingCallWatch` — patches known blocking calls
    (``os.fsync``, ``time.sleep``) to record when they run with
    instrumented locks held. fsync-under-lock is sometimes *required*
    (demotion must persist state before freeing the device cache), so the
    harness asserts the observed set against an explicit allowlist rather
    than forbidding it outright.
  * :func:`check_schedule` — replays a simulated acquisition schedule
    (no real locks, no real threads) through a fresh graph; this is what
    the property test drives with random planted-cycle schedules.
  * :func:`instrument` — swaps a component's ``lock`` attribute for a
    CheckedLock, so the pytest harness can wire the real engine/plane/
    residency stack into one graph without code changes.

Run via tests/test_torch_analysis.py: the port's engine traffic with its
background maintenance and residency eviction, then
``graph.assert_acyclic()``.
"""
from __future__ import annotations

import os
import threading
import time
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

__all__ = ["CheckedLock", "LockOrderGraph", "LockOrderViolation",
           "BlockingCallWatch", "check_schedule", "instrument"]


class LockOrderViolation(AssertionError):
    """Raised by :meth:`LockOrderGraph.assert_acyclic` with every cycle and
    the stack-free edge provenance (who acquired what while holding what)."""


class LockOrderGraph:
    """Union lock-acquisition graph across threads.

    ``thread=`` on the ``on_*`` hooks substitutes a simulated thread id so
    schedules can be replayed without real concurrency (property tests);
    real CheckedLocks pass the calling thread's ident implicitly.
    """

    def __init__(self) -> None:
        self._mu = threading.Lock()
        # (held, acquired) -> times observed
        self.edges: Dict[Tuple[str, str], int] = {}
        self._held: Dict[object, List[str]] = {}
        # (locks held at call time, blocking call name)
        self.blocking_calls: List[Tuple[Tuple[str, ...], str]] = []

    # -- hooks -------------------------------------------------------------
    def on_acquire(self, name: str, *, thread: object = None) -> None:
        t = thread if thread is not None else threading.get_ident()
        with self._mu:
            held = self._held.setdefault(t, [])
            if name not in held:            # re-entrant acquire: no new edge
                for h in dict.fromkeys(held):
                    self.edges[(h, name)] = self.edges.get((h, name), 0) + 1
            held.append(name)

    def on_release(self, name: str, *, thread: object = None) -> None:
        t = thread if thread is not None else threading.get_ident()
        with self._mu:
            held = self._held.get(t, [])
            for i in range(len(held) - 1, -1, -1):
                if held[i] == name:
                    del held[i]
                    break

    def held_by(self, thread: object = None) -> Tuple[str, ...]:
        t = thread if thread is not None else threading.get_ident()
        with self._mu:
            return tuple(dict.fromkeys(self._held.get(t, ())))

    def note_blocking(self, what: str) -> None:
        held = self.held_by()
        if held:
            with self._mu:
                self.blocking_calls.append((held, what))

    # -- analysis ----------------------------------------------------------
    def adjacency(self) -> Dict[str, List[str]]:
        adj: Dict[str, List[str]] = {}
        with self._mu:
            edges = list(self.edges)
        for a, b in edges:
            adj.setdefault(a, []).append(b)
            adj.setdefault(b, [])
        for k in adj:
            adj[k].sort()
        return adj

    def cycles(self) -> List[List[str]]:
        """Every elementary cycle reachable by DFS back edges (deterministic
        order). Empty list = a consistent global acquisition order exists."""
        adj = self.adjacency()
        WHITE, GRAY, BLACK = 0, 1, 2
        color = {n: WHITE for n in adj}
        out: List[List[str]] = []
        seen_keys = set()
        path: List[str] = []

        def visit(n: str) -> None:
            color[n] = GRAY
            path.append(n)
            for m in adj[n]:
                if color[m] == GRAY:
                    cyc = path[path.index(m):] + [m]
                    # canonicalize (rotation-invariant) to dedup
                    body = cyc[:-1]
                    i = body.index(min(body))
                    key = tuple(body[i:] + body[:i])
                    if key not in seen_keys:
                        seen_keys.add(key)
                        out.append(list(key) + [key[0]])
                elif color[m] == WHITE:
                    visit(m)
            path.pop()
            color[n] = BLACK

        for n in sorted(adj):
            if color[n] == WHITE:
                visit(n)
        return out

    def assert_acyclic(self) -> None:
        cyc = self.cycles()
        if cyc:
            lines = [" -> ".join(c) for c in cyc]
            raise LockOrderViolation(
                "lock-acquisition graph has cycle(s) — ABBA deadlock "
                "precondition:\n  " + "\n  ".join(lines))


class CheckedLock:
    """Drop-in Lock/RLock replacement that reports to a LockOrderGraph."""

    def __init__(self, name: str, graph: LockOrderGraph, *,
                 reentrant: bool = True):
        self.name = name
        self.graph = graph
        self._inner = threading.RLock() if reentrant else threading.Lock()

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        ok = self._inner.acquire(blocking, timeout)
        if ok:
            self.graph.on_acquire(self.name)
        return ok

    def release(self) -> None:
        # pop from the held stack BEFORE the real release, so another
        # thread's immediate acquire never sees us as still holding it
        self.graph.on_release(self.name)
        self._inner.release()

    def __enter__(self) -> "CheckedLock":
        self.acquire()
        return self

    def __exit__(self, *exc) -> bool:
        self.release()
        return False


class BlockingCallWatch:
    """Patch known blocking calls to record lock-held invocations.

    ``os.fsync`` and ``time.sleep`` are the two the serve stack actually
    makes; extend ``targets`` for others. Restores the originals on exit.
    """

    DEFAULT_TARGETS: Sequence[Tuple[object, str]] = (
        (os, "fsync"), (time, "sleep"))

    def __init__(self, graph: LockOrderGraph,
                 targets: Optional[Sequence[Tuple[object, str]]] = None):
        self.graph = graph
        self.targets = list(targets or self.DEFAULT_TARGETS)
        self._saved: List[Tuple[object, str, object]] = []

    def __enter__(self) -> "BlockingCallWatch":
        for mod, fname in self.targets:
            orig = getattr(mod, fname)
            self._saved.append((mod, fname, orig))

            def make(orig=orig, label=f"{mod.__name__}.{fname}"):
                def wrapper(*a, **k):
                    self.graph.note_blocking(label)
                    return orig(*a, **k)
                return wrapper

            setattr(mod, fname, make())
        return self

    def __exit__(self, *exc) -> bool:
        for mod, fname, orig in self._saved:
            setattr(mod, fname, orig)
        self._saved.clear()
        return False


def check_schedule(events: Iterable[Tuple[object, str, str]]
                   ) -> List[List[str]]:
    """Replay a simulated schedule of ``(thread_id, "acquire"|"release",
    lock_name)`` events through a fresh graph; returns its cycles. No real
    locks are taken, so a schedule whose interleaving WOULD deadlock is
    still fully analyzable."""
    g = LockOrderGraph()
    for thread_id, op, name in events:
        if op == "acquire":
            g.on_acquire(name, thread=thread_id)
        elif op == "release":
            g.on_release(name, thread=thread_id)
        else:
            raise ValueError(f"unknown schedule op {op!r}")
    return g.cycles()


def instrument(obj: object, graph: LockOrderGraph, name: str,
               attr: str = "lock", *, reentrant: bool = True) -> CheckedLock:
    """Replace ``obj.<attr>`` (an existing Lock/RLock) with a CheckedLock
    wired to ``graph``. Returns the wrapper."""
    if not hasattr(obj, attr):
        raise AttributeError(f"{obj!r} has no lock attribute {attr!r}")
    lock = CheckedLock(name, graph, reentrant=reentrant)
    setattr(obj, attr, lock)
    return lock
