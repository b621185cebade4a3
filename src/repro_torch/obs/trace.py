"""Span tracing: context-manager timers with nesting, attributes, point
events, a JSONL sink, and a no-op backend that hot paths can afford.

A :class:`Tracer` owns the enabled flag, the (optional) sink, and a
thread-local span stack; the module-global :data:`GLOBAL` tracer is what
every component uses unless explicitly handed another one, so
``obs.enable_tracing()`` lights up the whole process — serve engine,
forest flush, journal, residency — in one call.

Disabled cost: ``Observability.span()`` (repro/obs/__init__.py) checks one
boolean and returns the shared :data:`NULL_SPAN` singleton — no
allocation, no clock read, no stack push. The mixed serving benchmark
measures this and asserts the instrumentation tax on the ingest/query
benches stays ≤2% when tracing is off.

Enabled cost per span: two ``perf_counter`` reads, a stack push/pop, one
histogram record (into the owning component's registry, name
``span/<name>``), and — only when a sink is attached — one JSONL line.

Trace format (one JSON object per line)::

    {"kind": "span",  "name": "engine.decode", "span": 7, "parent": 5,
     "ts": 0.01324, "dur_s": 0.00211, "attrs": {...}}
    {"kind": "event", "name": "durability/journal:append", "span": 7,
     "ts": 0.01388, "attrs": {...}}

``ts`` is seconds since the tracer was enabled (monotonic clock), so
records from one process order and nest exactly; a span line is written
when the span *closes*, so child spans and interior events appear before
their parent — reconstruct the tree via ``span``/``parent`` ids, order by
``ts``.
"""
from __future__ import annotations

import json
import threading
from time import perf_counter
from typing import Any, Dict, List, Optional


class _NullSpan:
    """The no-op backend: a single shared instance stands in for every span
    while tracing is disabled."""

    __slots__ = ()

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, *exc) -> bool:
        return False

    def set(self, **attrs) -> "_NullSpan":
        return self

    def event(self, name: str, **attrs) -> "_NullSpan":
        return self


NULL_SPAN = _NullSpan()


class JsonlSink:
    """Append trace records to a JSONL file. Buffered; ``close()`` (or the
    context manager) flushes."""

    def __init__(self, path: str):
        self.path = path
        self._f = open(path, "w")
        self.records_written = 0

    def write(self, rec: Dict[str, Any]) -> None:
        self._f.write(json.dumps(rec) + "\n")
        self.records_written += 1

    def flush(self) -> None:
        self._f.flush()

    def close(self) -> None:
        if not self._f.closed:
            self._f.close()

    def __enter__(self) -> "JsonlSink":
        return self

    def __exit__(self, *exc) -> bool:
        self.close()
        return False


class MemorySink:
    """In-memory sink (tests, benchmarks): records land in ``records``."""

    def __init__(self) -> None:
        self.records: List[Dict[str, Any]] = []

    def write(self, rec: Dict[str, Any]) -> None:
        self.records.append(rec)

    def flush(self) -> None:
        pass

    def close(self) -> None:
        pass

    def spans(self, name: Optional[str] = None) -> List[Dict[str, Any]]:
        return [r for r in self.records if r["kind"] == "span"
                and (name is None or r["name"] == name)]

    def events(self, prefix: str = "") -> List[Dict[str, Any]]:
        return [r for r in self.records if r["kind"] == "event"
                and r["name"].startswith(prefix)]


class Span:
    """One timed, attributed, nestable region. Use via
    ``Observability.span(name, **attrs)`` as a context manager; on exit the
    duration is recorded into the owning registry's ``span/<name>``
    histogram and (if a sink is attached) a JSONL line is emitted."""

    __slots__ = ("tracer", "registry", "name", "attrs", "span_id",
                 "parent_id", "t_start", "dur_s")

    def __init__(self, tracer: "Tracer", name: str, registry, attrs):
        self.tracer = tracer
        self.registry = registry
        self.name = name
        self.attrs = attrs
        self.span_id = 0
        self.parent_id: Optional[int] = None
        self.t_start = 0.0
        self.dur_s = 0.0

    def set(self, **attrs) -> "Span":
        """Attach/overwrite attributes after the span opened (e.g. counts
        known only at the end of the region)."""
        if self.attrs is None:
            self.attrs = attrs
        else:
            self.attrs.update(attrs)
        return self

    def event(self, name: str, **attrs) -> "Span":
        """Point event stamped inside this span."""
        self.tracer._emit_event(name, self.span_id, attrs)
        return self

    def __enter__(self) -> "Span":
        tr = self.tracer
        self.span_id = tr._next_id()
        stack = tr._stack()
        self.parent_id = stack[-1].span_id if stack else None
        stack.append(self)
        self.t_start = perf_counter() - tr.t0
        return self

    def __exit__(self, *exc) -> bool:
        self.dur_s = perf_counter() - self.tracer.t0 - self.t_start
        stack = self.tracer._stack()
        if stack and stack[-1] is self:
            stack.pop()
        elif self in stack:                     # tolerate exotic unwinds
            stack.remove(self)
        if self.registry is not None:
            self.registry.histogram("span/" + self.name).record(self.dur_s)
        sink = self.tracer.sink
        if sink is not None:
            sink.write({"kind": "span", "name": self.name,
                        "span": self.span_id, "parent": self.parent_id,
                        "ts": self.t_start, "dur_s": self.dur_s,
                        "attrs": self.attrs or {}})
        return False


class Tracer:
    """Enabled flag + sink + id allocator + per-thread span stack."""

    def __init__(self, sink=None, enabled: bool = False):
        self.enabled = enabled
        self.sink = sink
        self.t0 = perf_counter()
        self._id = 0
        self._id_lock = threading.Lock()
        self._tls = threading.local()

    # -- plumbing ----------------------------------------------------------
    def _next_id(self) -> int:
        with self._id_lock:
            self._id += 1
            return self._id

    def _stack(self) -> List[Span]:
        s = getattr(self._tls, "stack", None)
        if s is None:
            s = self._tls.stack = []
        return s

    def current_span(self) -> Optional[Span]:
        s = self._stack()
        return s[-1] if s else None

    # -- record construction ----------------------------------------------
    def span(self, name: str, registry=None, attrs=None):
        """Start (unentered) a span; returns NULL_SPAN while disabled."""
        if not self.enabled:
            return NULL_SPAN
        return Span(self, name, registry, attrs)

    def event(self, name: str, attrs=None) -> None:
        """Point event attached to the calling thread's current span."""
        if not self.enabled:
            return
        cur = self.current_span()
        self._emit_event(name, cur.span_id if cur else None, attrs)

    def _emit_event(self, name: str, span_id, attrs) -> None:
        # capture: disable() on another thread nulls self.sink between the
        # check and the write otherwise
        sink = self.sink
        if sink is not None:
            sink.write({"kind": "event", "name": name, "span": span_id,
                        "ts": perf_counter() - self.t0,
                        "attrs": attrs or {}})

    # -- switches ----------------------------------------------------------
    def enable(self, sink=None) -> "Tracer":
        self.sink = sink
        self.t0 = perf_counter()
        self._id = 0
        self.enabled = True
        return self

    def disable(self) -> None:
        self.enabled = False
        sink, self.sink = self.sink, None
        if sink is not None:
            sink.flush()


#: process-wide default tracer — components fall back to this one, so
#: ``repro_torch.obs.enable_tracing()`` turns on every span site at once
GLOBAL = Tracer()


def read_trace(path: str) -> List[Dict[str, Any]]:
    """Parse a JSONL trace file back into records (helper for tests and
    offline analysis)."""
    out = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                out.append(json.loads(line))
    return out
