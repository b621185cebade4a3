"""Low-overhead observability for the serve loop.

One :class:`Observability` handle bundles a :class:`MetricsRegistry`
(counters / gauges / streaming-quantile latency histograms) with a span
tracer. Components (ServeEngine, Forest, MaintenancePlane,
ResidencyManager, DurableMemForest) each own a handle — their legacy
``metrics()`` dicts now read through the registry — and all handles share
the process-global tracer unless given a private one, so::

    from repro_torch import obs
    sink = obs.JsonlSink("trace.jsonl")
    obs.enable_tracing(sink)          # every span site in the process
    ... serve traffic ...
    obs.disable_tracing()             # flushes the sink
    sink.close()

Costs: registry counters are always on (a couple of attribute ops — they
ARE the metrics dicts). Span sites pay one boolean check + a shared no-op
singleton while tracing is disabled.
"""
from __future__ import annotations

from typing import Optional

from repro_torch.obs import trace as _trace
from repro_torch.obs.metrics import (Counter, Gauge, LatencyHistogram,
                               MetricsRegistry, percentiles)
from repro_torch.obs.trace import (GLOBAL, NULL_SPAN, JsonlSink, MemorySink, Span,
                             Tracer, read_trace)

__all__ = [
    "Observability", "MetricsRegistry", "Counter", "Gauge",
    "LatencyHistogram", "percentiles", "Tracer", "Span", "JsonlSink",
    "MemorySink", "NULL_SPAN", "enable_tracing", "disable_tracing",
    "tracing_enabled", "read_trace", "get_obs",
]


class Observability:
    """A component's handle: its metric registry + a tracer reference.

    ``tracer=None`` (the default) resolves to the process-global tracer at
    every call, so flipping :func:`enable_tracing` reaches components
    created long before it."""

    __slots__ = ("registry", "_tracer")

    def __init__(self, registry: Optional[MetricsRegistry] = None,
                 tracer: Optional[Tracer] = None):
        self.registry = registry if registry is not None else MetricsRegistry()
        self._tracer = tracer

    # -- tracing -----------------------------------------------------------
    @property
    def tracer(self) -> Tracer:
        return self._tracer if self._tracer is not None else _trace.GLOBAL

    @property
    def enabled(self) -> bool:
        """True when span tracing is live (metrics are always live)."""
        return (self._tracer or _trace.GLOBAL).enabled

    def span(self, name: str, **attrs):
        """Context-manager timer. While tracing is disabled this returns
        the shared no-op span — the only cost hot paths ever pay."""
        tr = self._tracer if self._tracer is not None else _trace.GLOBAL
        if not tr.enabled:
            return NULL_SPAN
        return Span(tr, name, self.registry, attrs or None)

    def event(self, name: str, **attrs) -> None:
        """Point event under the calling thread's current span."""
        tr = self._tracer if self._tracer is not None else _trace.GLOBAL
        if tr.enabled:
            tr.event(name, attrs or None)

    # -- metrics (registry delegates) --------------------------------------
    def counter(self, name: str) -> Counter:
        return self.registry.counter(name)

    def gauge(self, name: str) -> Gauge:
        return self.registry.gauge(name)

    def histogram(self, name: str) -> LatencyHistogram:
        return self.registry.histogram(name)


def get_obs(obs: Optional[Observability]) -> Observability:
    """``obs or Observability()`` with a stable spelling for components."""
    return obs if obs is not None else Observability()


def enable_tracing(sink=None) -> Tracer:
    """Turn on the process-global tracer (optionally with a sink — a
    :class:`JsonlSink`, :class:`MemorySink`, or anything with
    ``write(dict)``/``flush()``). Returns the tracer."""
    return _trace.GLOBAL.enable(sink)


def disable_tracing() -> None:
    """Turn span tracing back into the no-op backend (flushes the sink)."""
    _trace.GLOBAL.disable()


def tracing_enabled() -> bool:
    return _trace.GLOBAL.enabled
