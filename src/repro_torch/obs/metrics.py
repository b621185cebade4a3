"""Metric primitives: counters, gauges, and streaming-quantile latency
histograms behind one :class:`MetricsRegistry`.

Design constraints:

  * **always-on and cheap** — counters back the legacy ``metrics()`` dicts
    of the serve engine / maintenance plane / residency manager, so an
    increment must cost a couple of attribute ops, nothing more;
  * **streaming quantiles** — latency distributions are recorded into
    log-spaced buckets (HDR-histogram style): fixed memory, O(1) record,
    bounded *relative* error on any quantile (half a bucket width,
    ``GROWTH**0.5 - 1`` ≈ 2.5%), which is what p50/p99 tuning needs;
  * **no hard dependencies** — pure Python + ``math``, importable before
    torch/numpy land.

Naming scheme: metric names are
``<component>/<what>`` — ``serve/ingest_sessions``,
``maintenance/units_run``, ``residency/evictions``, ``journal/appends`` —
and span-duration histograms are ``span/<span name>``
(``span/engine.decode``, ``span/forest.flush``, ...), all in seconds.
"""
from __future__ import annotations

import math
import threading
from typing import Dict, List, Optional, Sequence


class Counter:
    """Monotonic (float-friendly) counter. ``value`` is the read API.

    ``inc`` takes a per-instance lock: ``self.value += n`` is a read-
    modify-write that the GIL does NOT make atomic (the interpreter can
    switch threads between the load and the store), and counters are
    incremented from the serve thread and the maintenance worker at once.
    """

    __slots__ = ("value", "_lock")

    def __init__(self) -> None:
        self.value = 0
        self._lock = threading.Lock()

    def inc(self, n=1) -> None:
        with self._lock:
            self.value += n

    def set(self, v) -> None:
        self.value = v


class Gauge:
    """Last-write-wins instantaneous value."""

    __slots__ = ("value",)

    def __init__(self) -> None:
        self.value = 0

    def set(self, v) -> None:
        self.value = v


class LatencyHistogram:
    """Streaming latency distribution with log-spaced buckets.

    Bucket ``i`` covers ``[MIN * GROWTH**(i-1), MIN * GROWTH**i)`` (bucket 0
    holds everything below ``MIN``); a quantile is reported as the geometric
    midpoint of its bucket, so the relative error of any reported quantile
    is at most ``GROWTH**0.5 - 1`` (≈2.5% at the default 5% growth) —
    verified against exact sorting in tests/test_obs.py.
    """

    MIN = 1e-7                      # 0.1 µs — everything below lands in bucket 0
    GROWTH = 1.05
    _BUCKETS = 1 + int(math.log(1e4 / MIN) / math.log(GROWTH)) + 1   # ..1e4 s

    __slots__ = ("count", "sum", "max", "_b", "_inv_log_growth", "_lock")

    def __init__(self) -> None:
        self.count = 0
        self.sum = 0.0
        self.max = 0.0
        self._b: List[int] = [0] * self._BUCKETS
        self._inv_log_growth = 1.0 / math.log(self.GROWTH)
        # record() updates four fields; without the lock a thread switch
        # mid-update loses counts or leaves count/sum inconsistent
        self._lock = threading.Lock()

    def record(self, seconds: float) -> None:
        if seconds < self.MIN:
            idx = 0
        else:
            idx = 1 + int(math.log(seconds / self.MIN) * self._inv_log_growth)
            if idx >= len(self._b):
                idx = len(self._b) - 1
        with self._lock:
            self.count += 1
            self.sum += seconds
            if seconds > self.max:
                self.max = seconds
            self._b[idx] += 1

    def quantile(self, q: float) -> float:
        """Approximate q-quantile (q in [0, 1]) in seconds; 0.0 when empty."""
        if self.count == 0:
            return 0.0
        rank = max(1, math.ceil(q * self.count))
        seen = 0
        for i, c in enumerate(self._b):
            seen += c
            if seen >= rank:
                if i == 0:
                    return self.MIN / 2
                # geometric midpoint of [MIN*G**(i-1), MIN*G**i)
                return self.MIN * self.GROWTH ** (i - 0.5)
        return self.max

    @property
    def mean(self) -> float:
        return self.sum / self.count if self.count else 0.0

    def summary(self) -> Dict[str, float]:
        return {
            "count": self.count,
            "sum_s": self.sum,
            "mean_s": self.mean,
            "p50_s": self.quantile(0.50),
            "p90_s": self.quantile(0.90),
            "p99_s": self.quantile(0.99),
            "max_s": self.max,
        }


class MetricsRegistry:
    """Get-or-create registry of named counters / gauges / histograms.

    Creation takes a lock (components register from serve + maintenance
    threads); the returned objects are then held by the caller and updated
    lock-free — single attribute ops under the GIL, and every current
    writer already runs under its component's own lock where it matters.
    """

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._counters: Dict[str, Counter] = {}
        self._gauges: Dict[str, Gauge] = {}
        self._hists: Dict[str, LatencyHistogram] = {}

    def counter(self, name: str) -> Counter:
        c = self._counters.get(name)
        if c is None:
            with self._lock:
                c = self._counters.setdefault(name, Counter())
        return c

    def gauge(self, name: str) -> Gauge:
        g = self._gauges.get(name)
        if g is None:
            with self._lock:
                g = self._gauges.setdefault(name, Gauge())
        return g

    def histogram(self, name: str) -> LatencyHistogram:
        h = self._hists.get(name)
        if h is None:
            with self._lock:
                h = self._hists.setdefault(name, LatencyHistogram())
        return h

    # ------------------------------------------------------------------
    # Read methods copy the name->object dicts under the registration lock
    # before iterating: the maintenance worker registers metrics lazily, so
    # a lock-free iteration from the serve thread can hit "dict changed
    # size during iteration" mid-snapshot.
    def counters(self) -> Dict[str, float]:
        with self._lock:
            items = sorted(self._counters.items())
        return {k: c.value for k, c in items}

    def histograms(self) -> Dict[str, LatencyHistogram]:
        with self._lock:
            return dict(self._hists)

    def snapshot(self) -> Dict[str, float]:
        """One flat dict of everything: counters and gauges by name,
        histograms expanded to ``<name>/{count,mean_s,p50_s,p90_s,p99_s}``."""
        with self._lock:
            gauges = sorted(self._gauges.items())
            hists = sorted(self._hists.items())
        out: Dict[str, float] = {}
        out.update(self.counters())
        for k, g in gauges:
            out[k] = g.value
        for k, h in hists:
            for stat, v in h.summary().items():
                out[f"{k}/{stat}"] = v
        return out

    def latency_summary(self, prefix: str = "span/") -> Dict[str, Dict[str, float]]:
        """Per-histogram summaries for names under ``prefix`` (default: the
        span-duration histograms) — the per-phase p50/p99 table the mixed
        serving benchmark emits."""
        with self._lock:
            hists = sorted(self._hists.items())
        return {k[len(prefix):]: h.summary()
                for k, h in hists if k.startswith(prefix) and h.count}


def percentiles(samples: Sequence[float],
                qs: Sequence[float] = (0.50, 0.90, 0.99)) -> Dict[str, float]:
    """Exact percentiles of a finite sample (nearest-rank with linear
    interpolation) — the reference the histogram accuracy test compares
    against."""
    if not samples:
        return {f"p{int(q * 100)}": 0.0 for q in qs}
    s = sorted(samples)
    out = {}
    for q in qs:
        pos = q * (len(s) - 1)
        lo = int(pos)
        hi = min(lo + 1, len(s) - 1)
        out[f"p{int(q * 100)}"] = s[lo] + (s[hi] - s[lo]) * (pos - lo)
    return out
