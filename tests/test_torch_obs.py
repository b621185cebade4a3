"""The port's observability (``repro_torch.obs``): the 13 cases of
``tests/test_obs.py`` on the port's copy — histogram accuracy, span nesting
and timing, the no-op backend, the JSONL sink, metric coherence under the
port's engine traffic, the forest's and journal's spans, and thread safety
under contention. Where a case yields numbers from fixed inputs (quantiles,
counts, sums, snapshots), the JAX package's ``repro.obs`` on the same inputs
must give the same numbers."""
import json
import random
import sys
import threading
import time

import pytest

from repro import obs as jax_obs
from repro_torch import obs
from repro_torch.obs import (JsonlSink, LatencyHistogram, MemorySink,
                             MetricsRegistry, Observability, percentiles,
                             read_trace)


@pytest.fixture(autouse=True)
def _tracing_off():
    """Every test starts and ends with both global tracers disabled."""
    obs.disable_tracing()
    jax_obs.disable_tracing()
    yield
    obs.disable_tracing()
    jax_obs.disable_tracing()


# ---------------------------------------------------------------------------
# histogram accuracy
# ---------------------------------------------------------------------------
def test_histogram_quantiles_match_exact_sort_within_bucket_error():
    rng = random.Random(17)
    h, jh = LatencyHistogram(), jax_obs.LatencyHistogram()
    samples = []
    for _ in range(20000):
        s = 10 ** rng.uniform(-6, 0)
        samples.append(s)
        h.record(s)
        jh.record(s)
    exact = percentiles(samples, (0.50, 0.90, 0.99))
    assert exact == jax_obs.percentiles(samples, (0.50, 0.90, 0.99))
    rel_tol = 2 * (LatencyHistogram.GROWTH ** 0.5 - 1)     # ≈5%
    for q, key in ((0.50, "p50"), (0.90, "p90"), (0.99, "p99")):
        got = h.quantile(q)
        assert abs(got - exact[key]) / exact[key] <= rel_tol
        assert got == jh.quantile(q)
    assert h.count == len(samples) and h.max == max(samples)
    assert abs(h.sum - sum(samples)) < 1e-6
    assert h.summary() == jh.summary()


def test_histogram_edge_cases():
    h = LatencyHistogram()
    assert h.quantile(0.5) == 0.0
    h.record(0.0)
    assert h.quantile(0.5) == LatencyHistogram.MIN / 2
    h2 = LatencyHistogram()
    h2.record(1e9)
    assert h2.quantile(0.99) > 0
    s = h2.summary()
    assert s["count"] == 1 and s["max_s"] == 1e9
    for a, b in ((h, jax_obs.LatencyHistogram()),
                 (h2, jax_obs.LatencyHistogram())):
        for v in ([0.0] if a is h else [1e9]):
            b.record(v)
        assert a.summary() == b.summary()
        assert a.quantile(0.99) == b.quantile(0.99)


def test_registry_get_or_create_and_snapshot():
    snaps = []
    for pkg in (obs, jax_obs):
        reg = pkg.MetricsRegistry()
        c = reg.counter("serve/x")
        assert reg.counter("serve/x") is c
        c.inc()
        c.inc(2)
        reg.gauge("serve/g").set(7)
        reg.histogram("span/phase").record(0.01)
        snap = reg.snapshot()
        assert snap["serve/x"] == 3 and snap["serve/g"] == 7
        assert snap["span/phase/count"] == 1
        assert "phase" in reg.latency_summary()
        snaps.append(snap)
    assert snaps[0] == snaps[1]


# ---------------------------------------------------------------------------
# spans: nesting, timing, sinks
# ---------------------------------------------------------------------------
def test_nested_span_timing_and_parenting():
    sink = MemorySink()
    obs.enable_tracing(sink)
    o = Observability()
    with o.span("outer", job="t"):
        time.sleep(0.02)
        with o.span("inner") as inner:
            time.sleep(0.01)
            inner.event("marker", k=1)
    obs.disable_tracing()

    spans = {r["name"]: r for r in sink.spans()}
    assert set(spans) == {"outer", "inner"}
    assert spans["inner"]["parent"] == spans["outer"]["span"]
    assert spans["outer"]["parent"] is None
    assert spans["inner"]["dur_s"] >= 0.01
    assert spans["outer"]["dur_s"] >= spans["inner"]["dur_s"] + 0.02 - 0.005
    assert spans["inner"]["ts"] >= spans["outer"]["ts"]
    assert spans["outer"]["attrs"] == {"job": "t"}
    (ev,) = sink.events("marker")
    assert ev["span"] == spans["inner"]["span"]
    assert o.registry.histogram("span/outer").count == 1
    assert o.registry.histogram("span/inner").count == 1


def test_jsonl_sink_round_trip(tmp_path):
    path = str(tmp_path / "trace.jsonl")
    sink = JsonlSink(path)
    obs.enable_tracing(sink)
    o = Observability()
    with o.span("a", n=1):
        o.event("ping")
    obs.disable_tracing()
    sink.close()

    recs = read_trace(path)
    assert [r["kind"] for r in recs] == ["event", "span"]
    assert [r["name"] for r in recs] == ["ping", "a"]
    assert recs[1]["attrs"] == {"n": 1}
    with open(path) as f:
        for line in f:
            json.loads(line)
    # the reference reads the port's trace the same way
    assert [(r["kind"], r["name"]) for r in jax_obs.read_trace(path)] == \
        [(r["kind"], r["name"]) for r in recs]


def test_noop_backend_is_shared_and_cheap():
    o = Observability()
    s1 = o.span("hot")
    s2 = o.span("hot2", attr=1)
    assert s1 is s2 is obs.NULL_SPAN
    with s1 as s:
        s.set(x=1).event("y")

    iters = 50_000
    t0 = time.perf_counter()
    for _ in range(iters):
        with o.span("hot"):
            pass
    per_call = (time.perf_counter() - t0) / iters
    assert per_call < 5e-6, f"disabled span cost {per_call * 1e6:.2f}µs"


def test_disabled_tracer_emits_nothing():
    sink = MemorySink()
    o = Observability()
    with o.span("quiet"):
        o.event("nope")
    assert sink.records == []
    assert o.registry.latency_summary() == {}


# ---------------------------------------------------------------------------
# metric coherence under mixed engine traffic
# ---------------------------------------------------------------------------
def test_engine_metrics_cohere_with_registry_under_mixed_traffic():
    """The port's engine on llama3's smoke config (float32) with a memory
    and a maintenance plane: the legacy metrics() dict and the registry are
    the same counters, and a traced run fills the per-phase histograms."""
    pytest.importorskip("torch")
    import numpy as np

    from repro_torch import MemForestConfig, MemForestSystem
    from repro_torch.configs import get_smoke_config
    from repro_torch.core.maintenance_plane import MaintenancePlane
    from repro_torch.data.synthetic import make_workload
    from repro_torch.models import get_model
    from repro_torch.serving.engine import ServeEngine

    wl = make_workload(num_entities=4, num_sessions=6,
                       transitions_per_entity=3, num_queries=8, seed=31)
    mf = MemForestSystem(MemForestConfig(), device="cpu")
    plane = MaintenancePlane(mf.forest, flush_trees_per_unit=2)
    cfg = get_smoke_config("llama3_8b").replace(dtype="float32",
                                                param_dtype="float32")
    model = get_model(cfg)
    eng = ServeEngine(model, model.init(0, device="cpu"), max_batch=2,
                      max_len=32, memory=mf, maintenance=plane,
                      maintenance_budget=2)

    sink = MemorySink()
    obs.enable_tracing(sink)
    rng = np.random.default_rng(3)
    for s in wl.sessions:
        eng.submit_session(s)
    eng.submit(list(rng.integers(3, 400, size=4)), max_new_tokens=3)
    eng.run_until_drained()
    rids = [eng.submit_query(q) for q in wl.queries]
    eng.run_until_drained()
    obs.disable_tracing()
    for r in rids:
        assert eng.pop_query_result(r) is not None

    m = eng.metrics()
    snap = eng.obs.registry.snapshot()
    for legacy, reg_name in (
            ("decode_steps", "serve/decode_steps"),
            ("decoded_tokens", "serve/decoded_tokens"),
            ("prefills", "serve/prefills"),
            ("ingest_batches", "serve/ingest_batches"),
            ("ingest_sessions", "serve/ingest_sessions"),
            ("query_batches", "serve/query_batches"),
            ("queries_served", "serve/queries_served"),
            ("maintenance_turns", "serve/maintenance_turns")):
        assert m[legacy] == snap[reg_name], (legacy, reg_name)
    assert eng.ingest_sessions == m["ingest_sessions"] == len(wl.sessions)
    assert eng.queries_served == len(wl.queries)
    assert m["maintenance_units"] == plane.units_run
    assert m["maintenance_pending"] == 0
    assert snap["serve/ingest_wait_s/count"] == len(wl.sessions)
    assert snap["serve/query_wait_s/count"] == len(wl.queries)
    assert m["query_wait_p99_s"] >= m["query_wait_p50_s"] >= 0

    phases = eng.latency_summary()
    for want in ("engine.step", "engine.admit", "engine.decode",
                 "engine.drain.ingest", "engine.drain.query",
                 "engine.drain.maintenance"):
        assert want in phases and phases[want]["count"] > 0, want
    assert "maintenance.flush_slice" in plane.obs.registry.latency_summary()
    step_spans = sink.spans("engine.step")
    assert len(step_spans) >= snap["serve/decode_steps"]
    step_ids = {r["span"] for r in step_spans}
    for r in sink.spans("engine.drain.ingest"):
        assert r["parent"] in step_ids


def test_forest_flush_and_journal_spans_share_system_registry(tmp_path):
    from repro_torch.core.journal import DurableMemForest
    from repro_torch.data.synthetic import make_workload

    sink = MemorySink()
    obs.enable_tracing(sink)
    store = DurableMemForest.open(str(tmp_path / "d"), device="cpu")
    wl = make_workload(num_entities=3, num_sessions=4,
                       transitions_per_entity=2, num_queries=2, seed=9)
    store.ingest_batch(wl.sessions, idempotency_key="k1")
    store.checkpoint()
    obs.disable_tracing()

    reg = store.obs.registry
    assert store.forest.obs is store.obs
    summ = reg.latency_summary()
    for want in ("journal.append", "journal.fsync", "journal.checkpoint",
                 "forest.flush"):
        assert want in summ, want
    assert reg.counter("journal/appends").value == store.writer.appends
    assert reg.counter("journal/commits").value == store.ops_applied
    assert reg.counter("journal/checkpoints").value == 1
    append_ids = {r["span"] for r in sink.spans("journal.append")}
    for r in sink.spans("journal.fsync"):
        assert r["parent"] in append_ids
    store.close()


# ---------------------------------------------------------------------------
# thread safety under the background maintenance plane
# ---------------------------------------------------------------------------
def test_counter_and_histogram_are_thread_safe_under_contention():
    reg = MetricsRegistry()
    c = reg.counter("stress/c")
    h = reg.histogram("stress/h")
    n_threads, n_iters = 8, 2000

    def worker(tid):
        for i in range(n_iters):
            c.inc()
            h.record(1e-4 * (1 + (i + tid) % 7))

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        ts = [threading.Thread(target=worker, args=(t,))
              for t in range(n_threads)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=120)
            assert not t.is_alive()
    finally:
        sys.setswitchinterval(old)

    assert c.value == n_threads * n_iters
    assert h.count == n_threads * n_iters
    assert h.summary()["count"] == n_threads * n_iters
    assert sum(h._b) == h.count
    # the same records, in one thread, in the reference's histogram
    jh = jax_obs.LatencyHistogram()
    for tid in range(n_threads):
        for i in range(n_iters):
            jh.record(1e-4 * (1 + (i + tid) % 7))
    assert h._b == jh._b and h.quantile(0.5) == jh.quantile(0.5)


def test_registry_get_or_create_race_yields_one_instance():
    reg = MetricsRegistry()
    got = []

    def worker():
        for i in range(300):
            got.append((i, reg.counter(f"race/c{i}")))
            reg.histogram(f"race/h{i}")
            reg.gauge(f"race/g{i}")

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        ts = [threading.Thread(target=worker) for _ in range(6)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=120)
            assert not t.is_alive()
    finally:
        sys.setswitchinterval(old)

    by_name = {}
    for i, cnt in got:
        by_name.setdefault(i, set()).add(id(cnt))
    assert all(len(ids) == 1 for ids in by_name.values())


def test_snapshot_during_concurrent_registration_never_raises():
    reg = MetricsRegistry()
    stop = threading.Event()
    errors = []

    def registrar():
        i = 0
        while not stop.is_set() and i < 20000:
            reg.counter(f"reg/c{i}").inc()
            reg.histogram(f"span/h{i % 32}").record(1e-3)
            reg.gauge(f"reg/g{i}").set(i)
            i += 1

    def snapshotter():
        try:
            for _ in range(150):
                reg.snapshot()
                reg.counters()
                reg.histograms()
                reg.latency_summary()
        except RuntimeError as e:          # pragma: no cover - the bug
            errors.append(e)

    reg_t = threading.Thread(target=registrar)
    snap_t = threading.Thread(target=snapshotter)
    reg_t.start()
    snap_t.start()
    snap_t.join(timeout=120)
    stop.set()
    reg_t.join(timeout=120)
    assert not reg_t.is_alive() and not snap_t.is_alive()
    assert not errors


def test_tracer_event_races_disable_without_crashing():
    from repro_torch.obs.trace import Tracer

    errors = []

    def hammer(tr):
        try:
            for _ in range(300):
                tr.event("e", {"k": 1})
        except AttributeError as e:        # pragma: no cover - the bug
            errors.append(e)

    for _ in range(30):
        tr = Tracer()
        tr.enable(MemorySink())
        t = threading.Thread(target=hammer, args=(tr,))
        t.start()
        tr.disable()
        t.join(timeout=60)
        assert not t.is_alive()
    assert not errors
