"""The port's ``ServeEngine`` against the JAX package's, on the CPU.

Both engines serve the llama3-8b smoke config in float32 with the same
weights (the JAX init, carried across with ``transformer_params_from_numpy``)
over the scenarios of tests/test_pipeline_serving.py: draining and batching,
continuous batching that keeps active decodes intact, prefix-cache reuse,
the ingest and query lanes, and ``BatchedEncoderServer`` accounting.
Decoded tokens, the ``metrics()`` counters and query results must be equal.

Two traps of the port are covered: the live KV cache is written in place,
so a prefix hit after decode steps must still replay the stored prefill;
and a request that runs past ``max_len`` must clamp its KV write as the
reference's ``dynamic_update_slice`` does.

Last, a check memlint cannot make in the port: no host sync in the engine's
phase methods but the one greedy-sampling read per step.
"""
import ast
import os

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.config import MemForestConfig as JaxMemForestConfig
from repro.configs import get_smoke_config as jax_smoke_config
from repro.core.encoder import HashingEncoder as JaxHashingEncoder
from repro.core.encoder import ModelEncoder as JaxModelEncoder
from repro.core.memforest import MemForestSystem as JaxSystem
from repro.data.synthetic import make_workload
from repro.data.tokenizer import HashTokenizer as JaxTokenizer
from repro.models import get_model as jax_get_model
from repro.serving.engine import BatchedEncoderServer as JaxEncoderServer
from repro.serving.engine import ServeEngine as JaxEngine
from repro_torch import MemForestConfig, MemForestSystem
from repro_torch.configs import get_smoke_config
from repro_torch.convert import transformer_params_from_numpy
from repro_torch.core.encoder import HashingEncoder, ModelEncoder
from repro_torch.data.synthetic import make_workload as torch_make_workload
from repro_torch.data.tokenizer import HashTokenizer
from repro_torch.models import get_model
from repro_torch.serving import engine as engine_mod
from repro_torch.serving.engine import BatchedEncoderServer, ServeEngine

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
COUNTERS = ("decode_steps", "decoded_tokens", "mean_occupancy", "prefix_hits",
            "prefix_misses", "prefills", "prefills_reused", "ingest_batches",
            "ingest_sessions", "mean_ingest_batch", "query_batches",
            "queries_served", "mean_query_batch")


@pytest.fixture(scope="module")
def models():
    jc = jax_smoke_config("llama3_8b").replace(dtype="float32",
                                               param_dtype="float32")
    tc = get_smoke_config("llama3_8b").replace(dtype="float32",
                                               param_dtype="float32")
    jm, tm = jax_get_model(jc), get_model(tc)
    jp = jm.init(jax.random.key(0))
    tp = transformer_params_from_numpy(jax.tree.map(np.asarray, jp), tc,
                                       device="cpu")
    return (jm, jp), (tm, tp)


def _engines(models, **kw):
    (jm, jp), (tm, tp) = models
    jmem, tmem = kw.pop("memory", (None, None))
    return (JaxEngine(jm, jp, memory=jmem, **kw),
            ServeEngine(tm, tp, memory=tmem, **kw))


def _outputs(done):
    return sorted((r.req_id, r.prompt_tokens, r.out_tokens) for r in done)


def _same_counters(je, te):
    jm, tm = je.metrics(), te.metrics()
    assert set(tm) <= set(jm)
    assert {k: tm[k] for k in COUNTERS} == {k: jm[k] for k in COUNTERS}
    return tm


def _submit_both(engines, *args, **kw):
    return [e.submit(*args, **kw) for e in engines]


def test_drains_and_batches(models):
    je, te = _engines(models, max_batch=4, max_len=64)
    rng = np.random.default_rng(0)
    for i in range(7):
        prompt = [int(t) for t in rng.integers(3, 400, size=4 + i % 3)]
        _submit_both((je, te), prompt, max_new_tokens=3)
    jd, td = je.run_until_drained(), te.run_until_drained()
    assert len(td) == 7
    assert _outputs(td) == _outputs(jd)
    m = _same_counters(je, te)
    assert m["mean_occupancy"] > 0.5
    assert te.steps == je.steps and te.decoded_tokens == je.decoded_tokens


def test_continuous_batching_preserves_active_decodes(models):
    prompt = [5, 6, 7, 8]
    je1, te1 = _engines(models, max_batch=2, max_len=32)
    _submit_both((je1, te1), prompt, max_new_tokens=6)
    solo = te1.run_until_drained()[0].out_tokens
    assert solo == je1.run_until_drained()[0].out_tokens

    je2, te2 = _engines(models, max_batch=2, max_len=32)
    _submit_both((je2, te2), prompt, max_new_tokens=6)
    je2.step()
    te2.step()                              # request 0 is decoding
    _submit_both((je2, te2), [9, 10, 11], max_new_tokens=3)
    jd, td = je2.run_until_drained(), te2.run_until_drained()
    mixed = next(r.out_tokens for r in td if r.prompt_tokens == prompt)
    assert mixed == solo
    assert _outputs(td) == _outputs(jd)
    _same_counters(je2, te2)


def test_prefix_cache_reuses_prefill(models):
    """The second admission of the same prefix-keyed block hits the cache
    after the first one has run its decode steps in place."""
    je, te = _engines(models, max_batch=2, max_len=32)
    prompts = [[5, 6, 7, 8], [5, 6, 7, 9]]
    for p in prompts:
        _submit_both((je, te), p, max_new_tokens=4, prefix_key="extract")
    out1 = sorted((r.prompt_tokens[-1], r.out_tokens)
                  for r in te.run_until_drained())
    je.run_until_drained()
    assert te.metrics()["prefix_misses"] >= 1 and te.prefix_cache.hits == 0
    # the stored prefill is the one computed, untouched by the decode steps
    (logits, stored), = te.prefix_cache.entries.values()
    fresh_logits, fresh = te.model.prefill(
        te.params, {"tokens": torch.tensor([[5, 6, 7, 8], [5, 6, 7, 9]])}, 32)
    assert torch.equal(logits, fresh_logits)
    for k in ("k", "v", "lengths"):
        assert torch.equal(stored[k], fresh[k]), k
    assert stored["k"].data_ptr() != te.cache["k"].data_ptr()

    for e in (je, te):
        e.finished.clear()
    for p in prompts:
        _submit_both((je, te), p, max_new_tokens=4, prefix_key="extract")
    out2 = sorted((r.prompt_tokens[-1], r.out_tokens)
                  for r in te.run_until_drained())
    jout2 = sorted((r.prompt_tokens[-1], r.out_tokens)
                   for r in je.run_until_drained())
    m = _same_counters(je, te)
    assert m["prefix_hits"] >= 1 and m["prefills_reused"] >= 1
    assert out1 == out2 == jout2


def test_prefix_hit_while_another_request_decodes(models):
    """A hit that lands in a freed slot while the other slot is mid-decode:
    the merge copies the stored rows, the running decode is untouched."""
    je, te = _engines(models, max_batch=2, max_len=40)
    for e in (je, te):
        e.submit([5, 6, 7, 8], max_new_tokens=2, prefix_key="p")
        e.submit([11, 12, 13], max_new_tokens=9)
        e.step()
        e.step()
        e.submit([5, 6, 7, 8], max_new_tokens=2, prefix_key="p")
        e.step()                            # slot 0 freed, then re-admitted
        e.submit([5, 6, 7, 8], max_new_tokens=3, prefix_key="p")
    jd, td = je.run_until_drained(), te.run_until_drained()
    assert _outputs(td) == _outputs(jd)
    assert _same_counters(je, te)["prefix_hits"] >= 1


def test_request_past_max_len_clamps_like_the_reference(models):
    je, te = _engines(models, max_batch=2, max_len=16)
    _submit_both((je, te), [7, 8, 9, 10, 11, 12, 13, 14, 15, 16],
                 max_new_tokens=12)
    _submit_both((je, te), [3, 4, 5], max_new_tokens=15)
    jd, td = je.run_until_drained(), te.run_until_drained()
    assert all(len(r.out_tokens) in (12, 15) for r in td)
    assert _outputs(td) == _outputs(jd)
    assert int(te.cache["lengths"].max()) > 16
    _same_counters(je, te)


def _hashing_systems(seed, sessions=6, queries=10):
    kw = dict(num_entities=4, num_sessions=sessions, transitions_per_entity=3,
              num_queries=queries, seed=seed)
    return (make_workload(**kw), torch_make_workload(**kw),
            JaxSystem(JaxMemForestConfig()), MemForestSystem(device="cpu"))


def test_query_lane_drains_batched(models):
    wl_j, wl_t, jmf, tmf = _hashing_systems(21)
    for s in wl_j.sessions:
        jmf.ingest_session(s)
    for s in wl_t.sessions:
        tmf.ingest_session(s)
    je, te = _engines(models, max_batch=2, max_len=32, memory=(jmf, tmf))
    jr = [je.submit_query(q) for q in wl_j.queries]
    tr = [te.submit_query(q) for q in wl_t.queries]
    _submit_both((je, te), [5, 6, 7], max_new_tokens=2)
    je.run_until_drained()
    te.run_until_drained()
    m = _same_counters(je, te)
    assert m["queries_served"] == len(wl_t.queries) and m["query_batches"] == 1
    got = [(r.answer, r.evidence) for r in map(te.pop_query_result, tr)]
    want = [(r.answer, r.evidence) for r in map(je.pop_query_result, jr)]
    assert got == want
    assert not te.query_results


def test_ingest_lane_batches_sessions(models):
    wl_j, wl_t, jmf, tmf = _hashing_systems(4, sessions=9)
    je, te = _engines(models, max_batch=2, max_len=32, memory=(jmf, tmf),
                      max_ingest_batch=4)
    for s in wl_j.sessions:
        je.submit_session(s)
    for s in wl_t.sessions:
        te.submit_session(s)
    _submit_both((je, te), [5, 6, 7], max_new_tokens=2)
    je.run_until_drained()
    te.run_until_drained()
    m = _same_counters(je, te)
    assert m["ingest_sessions"] == 9 and m["ingest_batches"] == 3
    assert [f.text for f in tmf.forest.facts] == [f.text for f in jmf.forest.facts]
    assert tmf.scale_stats() == jmf.scale_stats()
    assert te.metrics()["ingest_wait_p50_s"] >= 0.0


def test_lanes_require_memory(models):
    _, te = _engines(models, max_batch=2, max_len=32)
    with pytest.raises(RuntimeError):
        te.submit_query(object())
    with pytest.raises(RuntimeError):
        te.submit_session(object())


def test_batched_encoder_server_prefix_accounting():
    jsrv = JaxEncoderServer(JaxHashingEncoder(dim=64))
    enc = HashingEncoder(dim=64, device="cpu")
    srv = BatchedEncoderServer(enc)
    chunks = ["chunk one text", "chunk two text", "chunk three"]
    out = srv.encode_chunks(chunks)
    np.testing.assert_allclose(out, np.asarray(jsrv.encode_chunks(chunks)),
                               atol=1e-5)
    assert out.shape == (3, 64)
    assert srv.prefix_tokens_saved == jsrv.prefix_tokens_saved > 0
    assert enc.stats.calls == 1
    assert srv.encode_chunks([]).shape == (0, 64)


def test_serve_memforest_deployment(models):
    """The deployment of examples/serve_memforest.py at smoke size: one
    model decodes and, as a ModelEncoder on the same weights, embeds the
    ingest and query lanes' texts. Decoded tokens, counters, facts and
    answers equal; the engine's spans are recorded."""
    from repro_torch.obs import MemorySink, Observability, Tracer

    (jm, jp), (tm, tp) = models
    jc, tc = jm.cfg, tm.cfg
    kw = dict(num_entities=4, num_sessions=6, transitions_per_entity=3,
              num_queries=8, seed=0)
    wl_j, wl_t = make_workload(**kw), torch_make_workload(**kw)
    jtok, ttok = JaxTokenizer(jc.vocab_size), HashTokenizer(tc.vocab_size)
    jmf = JaxSystem(JaxMemForestConfig(embed_dim=jc.d_model),
                    JaxModelEncoder(jc, jp, jtok, max_len=32))
    tmf = MemForestSystem(MemForestConfig(embed_dim=tc.d_model),
                          ModelEncoder(tc, tp, ttok, max_len=32), device="cpu")
    sink = MemorySink()
    je = JaxEngine(jm, jp, max_batch=4, max_len=64, memory=jmf,
                   max_ingest_batch=4)
    te = ServeEngine(tm, tp, max_batch=4, max_len=64, memory=tmf,
                     max_ingest_batch=4,
                     obs=Observability(tracer=Tracer(sink=sink, enabled=True)))
    for e, wl, tok in ((je, wl_j, jtok), (te, wl_t, ttok)):
        for s in wl.sessions:
            e.submit_session(s)
        for s in wl.sessions[:3]:
            e.submit(tok.encode(s.turns[0].text)[:12], max_new_tokens=4,
                     prefix_key="summarize")
        e.run_until_drained()
        e.rids = [e.submit_query(q) for q in wl.queries]
        for s in wl.sessions[:3]:            # the same block: a prefix hit
            e.submit(tok.encode(s.turns[0].text)[:12], max_new_tokens=4,
                     prefix_key="summarize")
        e.run_until_drained()
    assert _outputs(te.finished) == _outputs(je.finished)
    m = _same_counters(je, te)
    assert m["prefills_reused"] >= 1 and m["queries_served"] == 8
    assert [f.text for f in tmf.forest.facts] == [f.text for f in jmf.forest.facts]
    got = [(r.answer, r.evidence) for r in map(te.pop_query_result, te.rids)]
    want = [(r.answer, r.evidence) for r in map(je.pop_query_result, je.rids)]
    assert got == want
    names = {rec["name"] for rec in sink.spans()}
    assert {"engine.step", "engine.admit", "engine.prefill", "engine.decode",
            "engine.drain.ingest", "engine.drain.query"} <= names
    assert te.latency_summary()["engine.decode"]["count"] == te.steps


# ---------------------------------------------------------------------------
# host syncs in the engine's phase methods
# ---------------------------------------------------------------------------
PHASES = ("step", "_admit", "_drain_ingest", "_drain_queries")
SYNC_ATTRS = ("cpu", "item", "tolist", "numpy")


def _syncs(tree):
    """(method, line, call) for every host-syncing call in a phase method
    of the class ServeEngine."""
    cls = next(n for n in ast.walk(tree)
               if isinstance(n, ast.ClassDef) and n.name == "ServeEngine")
    found = []
    for fn in cls.body:
        if not isinstance(fn, ast.FunctionDef) or fn.name not in PHASES:
            continue
        for call in ast.walk(fn):
            if not isinstance(call, ast.Call) or \
                    not isinstance(call.func, ast.Attribute):
                continue
            f = call.func
            if f.attr in SYNC_ATTRS:
                found.append((fn.name, call.lineno, f".{f.attr}()"))
            elif f.attr == "asarray" and isinstance(f.value, ast.Name) \
                    and f.value.id in ("np", "numpy"):
                found.append((fn.name, call.lineno, "np.asarray()"))
    return found


def test_engine_phases_sync_once_per_step():
    """The only host sync in the phase methods is the greedy-sampling read
    of the token ids, once per step, with a justified suppression."""
    path = engine_mod.__file__
    with open(path) as fh:
        src = fh.read()
    found = _syncs(ast.parse(src))
    assert [(m, c) for m, _line, c in found] == [("step", ".tolist()")], found
    line = src.splitlines()[found[0][1] - 1]
    assert "memlint: ignore[host-sync]" in line
    above = " ".join(src.splitlines()[found[0][1] - 3: found[0][1] - 1])
    assert "greedy sampling" in above


@pytest.mark.parametrize("snippet,hit", [
    ("x = t.item()", True), ("x = t.cpu()", True), ("x = t.numpy()", True),
    ("x = np.asarray(t)", True), ("x = t.tolist()", True),
    ("x = t.clone()", False), ("x = torch.argmax(t)", False),
])
def test_host_sync_scan_sees_torch_syncs(snippet, hit):
    src = ("class ServeEngine:\n    def _drain_queries(self, t):\n"
           f"        {snippet}\n    def helper(self, t):\n        t.item()\n")
    assert bool(_syncs(ast.parse(src))) == hit
