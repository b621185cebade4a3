"""The port's zamba2 and rwkv6 against the JAX package's, on the CPU.

Both smoke configs in float32, with the JAX init carried across by
``zamba2_params_from_numpy`` / ``rwkv6_params_from_numpy``; token inputs
from numpy with fixed seeds. Checked: prefill logits, every cache entry and
four decode steps against the JAX model under both of its attention
implementations (``reference``: the chunked jnp scans; ``pallas_interpret``:
the Pallas kernels in interpret mode); prefill-then-decode against a longer
prefill; the init's parameter tree; the converters' types; and a
``ServeEngine`` of each package on each model with the ingest and query
lanes and five requests into four slots.

The last one pins a reference behaviour the port copies on purpose: the
engine's cache merge leaves zamba2's per-application KV caches (G, B, ...)
as they are, so a request admitted into a live cache decodes against the
previous occupant's keys and values (ROADMAP.md, section 3). Both packages
give that request the same tokens, and they differ from its tokens alone.

Tolerance: 2e-5 absolute in float32 for logits (of order 4) and caches, as
tests/test_torch_models.py: the same arithmetic, summed in another order by
XLA and by PyTorch (measured: under 5e-6).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.config import MemForestConfig as JaxMemForestConfig
from repro.configs import get_smoke_config as jax_smoke_config
from repro.core.memforest import MemForestSystem as JaxSystem
from repro.data.synthetic import make_workload
from repro.models import get_model as jax_get_model
from repro.serving.engine import ServeEngine as JaxEngine
from repro_torch import MemForestSystem, kernels
from repro_torch.configs import get_smoke_config
from repro_torch.convert import (rwkv6_params_from_numpy,
                                 zamba2_params_from_numpy)
from repro_torch.data.synthetic import make_workload as torch_make_workload
from repro_torch.models import get_model
from repro_torch.models import rwkv6, zamba2
from repro_torch.serving.engine import ServeEngine

MODEL_ATOL = 2e-5
ARCHS = ["zamba2_7b", "rwkv6_1b6"]
CONVERT = {"zamba2_7b": zamba2_params_from_numpy,
           "rwkv6_1b6": rwkv6_params_from_numpy}
SCAN = {"zamba2_7b": "mamba2_ssd", "rwkv6_1b6": "rwkv6_scan"}


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().to(torch.float32).numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _cfgs(arch, dtype="float32", impl="reference"):
    jc = jax_smoke_config(arch).replace(dtype=dtype, param_dtype=dtype,
                                        attention_impl=impl)
    tc = get_smoke_config(arch).replace(dtype=dtype, param_dtype=dtype)
    return jc, tc


@pytest.fixture(scope="module", params=ARCHS)
def arch_params(request):
    arch = request.param
    jc, tc = _cfgs(arch)
    jp = jax_get_model(jc).init(jax.random.key(0))
    tp = CONVERT[arch](jax.tree.map(np.asarray, jp), tc, device="cpu")
    return arch, jp, tp


def _prefill_and_decode(jm, tm, jp, tp, toks, steps, max_len):
    jl, jcache = jm.prefill(jp, {"tokens": jnp.asarray(toks)}, max_len)
    tl, tcache = tm.prefill(tp, {"tokens": torch.from_numpy(toks)}, max_len)
    # decode updates the port's cache in place: keep a copy of each step
    snap = lambda c: {k: v.clone() for k, v in c.items()}   # noqa: E731
    out = [((tl, snap(tcache)), (jl, jcache))]
    for _ in range(steps):
        nxt = np.asarray(jnp.argmax(jl, axis=-1)).astype(np.int32)
        jl, jcache = jm.decode(jp, {"tokens": jnp.asarray(nxt)}, jcache)
        tl, tcache = tm.decode(tp, {"tokens": torch.from_numpy(nxt).long()},
                               tcache)
        out.append(((tl, snap(tcache)), (jl, jcache)))
    return out


@pytest.mark.parametrize("impl", ["reference", "pallas_interpret"])
def test_prefill_and_decode_match_the_reference(arch_params, impl):
    arch, jp, tp = arch_params
    jc, tc = _cfgs(arch, impl=impl)
    toks = np.random.default_rng(9).integers(3, tc.vocab_size, size=(3, 16))
    before = kernels.COUNTS[SCAN[arch]].plain_calls
    steps = _prefill_and_decode(jax_get_model(jc), get_model(tc), jp, tp,
                                toks, steps=4, max_len=24)
    assert kernels.COUNTS[SCAN[arch]].plain_calls \
        == before + tc.num_layers      # one scan per layer, in prefill only
    for (tl, tcache), (jl, jcache) in steps:
        np.testing.assert_allclose(_np(tl), _np(jl), atol=MODEL_ATOL)
        assert list(tcache) == list(jcache)
        for key in tcache:
            assert tuple(tcache[key].shape) == tuple(jcache[key].shape), key
            assert _np(tcache[key]).dtype == _np(jcache[key]).dtype
            np.testing.assert_allclose(_np(tcache[key]), _np(jcache[key]),
                                       atol=MODEL_ATOL, err_msg=key)
    lengths = steps[-1][0][1]["lengths"]
    assert lengths.dtype == torch.int32 and lengths.tolist() == [20] * 3


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("dtype,atol", [("float32", 1e-4),
                                        ("bfloat16", 5e-2)])
def test_decode_matches_a_longer_prefill(arch, dtype, atol):
    """prefill(t[:16]) then decode(t[16]) equals prefill(t[:17])'s last
    logits: the recurrent state and the KV caches agree with the parallel
    path (tests/test_models.py's check, at its 5e-2 in bf16)."""
    _, tc = _cfgs(arch, dtype)
    model = get_model(tc)
    params = model.init(1, device="cpu")
    toks = torch.from_numpy(np.random.default_rng(3).integers(
        0, tc.vocab_size, size=(2, 17)))
    full, _ = model.prefill(params, {"tokens": toks}, 32)
    _, cache = model.prefill(params, {"tokens": toks[:, :16]}, 32)
    step, _ = model.decode(params, {"tokens": toks[:, 16]}, cache)
    np.testing.assert_allclose(_np(step), _np(full), atol=atol, rtol=atol)


@pytest.mark.parametrize("arch", ARCHS)
def test_init_matches_the_reference_tree(arch):
    """The port's init gives the reference's keys, shapes and types (its
    stacked layers unstacked into a list); the same seed, the same
    tensors."""
    jc, tc = _cfgs(arch, "bfloat16")
    want = jax.eval_shape(lambda: jax_get_model(jc).init(jax.random.key(0)))
    got = get_model(tc).init(5, device="cpu")
    again = get_model(tc).init(5, device="cpu")
    assert len(got["layers"]) == tc.num_layers

    def walk(w, g, a, stacked, path):
        if isinstance(w, dict):
            assert set(w) == set(g), path
            for k in w:
                walk(w[k], g[k], a[k], stacked, f"{path}.{k}")
            return
        shape = tuple(w.shape[1:] if stacked else w.shape)
        assert tuple(g.shape) == shape, path
        assert str(g.dtype).split(".")[-1] == str(w.dtype), path
        assert torch.equal(g, a), path

    for key in want:
        if key == "layers":
            for g, a in zip(got["layers"], again["layers"]):
                walk(want["layers"], g, a, True, "layers")
        else:
            walk(want[key], got[key], again[key], False, key)


@pytest.mark.parametrize("arch", ARCHS)
def test_converters_keep_each_leafs_type(arch):
    jc, tc = _cfgs(arch, "bfloat16")
    jp = jax_get_model(jc).init(jax.random.key(0))
    tp = CONVERT[arch](jax.tree.map(np.asarray, jp), tc, device="cpu")
    assert tp["embed"].dtype == torch.bfloat16
    layer = tp["layers"][tc.num_layers - 1]
    if arch == "zamba2_7b":
        m = layer["mamba"]
        for k in ("A_log", "dt_bias", "D_skip"):
            assert m[k].dtype == torch.float32, k
            np.testing.assert_array_equal(
                m[k].numpy(), np.asarray(jp["layers"]["mamba"][k][-1]))
        assert m["w_in"].dtype == torch.bfloat16
        assert tp["shared_attn"]["attn"]["wq"].dtype == torch.bfloat16
    else:
        assert layer["u"].dtype == torch.bfloat16
        np.testing.assert_array_equal(
            _np(layer["u"]), _np(jp["layers"]["u"][-1]))


def test_factory_routes_the_families(monkeypatch):
    for arch, mod in (("zamba2_7b", zamba2), ("rwkv6_1b6", rwkv6)):
        tc = get_smoke_config(arch)
        m = get_model(tc)
        cache = m.init_cache(2, 32, device="cpu")
        assert set(cache) == set(mod.init_cache(tc, 2, 32, device="cpu"))
        assert cache["lengths"].tolist() == [0, 0]
        # the entry points take the card unless the CPU is asked for
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            m.init(0)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            m.init_cache(2, 32)
        monkeypatch.undo()


# ---------------------------------------------------------------------------
# the serve engine of both packages
# ---------------------------------------------------------------------------
PROMPTS = [[5, 6, 7, 8, 9, 10], [11, 12, 13], [14, 15, 16, 17, 18],
           [19, 20, 21, 22], [23, 24, 25, 26, 27, 28, 29]]
NEW = [3, 7, 7, 7, 5]        # slot 0 frees first; request 4 is admitted late


def _serve(arch, jp, tp, prompts, new_tokens, lanes):
    jc, tc = _cfgs(arch)
    kw = dict(max_batch=4, max_len=48, max_ingest_batch=4)
    if lanes:
        wkw = dict(num_entities=4, num_sessions=6, transitions_per_entity=3,
                   num_queries=8, seed=2)
        wl_j, wl_t = make_workload(**wkw), torch_make_workload(**wkw)
        jmem, tmem = JaxSystem(JaxMemForestConfig()), \
            MemForestSystem(device="cpu")
    else:
        jmem = tmem = None
    je = JaxEngine(jax_get_model(jc), jp, memory=jmem, **kw)
    te = ServeEngine(get_model(tc), tp, memory=tmem, **kw)
    rids = {}
    for e, wl in ((je, wl_j if lanes else None), (te, wl_t if lanes else None)):
        if lanes:
            for s in wl.sessions:
                e.submit_session(s)
            rids[id(e)] = [e.submit_query(q) for q in wl.queries]
        for p, n in zip(prompts, new_tokens):
            e.submit(p, max_new_tokens=n)
        e.run_until_drained()
    return je, te, rids


def _tokens(engine):
    return {r.req_id: r.out_tokens for r in engine.finished}


def test_serve_engine_matches_the_reference(arch_params):
    arch, jp, tp = arch_params
    je, te, rids = _serve(arch, jp, tp, PROMPTS, NEW, lanes=True)
    assert _tokens(te) == _tokens(je) and len(te.finished) == 5
    jm, tm = je.metrics(), te.metrics()
    for k in ("decode_steps", "decoded_tokens", "prefills", "ingest_sessions",
              "ingest_batches", "queries_served", "query_batches"):
        assert tm[k] == jm[k], k
    assert tm["queries_served"] == 8 and tm["prefills"] == 2
    assert [f.text for f in te.memory.forest.facts] \
        == [f.text for f in je.memory.forest.facts]
    got = [(r.answer, r.evidence) for r in map(te.pop_query_result,
                                                 rids[id(te)])]
    want = [(r.answer, r.evidence) for r in map(je.pop_query_result,
                                                  rids[id(je)])]
    assert got == want

    # the late-admitted request, against the same prompt alone
    late = _tokens(te)[4 + 8]                 # ids 0-7 went to the queries
    _, alone, _ = _serve(arch, jp, tp, PROMPTS[4:], NEW[4:], lanes=False)
    solo = alone.finished[0].out_tokens
    if arch == "zamba2_7b":
        # the KV caches of the shared block keep slot 0's first occupant:
        # the reference's merge rule, matched (ROADMAP.md, section 3)
        assert late != solo
    else:
        assert late == solo                   # every state entry is merged
