"""The port's dense transformer against the JAX package's, on the CPU.

Parameters come from ``get_model(cfg).init(jax.random.key(0))`` and are
carried across with ``transformer_params_from_numpy``; inputs come from numpy
with fixed seeds. Layers: the attention kernels' plain versions (against
``repro.kernels.ref`` and the Pallas kernels in interpret mode), RMSNorm,
RoPE, the attention blocks, the MLPs, the trunk, prefill and decode. Then
``ModelEncoder`` and a ``MemForestSystem`` built on it.

Tolerances. Kernels: those of tests/test_kernels.py (atol 2e-5 in float32,
2e-2 in bf16, rtol 1e-2). Model outputs in float32: 2e-5 absolute (the same
arithmetic, summed in another order by XLA and by PyTorch). In bf16 the two
frameworks round the activations at different places (fused vs. unfused
elementwise ops), so a few bf16 ulps of 2^-8 relative each may build up:
the bf16 comparison allows 5e-2 absolute on outputs of order one.
Encoder embeddings: 1e-5.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_smoke_config as jax_smoke_config
from repro.core.encoder import ModelEncoder as JaxModelEncoder
from repro.core.memforest import MemForestSystem as JaxSystem
from repro.config import MemForestConfig as JaxMemForestConfig
from repro.data.synthetic import make_workload
from repro.data.tokenizer import HashTokenizer as JaxTokenizer
from repro.kernels import ops as jax_ops
from repro.kernels import ref as jax_ref
from repro.models import get_model as jax_get_model
from repro.models import layers as jax_layers
from repro.models import transformer as jax_transformer
from repro_torch import MemForestConfig, MemForestSystem, kernels
from repro_torch.configs import ARCHS as ALL_ARCHS
from repro_torch.configs import get_smoke_config
from repro_torch.convert import transformer_params_from_numpy
from repro_torch.core.encoder import EncoderStats, ModelEncoder
from repro_torch.data.synthetic import make_workload as torch_make_workload
from repro_torch.data.tokenizer import HashTokenizer
from repro_torch.kernels import ops
from repro_torch.models import get_model, make_batch
from repro_torch.models import layers as L
from repro_torch.models import transformer as T

ATOL = {"float32": 2e-5, "bfloat16": 2e-2}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
MODEL_ATOL = 2e-5
BF16_MODEL_ATOL = 5e-2
ARCHS = ["llama3_8b", "phi3_mini"]


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().to(torch.float32).numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _pair(rng, shape, dtype, scale=1.0):
    """The same values as a jax array and a torch tensor of ``dtype``."""
    x = (rng.normal(size=shape) * scale).astype(np.float32)
    j = jnp.asarray(x, JDT[dtype])
    return j, torch.from_numpy(np.asarray(j.astype(jnp.float32))).to(TDT[dtype])


def _cfgs(arch, dtype="float32", **kw):
    jc = jax_smoke_config(arch).replace(dtype=dtype, param_dtype=dtype, **kw)
    tc = get_smoke_config(arch).replace(dtype=dtype, param_dtype=dtype, **kw)
    return jc, tc


def _params(jc, tc):
    jp = jax_get_model(jc).init(jax.random.key(0))
    tp = transformer_params_from_numpy(jax.tree.map(np.asarray, jp), tc,
                                       device="cpu")
    return jp, tp


@pytest.fixture(scope="module", params=ARCHS)
def f32_model(request):
    jc, tc = _cfgs(request.param)
    jp, tp = _params(jc, tc)
    return jc, tc, jp, tp


# ---------------------------------------------------------------------------
# kernels: plain versions against the oracle and the interpret-mode Pallas
# ---------------------------------------------------------------------------
FLASH_CASES = [
    # B, S, Hq, Hkv, D, causal
    (2, 23, 4, 4, 16, True),        # group 1, S not a multiple of a block
    (2, 37, 4, 2, 16, False),       # group 2, full
    (1, 19, 8, 2, 128, True),       # group 4, head_dim 128
    (3, 29, 8, 2, 128, False),
    (1, 64, 4, 1, 16, True),
]


@pytest.mark.parametrize("B,S,Hq,Hkv,D,causal", FLASH_CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_plain(B, S, Hq, Hkv, D, causal, dtype):
    rng = np.random.default_rng(B * 1000 + S + D)
    qj, qt = _pair(rng, (B, S, Hq, D), dtype)
    kj, kt = _pair(rng, (B, S, Hkv, D), dtype)
    vj, vt = _pair(rng, (B, S, Hkv, D), dtype)
    before = kernels.COUNTS["flash_attention"].plain_calls
    out = ops.attention(qt, kt, vt, causal=causal)
    assert kernels.COUNTS["flash_attention"].plain_calls == before + 1
    assert out.dtype == TDT[dtype] and out.shape == (B, S, Hq, D)
    want = jax_ref.attention_ref(qj, kj, vj, causal=causal)
    pal = jax_ops.attention(qj, kj, vj, causal=causal, impl="pallas_interpret")
    for other in (want, pal):
        np.testing.assert_allclose(_np(out), _np(other), atol=ATOL[dtype],
                                   rtol=1e-2)


DECODE_CASES = [
    # B, Smax, Hq, Hkv, D
    (4, 48, 4, 4, 16),              # group 1
    (4, 40, 4, 2, 16),              # group 2
    (3, 64, 8, 2, 128),             # group 4, head_dim 128
    (5, 33, 8, 2, 16),
]


@pytest.mark.parametrize("B,Smax,Hq,Hkv,D", DECODE_CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_attention_plain(B, Smax, Hq, Hkv, D, dtype):
    rng = np.random.default_rng(B * 100 + Smax + D)
    qj, qt = _pair(rng, (B, Hq, D), dtype)
    kj, kt = _pair(rng, (B, Smax, Hkv, D), dtype)
    vj, vt = _pair(rng, (B, Smax, Hkv, D), dtype)
    lengths = rng.integers(1, Smax + 1, size=B).astype(np.int32)
    lengths[0] = 0                      # the Pallas kernel's zeros
    lengths[1] = Smax                   # the full cache
    before = kernels.COUNTS["decode_attention"].plain_calls
    out = ops.decode_attention(qt, kt, vt, torch.from_numpy(lengths))
    assert kernels.COUNTS["decode_attention"].plain_calls == before + 1
    assert out.dtype == TDT[dtype] and out.shape == (B, Hq, D)
    pal = jax_ops.decode_attention(qj, kj, vj, jnp.asarray(lengths),
                                   impl="pallas_interpret")
    np.testing.assert_allclose(_np(out), _np(pal), atol=ATOL[dtype], rtol=1e-2)
    # the jnp oracle agrees wherever the length is not 0
    want = jax_ref.decode_attention_ref(qj, kj, vj, jnp.asarray(lengths))
    np.testing.assert_allclose(_np(out)[1:], _np(want)[1:], atol=ATOL[dtype],
                               rtol=1e-2)


def test_decode_attention_length_zero_gives_zeros():
    """Length 0: the Pallas kernel skips every block and returns zeros; the
    jnp oracle returns the mean of v over all Smax rows. The port follows
    the kernel, in its plain version as in its CUDA kernel."""
    rng = np.random.default_rng(7)
    qj, qt = _pair(rng, (2, 4, 16), "float32")
    kj, kt = _pair(rng, (2, 32, 2, 16), "float32")
    vj, vt = _pair(rng, (2, 32, 2, 16), "float32")
    lengths = np.array([0, 5], np.int32)
    out = _np(ops.decode_attention(qt, kt, vt, torch.from_numpy(lengths)))
    pal = _np(jax_ops.decode_attention(qj, kj, vj, jnp.asarray(lengths),
                                       impl="pallas_interpret"))
    oracle = _np(jax_ref.decode_attention_ref(qj, kj, vj, jnp.asarray(lengths)))
    assert not out[0].any() and not pal[0].any()
    np.testing.assert_allclose(oracle[0], np.repeat(
        _np(vj)[0].mean(axis=0), 2, axis=0), atol=1e-5)


def test_decode_attention_past_smax_covers_the_whole_cache():
    rng = np.random.default_rng(8)
    qj, qt = _pair(rng, (2, 4, 16), "float32")
    kj, kt = _pair(rng, (2, 16, 2, 16), "float32")
    vj, vt = _pair(rng, (2, 16, 2, 16), "float32")
    over = torch.tensor([16, 40], dtype=torch.int32)
    full = torch.tensor([16, 16], dtype=torch.int32)
    np.testing.assert_array_equal(_np(ops.decode_attention(qt, kt, vt, over)),
                                  _np(ops.decode_attention(qt, kt, vt, full)))
    want = jax_ref.decode_attention_ref(qj, kj, vj, jnp.asarray([16, 40]))
    np.testing.assert_allclose(_np(ops.decode_attention(qt, kt, vt, over)),
                               _np(want), atol=2e-5)


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rms_norm(dtype):
    rng = np.random.default_rng(1)
    xj, xt = _pair(rng, (3, 5, 64), dtype)
    gj, gt = _pair(rng, (64,), dtype)
    out = L.rms_norm(xt, gt, 1e-5)
    assert out.dtype == TDT[dtype]
    np.testing.assert_allclose(_np(out), _np(jax_layers.rms_norm(xj, gj, 1e-5)),
                               atol=ATOL[dtype], rtol=1e-2)


@pytest.mark.parametrize("shape,pos_shape", [((2, 7, 4, 16), (1, 7)),
                                             ((3, 4, 128), (3,))])
@pytest.mark.parametrize("theta", [500000.0, 10000.0])
@pytest.mark.parametrize("max_pos", [64, 600])
def test_rope(shape, pos_shape, theta, max_pos):
    """Up to position 64 (the model tests' range) within 2e-5. Further out
    the angle pos * freq carries the frequencies' rounding: XLA's and
    PyTorch's float32 exp differ by one ulp (1.2e-7 relative) on some of
    them, so the angles differ by up to pos * 1.2e-7 rad and the outputs by
    as much again times |x|: 2e-5 + 4 * max_pos * 1.2e-7 allows for it."""
    rng = np.random.default_rng(2)
    xj, xt = _pair(rng, shape, "float32")
    pos = rng.integers(0, max_pos, size=pos_shape).astype(np.int32)
    out = L.rope(xt, torch.from_numpy(pos), theta)
    want = jax_layers.rope(xj, jnp.asarray(pos), theta)
    np.testing.assert_allclose(_np(out), _np(want),
                               atol=MODEL_ATOL + 4 * max_pos * 1.2e-7)


def test_attention_prefill(f32_model):
    jc, tc, jp, tp = f32_model
    rng = np.random.default_rng(3)
    xj, xt = _pair(rng, (2, 11, tc.d_model), "float32")
    pos = np.arange(11)[None, :]
    pj = jax.tree.map(lambda a: a[0], jp["layers"])["attn"]
    out, (k, v) = L.attention_prefill(tp["layers"][0]["attn"], xt, tc,
                                      torch.from_numpy(pos), return_kv=True)
    wout, (wk, wv) = jax_layers.attention_prefill(pj, xj, jc, jnp.asarray(pos),
                                                  return_kv=True)
    for a, b in ((out, wout), (k, wk), (v, wv)):
        np.testing.assert_allclose(_np(a), _np(b), atol=MODEL_ATOL)


def test_attention_decode_writes_in_place_and_clamps(f32_model):
    jc, tc, jp, tp = f32_model
    rng = np.random.default_rng(4)
    B, Smax = 3, 12
    xj, xt = _pair(rng, (B, tc.d_model), "float32")
    kj, kt = _pair(rng, (B, Smax, tc.num_kv_heads, tc.head_dim), "float32")
    vj, vt = _pair(rng, (B, Smax, tc.num_kv_heads, tc.head_dim), "float32")
    lengths = np.array([0, 5, 30], np.int32)        # 30 runs past Smax
    pj = jax.tree.map(lambda a: a[0], jp["layers"])["attn"]
    out, k2, v2 = L.attention_decode(tp["layers"][0]["attn"], xt, tc, kt, vt,
                                     torch.from_numpy(lengths))
    assert k2 is kt and v2 is vt                    # written in place
    wout, wk, wv = jax_layers.attention_decode(pj, xj, jc, kj, vj,
                                               jnp.asarray(lengths))
    for a, b in ((out, wout), (k2, wk), (v2, wv)):
        np.testing.assert_allclose(_np(a), _np(b), atol=MODEL_ATOL)


@pytest.mark.parametrize("act", ["swiglu", "gelu", "relu2"])
def test_mlp_block(act):
    jc, tc = _cfgs("llama3_8b", mlp_activation=act)
    jp, tp = _params(jc, tc)
    rng = np.random.default_rng(5)
    xj, xt = _pair(rng, (2, 6, tc.d_model), "float32")
    pj = jax.tree.map(lambda a: a[1], jp["layers"])["mlp"]
    out = L.mlp_block(tp["layers"][1]["mlp"], xt, tc)
    np.testing.assert_allclose(_np(out), _np(jax_layers.mlp_block(pj, xj, jc)),
                               atol=MODEL_ATOL)


def test_init_distributions():
    """Random weights on a seeded generator: the reference's scales,
    ones for the norms, the same seed gives the same tensors."""
    tc = get_smoke_config("llama3_8b").replace(d_model=256, d_ff=512,
                                               dtype="float32",
                                               param_dtype="float32")
    a = T.init_params(tc, 3, device="cpu")
    b = T.init_params(tc, 3, device="cpu")
    assert torch.equal(a["layers"][1]["mlp"]["w_up"],
                       b["layers"][1]["mlp"]["w_up"])
    assert float(a["embed"].std()) == pytest.approx(0.02, rel=0.05)
    assert float(a["layers"][0]["attn"]["wq"].std()) == \
        pytest.approx(256 ** -0.5, rel=0.05)
    assert float(a["layers"][0]["mlp"]["w_down"].std()) == \
        pytest.approx(512 ** -0.5, rel=0.05)
    assert bool((a["final_norm"] == 1).all() and (a["layers"][0]["ln1"] == 1).all())
    assert len(a["layers"]) == tc.num_layers and "unembed" in a


# ---------------------------------------------------------------------------
# the model: trunk, prefill, decode
# ---------------------------------------------------------------------------
def test_trunk(f32_model):
    jc, tc, jp, tp = f32_model
    rng = np.random.default_rng(6)
    toks = rng.integers(3, tc.vocab_size, size=(3, 13))
    pos = np.arange(13)[None, :]
    h, aux = T.trunk(tp, tc, tp["embed"][torch.from_numpy(toks)],
                     torch.from_numpy(pos))
    wh, waux = jax_transformer.trunk(jp, jc, jp["embed"][jnp.asarray(toks)],
                                     jnp.asarray(pos))
    np.testing.assert_allclose(_np(h), _np(wh), atol=MODEL_ATOL)
    assert float(aux) == float(waux) == 0.0


def _prefill_and_decode(jc, tc, jp, tp, steps, max_len, prompt_len=9, B=3,
                        seed=9):
    rng = np.random.default_rng(seed)
    toks = rng.integers(3, tc.vocab_size, size=(B, prompt_len))
    jm, tm = jax_get_model(jc), get_model(tc)
    jl, jcache = jm.prefill(jp, {"tokens": jnp.asarray(toks)}, max_len)
    tl, tcache = tm.prefill(tp, {"tokens": torch.from_numpy(toks)}, max_len)
    # decode writes the port's cache in place: keep a copy of each step
    snap = lambda c: {k: v.clone() for k, v in c.items()}
    out = [((tl, snap(tcache)), (jl, jcache))]
    for _ in range(steps):
        nxt = np.asarray(jnp.argmax(jl, axis=-1)).astype(np.int32)
        jl, jcache = jm.decode(jp, {"tokens": jnp.asarray(nxt)}, jcache)
        tl, tcache = tm.decode(tp, {"tokens": torch.from_numpy(nxt).long()},
                               tcache)
        out.append(((tl, snap(tcache)), (jl, jcache)))
    return out


def _check_step(t, j, atol):
    (tl, tcache), (jl, jcache) = t, j
    np.testing.assert_allclose(_np(tl), _np(jl), atol=atol)
    np.testing.assert_allclose(_np(tcache["k"]), _np(jcache["k"]), atol=atol)
    np.testing.assert_allclose(_np(tcache["v"]), _np(jcache["v"]), atol=atol)
    np.testing.assert_array_equal(tcache["lengths"].numpy(),
                                  np.asarray(jcache["lengths"]))


def test_prefill_and_decode_steps(f32_model):
    jc, tc, jp, tp = f32_model
    steps = _prefill_and_decode(jc, tc, jp, tp, steps=4, max_len=24)
    for t, j in steps:
        _check_step(t, j, MODEL_ATOL)
    assert steps[-1][0][1]["k"].shape == (tc.num_layers, 3, 24,
                                          tc.num_kv_heads, tc.head_dim)


def test_decode_past_max_len_matches_the_clamp(f32_model):
    """Prompt 9 + 6 steps in a 12-wide cache: the reference clamps the
    write to the last row; the port does the same."""
    jc, tc, jp, tp = f32_model
    for t, j in _prefill_and_decode(jc, tc, jp, tp, steps=6, max_len=12):
        _check_step(t, j, MODEL_ATOL)


def test_tied_embeddings_and_softcap():
    jc, tc = _cfgs("granite_3_8b", logits_softcap=3.0)
    jp, tp = _params(jc, tc)
    assert "unembed" not in tp
    for t, j in _prefill_and_decode(jc, tc, jp, tp, steps=2, max_len=16):
        _check_step(t, j, MODEL_ATOL)


def test_gelu_arch_prefill_and_decode():
    jc, tc = _cfgs("starcoder2_7b")
    jp, tp = _params(jc, tc)
    for t, j in _prefill_and_decode(jc, tc, jp, tp, steps=2, max_len=16):
        _check_step(t, j, MODEL_ATOL)


def test_bf16_prefill_and_decode():
    jc, tc = _cfgs("llama3_8b", dtype="bfloat16")
    jp, tp = _params(jc, tc)
    assert tp["embed"].dtype == torch.bfloat16
    steps = _prefill_and_decode(jc, tc, jp, tp, steps=3, max_len=16)
    for t, j in steps:
        _check_step(t, j, BF16_MODEL_ATOL)
        assert t[0].dtype == torch.bfloat16 and t[1]["k"].dtype == torch.bfloat16


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_get_model_builds_every_arch(arch):
    """Every family the reference has: the smoke config's own init on the
    CPU, a prefill and one decode step with finite logits of the right
    shape, and the cache's lengths moved on by one."""
    cfg = get_smoke_config(arch)
    model = get_model(cfg)
    params = model.init(0, device="cpu")
    batch = make_batch(cfg, "prefill", 2, 8, 0, device="cpu")
    logits, cache = model.prefill(params, batch, 16)
    assert logits.shape == (2, cfg.vocab_size)
    assert bool(torch.isfinite(logits.float()).all())
    step = make_batch(cfg, "decode", 2, 1, 1, device="cpu")
    logits, cache2 = model.decode(params, step, cache)
    assert logits.shape == (2, cfg.vocab_size)
    assert bool(torch.isfinite(logits.float()).all())
    if "lengths" in cache:
        S = 8 + (cfg.num_patches if cfg.family == "vlm" else 0)
        assert cache2["lengths"].tolist() == [S + 1] * 2


# ---------------------------------------------------------------------------
# ModelEncoder and MemForest on it
# ---------------------------------------------------------------------------
TEXTS = ["alice moved to paris in may", "bob's dog is named rex",
         "the meeting moved to thursday at noon", "x", "",
         "carol works at the bakery on elm street since 2019"]


@pytest.fixture(scope="module")
def encoders():
    jc, tc = _cfgs("llama3_8b")
    jp, tp = _params(jc, tc)
    jenc = JaxModelEncoder(jc, jp, JaxTokenizer(jc.vocab_size), max_len=32)
    tenc = ModelEncoder(tc, tp, HashTokenizer(tc.vocab_size), max_len=32)
    return jenc, tenc


def test_model_encoder(encoders):
    jenc, tenc = encoders
    out = tenc.encode(TEXTS)
    want = np.asarray(jenc.encode(TEXTS))
    assert out.shape == want.shape == (len(TEXTS), 64)
    np.testing.assert_allclose(out, want, atol=1e-5)
    seq = tenc.encode(TEXTS[:3], sequential=True)
    np.testing.assert_allclose(seq, want[:3], atol=1e-5)
    assert tenc.encode([]).shape == (0, 64)


def test_model_encoder_stats(encoders):
    jenc, tenc = encoders
    jenc.stats.reset()
    tenc.stats.reset()
    jenc.encode(TEXTS)
    tenc.encode(TEXTS)
    for k in ("calls", "tokens", "texts", "sequential_calls"):
        assert getattr(tenc.stats, k) == getattr(jenc.stats, k), k


class SharedModelEncoder:
    """Test-only encoder for the port that returns the JAX ModelEncoder's
    embeddings, with the port's own accounting."""

    def __init__(self, jenc):
        self._jax = jenc
        self.dim = jenc.dim
        self.stats = EncoderStats()

    def encode(self, texts, *, sequential=False):
        self.stats.calls += 1
        self.stats.texts += len(texts)
        return np.asarray(self._jax.encode(texts, sequential=sequential))

    def encode_one(self, text):
        return self.encode([text])[0]


MODES = ["flat", "root-only", "emb", "emb+planner", "llm", "llm+planner"]


@pytest.fixture(scope="module", params=["own", "shared"])
def model_systems(request, encoders):
    jenc, tenc = encoders
    kw = dict(num_entities=4, num_sessions=6, transitions_per_entity=3,
              num_queries=10, seed=0)
    wl_j, wl_t = make_workload(**kw), torch_make_workload(**kw)
    j = JaxSystem(JaxMemForestConfig(embed_dim=64), jenc)
    enc = SharedModelEncoder(jenc) if request.param == "shared" else tenc
    t = MemForestSystem(MemForestConfig(embed_dim=64), enc, device="cpu")
    for i in range(0, 6, 3):
        j.ingest_batch(wl_j.sessions[i:i + 3])
        t.ingest_batch(wl_t.sessions[i:i + 3])
    answers = {m: ([(r.answer, r.evidence) for r in j.query_batch(wl_j.queries, mode=m)],
                   [(r.answer, r.evidence) for r in t.query_batch(wl_t.queries, mode=m)])
               for m in MODES}
    return j, t, answers


def test_model_memforest_facts_trees_exact(model_systems):
    j, t, _ = model_systems
    sig = lambda f: (f.fact_id, f.text, f.subject, f.attribute, f.value, f.ts,
                     f.prev_value, list(f.sources))
    assert [sig(f) for f in t.forest.facts] == [sig(f) for f in j.forest.facts]
    assert t.scale_stats() == j.scale_stats()
    assert list(t.forest.trees) == list(j.forest.trees)
    for key, tj in j.forest.trees.items():
        tt = t.forest.trees[key]
        assert (tt.children, tt.level, tt.root, tt.parent) == \
            (tj.children, tj.level, tj.root, tj.parent), key
        n = len(tj.level)
        np.testing.assert_allclose(tt.emb[:n], tj.emb[:n], atol=1e-5)
    assert t.forest.placement == j.forest.placement


@pytest.mark.parametrize("mode", MODES)
def test_model_memforest_answers_exact(model_systems, mode):
    _, _, answers = model_systems
    aj, at = answers[mode]
    assert at == aj
