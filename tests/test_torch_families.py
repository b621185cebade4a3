"""The port's MoE, VLM and whisper families against the JAX package's, on
the CPU.

Parameters come from the JAX init and are carried across with
``transformer_params_from_numpy`` / ``whisper_params_from_numpy``; inputs
come from numpy with fixed seeds. The JAX models run their reference
attention (the jnp oracles), and whisper also runs the Pallas kernels in
interpret mode (``pallas_interpret``): its encoder is the one full,
non-causal attention of these families. The attention kernels' plain
versions are held to the Pallas kernels in interpret mode at the families'
head shapes, as tests/test_torch_models.py holds them at the dense
family's.

Checked: ``moe_block`` (gate indices and the set of (token, choice) pairs
kept within capacity exactly, with and without dropped choices and with
planted ties between router columns; outputs and the aux loss), the smoke
configs of olmoe, pixtral (with and without patch embeddings) and whisper
through prefill and four decode steps, ``ModelEncoder`` and a
``MemForestSystem`` on an olmoe trunk, both packages' ``ServeEngine`` on
olmoe, the converters' types, the full configs' parameter counts and
shapes, and that ``moe_block`` runs on ``meta`` tensors (no step of it waits
for the device: no ``.item``, ``.tolist``, ``nonzero`` or boolean-mask
indexing).

Tolerances. float32 model outputs and caches: 2e-5 absolute, as
tests/test_torch_models.py (the same arithmetic, summed in another order by
XLA and by PyTorch). ``moe_block`` outputs: 1e-5; its aux loss: 1e-6. The
whisper position table: row p within 1.2e-7 * (p + 1): both packages compute
10000^(2i/D) in float32, where XLA's and PyTorch's ``pow`` differ by up to
one ulp (1.2e-7 relative), which moves the angle p / 10000^(2i/D) by up to
p * 1.2e-7 radians (measured: 9.5e-7 at most over 32768 x 512 rows).
Encoder embeddings: 1e-5.
"""
import gc
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.config import MemForestConfig as JaxMemForestConfig
from repro.configs import get_config as jax_config
from repro.configs import get_smoke_config as jax_smoke_config
from repro.configs.shapes import SHAPES as JAX_SHAPES
from repro.configs.shapes import shape_applicable as jax_applicable
from repro.core.encoder import ModelEncoder as JaxModelEncoder
from repro.core.memforest import MemForestSystem as JaxSystem
from repro.data.synthetic import make_workload
from repro.data.tokenizer import HashTokenizer as JaxTokenizer
from repro.kernels import ops as jax_ops
from repro.models import get_model as jax_get_model
from repro.models import layers as jax_layers
from repro.models import transformer as jax_transformer
from repro.models import whisper as jax_whisper
from repro.serving.engine import ServeEngine as JaxEngine
from repro_torch import MemForestConfig, MemForestSystem
from repro_torch.configs import ARCHS, get_config, get_smoke_config
from repro_torch.configs.shapes import SHAPES, cells_for_arch, shape_applicable
from repro_torch.convert import (transformer_params_from_numpy,
                                 whisper_params_from_numpy)
from repro_torch.core.encoder import ModelEncoder
from repro_torch.data.synthetic import make_workload as torch_make_workload
from repro_torch.data.tokenizer import HashTokenizer
from repro_torch.kernels import ops
from repro_torch.models import get_model, make_batch
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.models import whisper as W
from repro_torch.serving.engine import ServeEngine

MODEL_ATOL = 2e-5
MOE_ATOL = 1e-5
AUX_ATOL = 1e-6
IMPLS = ["reference", "pallas_interpret"]
MODES = ["flat", "root-only", "emb", "emb+planner", "llm", "llm+planner"]


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().to(torch.float32).numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _cfgs(arch, impl="reference", **kw):
    jc = jax_smoke_config(arch).replace(dtype="float32",
                                        param_dtype="float32",
                                        attention_impl=impl, **kw)
    tc = get_smoke_config(arch).replace(dtype="float32",
                                        param_dtype="float32", **kw)
    return jc, tc


def _params(jc, tc):
    jp = jax_get_model(jc).init(jax.random.key(0))
    conv = (whisper_params_from_numpy if tc.family == "encdec"
            else transformer_params_from_numpy)
    return jp, conv(jax.tree.map(np.asarray, jp), tc, device="cpu")


# ---------------------------------------------------------------------------
# the attention kernels' plain versions at the families' head shapes
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("B,S,H,D,causal", [
    (2, 37, 4, 128, True),      # olmoe: group 1, head dim 128
    (2, 100, 2, 64, False),     # whisper's encoder: full, a ragged last block
])
def test_flash_attention_plain_at_family_shapes(B, S, H, D, causal):
    rng = np.random.default_rng(S + D)
    q, k, v = (rng.normal(size=(B, S, H, D)).astype(np.float32)
               for _ in range(3))
    out = ops.attention(*(torch.from_numpy(a) for a in (q, k, v)),
                        causal=causal)
    want = jax_ops.attention(*(jnp.asarray(a) for a in (q, k, v)),
                             causal=causal, impl="pallas_interpret")
    np.testing.assert_allclose(_np(out), _np(want), atol=2e-5, rtol=1e-2)


@pytest.mark.parametrize("B,Smax,H,D", [(3, 40, 4, 128), (3, 24, 2, 64)])
def test_decode_attention_plain_at_family_shapes(B, Smax, H, D):
    rng = np.random.default_rng(Smax + D)
    q = rng.normal(size=(B, H, D)).astype(np.float32)
    k, v = (rng.normal(size=(B, Smax, H, D)).astype(np.float32)
            for _ in range(2))
    lengths = np.array([1, Smax // 2, Smax], np.int32)
    out = ops.decode_attention(torch.from_numpy(q), torch.from_numpy(k),
                               torch.from_numpy(v), torch.from_numpy(lengths))
    want = jax_ops.decode_attention(jnp.asarray(q), jnp.asarray(k),
                                    jnp.asarray(v), jnp.asarray(lengths),
                                    impl="pallas_interpret")
    np.testing.assert_allclose(_np(out), _np(want), atol=2e-5, rtol=1e-2)


# ---------------------------------------------------------------------------
# moe_block
# ---------------------------------------------------------------------------
def _moe_cfgs(E, K, cf):
    return _cfgs("olmoe_1b_7b", num_experts=E, experts_per_token=K,
                 moe_capacity_factor=cf)


def _moe_params(jc, tc, rng, ties=False):
    """One layer's MoE weights as numpy, both packages' trees. With
    ``ties``, the router's columns come in groups of three equal columns."""
    E, D, F = tc.num_experts, tc.d_model, tc.d_ff
    p = {"router": rng.normal(size=(D, E)) / math.sqrt(D),
         "we_gate": rng.normal(size=(E, D, F)) / math.sqrt(D),
         "we_up": rng.normal(size=(E, D, F)) / math.sqrt(D),
         "we_down": rng.normal(size=(E, F, D)) / math.sqrt(F)}
    p = {k: v.astype(np.float32) for k, v in p.items()}
    if ties:
        for g in range(E // 3):
            p["router"][:, 3 * g + 1] = p["router"][:, 3 * g]
            p["router"][:, 3 * g + 2] = p["router"][:, 3 * g]
    return ({k: jnp.asarray(v) for k, v in p.items()},
            {k: torch.from_numpy(v) for k, v in p.items()})


def _jax_gate(pj, xj, K):
    """The reference's router and top-k (``moe_block``'s ``gate``)."""
    probs = jax.nn.softmax(xj @ pj["router"], axis=-1)
    return probs, jax.lax.top_k(probs, K)[1]


def _kept(dispatch, x, gi, p, E, K, C, pkg):
    """The (T, K) kept set from a package's dispatch function itself: with
    every expert the same FFN f and choice j weighted 2^j, token t's output
    is f(x_t) times the sum of 2^j over its kept choices."""
    w = np.broadcast_to(2.0 ** np.arange(K, dtype=np.float32), gi.shape)
    same = {k: np.broadcast_to(v[:1], v.shape).copy() for k, v in p.items()
            if k != "router"}
    if pkg == "jax":
        out = dispatch(jnp.asarray(x), jnp.asarray(w), jnp.asarray(gi),
                       *(jnp.asarray(same[k]) for k in
                         ("we_gate", "we_up", "we_down")),
                       E=E, K=K, C=C, e_lo=jnp.asarray(0, jnp.int32),
                       E_local=E)
    else:
        out = dispatch(torch.from_numpy(x), torch.from_numpy(w.copy()),
                       torch.from_numpy(gi).long(),
                       *(torch.from_numpy(same[k]) for k in
                         ("we_gate", "we_up", "we_down")), E=E, K=K, C=C)
    h = x @ same["we_gate"][0]
    f = (h / (1 + np.exp(-h))) * (x @ same["we_up"][0]) @ same["we_down"][0]
    col = np.abs(f).argmax(axis=1)
    rows = np.arange(len(x))
    code = np.rint(_np(out)[rows, col] / f[rows, col]).astype(int)
    return (code[:, None] >> np.arange(K)) & 1


def _kept_loop(gi, C):
    """The capacity rule written as a loop: a choice is kept when fewer
    than C earlier (token, choice) pairs chose its expert."""
    seen, kept = {}, np.zeros(gi.shape, int)
    for t in range(gi.shape[0]):
        for j in range(gi.shape[1]):
            e = int(gi[t, j])
            kept[t, j] = seen.get(e, 0) < C
            seen[e] = seen.get(e, 0) + 1
    return kept


MOE_CASES = [(E, K, cf) for E in (8, 64) for K in (1, 2, 8) if K <= E
             for cf in (0.5, 1.25)]


@pytest.mark.parametrize("ties", [False, True], ids=["random", "ties"])
@pytest.mark.parametrize("E,K,cf", MOE_CASES)
def test_moe_block(E, K, cf, ties):
    jc, tc = _moe_cfgs(E, K, cf)
    rng = np.random.default_rng(E * 100 + K * 10 + int(cf * 4) + ties)
    pj, pt = _moe_params(jc, tc, rng, ties)
    B, S = 3, 11
    x = rng.normal(size=(B, S, tc.d_model)).astype(np.float32)
    T_, D = B * S, tc.d_model
    C = max(int(math.ceil(T_ * K / E * cf)), 1)
    xf = x.reshape(T_, D)

    probs, jgi = _jax_gate(pj, jnp.asarray(xf), K)
    gw, gi, aux = L.moe_gate(pt, torch.from_numpy(xf), tc)
    np.testing.assert_array_equal(gi.numpy(), np.asarray(jgi))
    if ties:
        # the planted ties are exact in both packages, and the lower expert
        # of a group comes first
        tp = torch.softmax(torch.from_numpy(xf) @ pt["router"], -1).numpy()
        for g in range(E // 3):
            cols = [3 * g, 3 * g + 1, 3 * g + 2]
            for pr in (np.asarray(probs), tp):
                assert (pr[:, cols] == pr[:, cols[:1]]).all()
        # where m experts of a group are chosen, they are its lowest m
        for row in gi.numpy():
            for g in set(int(e) // 3 for e in row if e < 3 * (E // 3)):
                got = sorted(int(e) for e in row if int(e) // 3 == g)
                assert got == list(range(3 * g, 3 * g + len(got))), row

    kept_j = _kept(jax_layers._moe_dispatch_compute, xf, np.asarray(jgi), {
        k: np.asarray(v) for k, v in pj.items()}, E, K, C, "jax")
    kept_t = _kept(L._moe_dispatch_compute, xf, gi.numpy(), {
        k: v.numpy() for k, v in pt.items()}, E, K, C, "torch")
    np.testing.assert_array_equal(kept_t, kept_j)
    np.testing.assert_array_equal(kept_t, _kept_loop(gi.numpy(), C))
    if cf == 0.5:
        assert not kept_t.all(), "capacity 0.5 must drop choices"

    out, aux_t = L.moe_block(pt, torch.from_numpy(x), tc)
    jout, jaux = jax_layers.moe_block(pj, jnp.asarray(x), jc)
    assert out.shape == (B, S, D) and out.dtype == torch.float32
    np.testing.assert_allclose(_np(out), _np(jout), atol=MOE_ATOL)
    assert abs(float(aux_t) - float(jaux)) <= AUX_ATOL
    assert float(aux) == float(aux_t)


def test_moe_gate_orders_ties_by_expert_id():
    """Equal probabilities: the lower expert id first, at the top and at
    the K-th place, as jax.lax.top_k orders them."""
    tc = get_smoke_config("olmoe_1b_7b").replace(
        num_experts=6, experts_per_token=3, dtype="float32",
        param_dtype="float32")
    router = torch.zeros(tc.d_model, 6)
    router[0, [4, 1]] = 2.0             # experts 1 and 4 tie at the top
    router[0, [5, 2, 3]] = 1.0          # 2, 3 and 5 tie for the third place
    x = torch.zeros(2, tc.d_model)
    x[:, 0] = 1.0
    _, gi, _ = L.moe_gate({"router": router}, x, tc)
    assert gi.tolist() == [[1, 4, 2], [1, 4, 2]]
    _, jgi = _jax_gate({"router": jnp.asarray(router.numpy())},
                       jnp.asarray(x.numpy()), 3)
    assert np.asarray(jgi).tolist() == gi.tolist()


def _runs_on_meta(fn, *shapes):
    """``fn`` on meta tensors of ``shapes`` (float32): meta tensors hold no
    data, so any step whose shape depends on the data (``nonzero``, a
    boolean mask) or that reads a value (``.item``, ``.tolist``, ``bool``)
    raises."""
    return fn(*(torch.empty(s, device="meta") for s in shapes))


def _meta_moe(x, router, wg, wu, wd, cfg):
    p = {"router": router, "we_gate": wg, "we_up": wu, "we_down": wd}
    return L.moe_block(p, x, cfg)


@pytest.mark.parametrize("B,S", [(8, 1), (4, 37)])
def test_moe_block_has_static_shapes(B, S):
    cfg = get_config("olmoe_1b_7b").replace(d_model=128, d_ff=64)
    E, D, F = cfg.num_experts, cfg.d_model, cfg.d_ff
    out, aux = _runs_on_meta(
        lambda *a: _meta_moe(*a, cfg), (B, S, D), (D, E), (E, D, F),
        (E, D, F), (E, F, D))
    assert out.shape == (B, S, D) and out.device.type == "meta"
    assert aux.shape == ()


@pytest.mark.parametrize("mutation", ["item", "tolist", "nonzero", "mask"])
def test_static_shape_check_catches_a_sync(monkeypatch, mutation):
    """The meta run refuses each way a step could wait for the device: a
    value read (``.item``, ``.tolist``) or a shape that depends on the data
    (``nonzero``, a boolean-mask read)."""
    orig = L.moe_slots

    def synced(eidx, E, C):
        keep, slot = orig(eidx, E, C)
        if mutation == "item":
            C = int(keep.sum().item())
        elif mutation == "tolist":
            slot = torch.tensor(slot.tolist())
        elif mutation == "nonzero":
            keep = keep & (torch.zeros_like(slot).index_fill_(
                0, keep.nonzero()[:, 0], 1) > 0)
        else:
            slot = torch.where(keep, slot, slot[keep].max())
        return keep, slot

    monkeypatch.setattr(L, "moe_slots", synced)
    cfg = get_config("olmoe_1b_7b").replace(d_model=128, d_ff=64)
    E, D, F = cfg.num_experts, cfg.d_model, cfg.d_ff
    with pytest.raises((NotImplementedError, RuntimeError)):
        _runs_on_meta(lambda *a: _meta_moe(*a, cfg), (8, 1, D), (D, E),
                      (E, D, F), (E, D, F), (E, F, D))


# ---------------------------------------------------------------------------
# olmoe and pixtral through prefill and decode
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def olmoe():
    jc, tc = _cfgs("olmoe_1b_7b")
    return (jc, tc) + _params(jc, tc)


@pytest.fixture(scope="module")
def pixtral():
    jc, tc = _cfgs("pixtral_12b")
    return (jc, tc) + _params(jc, tc)


def _batch(tc, rng, B, S, patches):
    b = {"tokens": rng.integers(3, tc.vocab_size, size=(B, S))}
    if patches:
        b["patch_embeds"] = rng.normal(
            size=(B, tc.num_patches, tc.d_model)).astype(np.float32)
    if tc.family == "encdec":
        b["frames"] = rng.normal(
            size=(B, tc.encoder_seq_len, tc.d_model)).astype(np.float32)
    return ({k: jnp.asarray(v) for k, v in b.items()},
            {k: torch.from_numpy(v) for k, v in b.items()})


def _prefill_and_decode(jc, tc, jp, tp, steps, max_len, *, patches=False,
                        B=3, S=9, seed=9):
    """(port, JAX) logits and caches after prefill and each decode step;
    the port's cache is cloned at each step (decode writes in place)."""
    jb, tb = _batch(tc, np.random.default_rng(seed), B, S, patches)
    jm, tm = jax_get_model(jc), get_model(tc)
    jdecode = jax.jit(jm.decode)        # one trace for every step
    jl, jcache = jax.jit(jm.prefill, static_argnums=2)(jp, jb, max_len)
    tl, tcache = tm.prefill(tp, tb, max_len)
    snap = lambda c: {k: v.clone() for k, v in c.items()}
    out = [((tl, snap(tcache)), (jl, jcache))]
    for _ in range(steps):
        nxt = np.asarray(jnp.argmax(jl, axis=-1)).astype(np.int32)
        jl, jcache = jdecode(jp, {"tokens": jnp.asarray(nxt)}, jcache)
        tl, tcache = tm.decode(tp, {"tokens": torch.from_numpy(nxt).long()},
                               tcache)
        out.append(((tl, snap(tcache)), (jl, jcache)))
    return out


def _check_step(t, j, atol=MODEL_ATOL):
    (tl, tcache), (jl, jcache) = t, j
    np.testing.assert_allclose(_np(tl), _np(jl), atol=atol)
    assert set(tcache) == set(jcache)
    for k in tcache:
        if k == "lengths":
            np.testing.assert_array_equal(tcache[k].numpy(),
                                          np.asarray(jcache[k]))
        else:
            assert tcache[k].shape == jcache[k].shape, k
            np.testing.assert_allclose(_np(tcache[k]), _np(jcache[k]),
                                       atol=atol, err_msg=k)


def test_olmoe_prefill_and_decode(olmoe):
    jc, tc, jp, tp = olmoe
    steps = _prefill_and_decode(jc, tc, jp, tp, steps=4, max_len=24)
    for t, j in steps:
        _check_step(t, j)
    assert "moe" in tp["layers"][0] and "mlp" not in tp["layers"][0]


@pytest.mark.parametrize("patches", [True, False],
                         ids=["patches", "tokens-only"])
def test_pixtral_prefill_and_decode(pixtral, patches):
    jc, tc, jp, tp = pixtral
    steps = _prefill_and_decode(jc, tc, jp, tp, steps=4, max_len=24,
                                patches=patches)
    for t, j in steps:
        _check_step(t, j)
    S = 9 + (tc.num_patches if patches else 0)
    assert steps[0][0][1]["lengths"].tolist() == [S] * 3
    assert steps[-1][0][1]["lengths"].tolist() == [S + 4] * 3


@pytest.mark.parametrize("arch", ["olmoe_1b_7b", "pixtral_12b"])
def test_trunk_and_aux(arch):
    jc, tc = _cfgs(arch)
    jp, tp = _params(jc, tc)
    jb, tb = _batch(tc, np.random.default_rng(6), 3, 13, arch == "pixtral_12b")
    x = T._embed_batch(tp, tc, tb)
    jx = jax_transformer._embed_batch(jp, jc, jb)
    np.testing.assert_array_equal(_np(x), _np(jx))
    pos = np.arange(x.shape[1])[None, :]
    h, aux = T.trunk(tp, tc, x, torch.from_numpy(pos))
    wh, waux = jax_transformer.trunk(jp, jc, jx, jnp.asarray(pos))
    np.testing.assert_allclose(_np(h), _np(wh), atol=MODEL_ATOL)
    assert aux.dtype == torch.float32
    assert abs(float(aux) - float(waux)) <= AUX_ATOL * tc.num_layers
    if tc.family == "moe":
        assert float(aux) > 0
    else:
        assert float(aux) == float(waux) == 0.0


# ---------------------------------------------------------------------------
# whisper
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module", params=IMPLS)
def whisper(request):
    jc, tc = _cfgs("whisper_base", request.param)
    return (jc, tc) + _params(jc, tc)


@pytest.mark.parametrize("S,D", [(32, 64), (1500, 512), (32768, 512)])
def test_sinusoidal_positions(S, D):
    got = L.sinusoidal_positions(S, D).numpy()
    want = np.asarray(jax_layers.sinusoidal_positions(S, D))
    assert got.shape == want.shape == (S, D) and got.dtype == np.float32
    excess = np.abs(got - want).max(axis=1) - 1.2e-7 * (np.arange(S) + 1)
    assert excess.max() <= 0, excess.argmax()
    # whisper's table: built once per set of weights, freed with them
    cfg = get_smoke_config("whisper_base").replace(
        d_model=D, max_seq_len=S, dtype="bfloat16")
    params = {"embed": torch.zeros(4, D, dtype=torch.bfloat16)}
    held = len(W._TABLES)
    table = W.position_table(params, cfg, S)
    again = W.position_table(params, cfg, S // 2)
    assert again.data_ptr() == table.data_ptr() and len(again) == S // 2
    assert len(W._TABLES) == held + 1
    assert torch.equal(table, L.sinusoidal_positions(S, D).bfloat16())
    del params
    gc.collect()
    assert len(W._TABLES) == held


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layer_norm(dtype):
    rng = np.random.default_rng(1)
    x = rng.normal(size=(3, 5, 64)).astype(np.float32) * 3 + 1
    g, b = rng.normal(size=64).astype(np.float32), rng.normal(size=64)
    jdt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]
    tdt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]
    xj = jnp.asarray(x, jdt)
    xt = torch.from_numpy(_np(xj).copy()).to(tdt)
    out = L.layer_norm(xt, torch.from_numpy(g), torch.from_numpy(b), 1e-5)
    want = jax_layers.layer_norm(xj, jnp.asarray(g), jnp.asarray(b), 1e-5)
    assert out.dtype == tdt
    np.testing.assert_allclose(_np(out), _np(want),
                               atol={"float32": 2e-5, "bfloat16": 2e-2}[dtype],
                               rtol=1e-2)


def test_cross_attention(whisper):
    jc, tc, jp, tp = whisper
    rng = np.random.default_rng(3)
    enc = rng.normal(size=(2, tc.encoder_seq_len, tc.d_model)).astype(np.float32)
    pj = jax.tree.map(lambda a: a[1], jp["dec_layers"])["cross_attn"]
    pt = tp["dec_layers"][1]["cross_attn"]
    k, v = L.cross_kv(pt, torch.from_numpy(enc), tc)
    jk, jv = jax_layers.cross_kv(pj, jnp.asarray(enc), jc)
    for a, b in ((k, jk), (v, jv)):
        np.testing.assert_allclose(_np(a), _np(b), atol=MODEL_ATOL)
    for shape in ((2, 5, tc.d_model), (2, tc.d_model)):
        x = rng.normal(size=shape).astype(np.float32)
        out = L.cross_attention(pt, torch.from_numpy(x), tc, k, v)
        want = jax_layers.cross_attention(pj, jnp.asarray(x), jc, jk, jv)
        assert out.shape == shape
        np.testing.assert_allclose(_np(out), _np(want), atol=MODEL_ATOL)


def test_whisper_encode(whisper):
    jc, tc, jp, tp = whisper
    jb, tb = _batch(tc, np.random.default_rng(4), 2, 1, False)
    out = W.encode(tp, tc, tb["frames"])
    np.testing.assert_allclose(_np(out), _np(jax_whisper.encode(
        jp, jc, jb["frames"])), atol=MODEL_ATOL)


def test_whisper_prefill_and_decode(whisper):
    jc, tc, jp, tp = whisper
    steps = _prefill_and_decode(jc, tc, jp, tp, steps=4, max_len=16, B=2,
                                S=7)
    for t, j in steps:
        _check_step(t, j)
    cache = steps[-1][0][1]
    H, Dh = tc.num_kv_heads, tc.head_dim
    assert cache["self_k"].shape == (tc.num_layers, 2, 16, H, Dh)
    assert cache["cross_k"].shape == (tc.num_layers, 2, tc.encoder_seq_len,
                                      H, Dh)


# ---------------------------------------------------------------------------
# ModelEncoder, MemForest and the serve engine on olmoe
# ---------------------------------------------------------------------------
TEXTS = ["alice moved to paris in may", "bob's dog is named rex",
         "the meeting moved to thursday at noon", "x", "",
         "carol works at the bakery on elm street since 2019"]


@pytest.fixture(scope="module")
def olmoe_encoders():
    jc, tc = _cfgs("olmoe_1b_7b")
    jp, tp = _params(jc, tc)
    jenc = JaxModelEncoder(jc, jp, JaxTokenizer(jc.vocab_size), max_len=32)
    tenc = ModelEncoder(tc, tp, HashTokenizer(tc.vocab_size), max_len=32)
    return jenc, tenc


def test_olmoe_model_encoder(olmoe_encoders):
    jenc, tenc = olmoe_encoders
    out = tenc.encode(TEXTS)
    want = np.asarray(jenc.encode(TEXTS))
    assert out.shape == want.shape == (len(TEXTS), 64)
    np.testing.assert_allclose(out, want, atol=1e-5)
    seq = tenc.encode(TEXTS[:3], sequential=True)
    np.testing.assert_allclose(seq, np.asarray(
        jenc.encode(TEXTS[:3], sequential=True)), atol=1e-5)
    assert tenc.encode(TEXTS).tobytes() == out.tobytes()


@pytest.mark.parametrize("arch", ["rwkv6_1b6", "zamba2_7b", "whisper_base"])
def test_model_encoder_refuses_other_trunks(arch):
    cfg = get_smoke_config(arch)
    with pytest.raises(ValueError, match="transformer trunk"):
        ModelEncoder(cfg, {"embed": torch.zeros(1)}, HashTokenizer(8))


@pytest.fixture(scope="module")
def olmoe_systems(olmoe_encoders):
    jenc, tenc = olmoe_encoders
    kw = dict(num_entities=4, num_sessions=6, transitions_per_entity=3,
              num_queries=10, seed=0)
    wl_j, wl_t = make_workload(**kw), torch_make_workload(**kw)
    j = JaxSystem(JaxMemForestConfig(embed_dim=64), jenc)
    t = MemForestSystem(MemForestConfig(embed_dim=64), tenc, device="cpu")
    for i in range(0, 6, 3):
        j.ingest_batch(wl_j.sessions[i:i + 3])
        t.ingest_batch(wl_t.sessions[i:i + 3])
    answers = {m: ([(r.answer, r.evidence)
                    for r in j.query_batch(wl_j.queries, mode=m)],
                   [(r.answer, r.evidence)
                    for r in t.query_batch(wl_t.queries, mode=m)])
               for m in MODES}
    return j, t, answers


def test_olmoe_memforest_facts_trees_exact(olmoe_systems):
    j, t, _ = olmoe_systems
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
def test_olmoe_memforest_answers_exact(olmoe_systems, mode):
    _, _, answers = olmoe_systems
    aj, at = answers[mode]
    assert at == aj


def test_olmoe_serve_engines_decode_the_same_tokens():
    """Both engines on olmoe-smoke: four requests into two slots (the
    decode steps run every slot, so a request's routing shares its capacity
    with the other slot's token), a prefix hit, and a request admitted
    while another decodes."""
    jc, tc = _cfgs("olmoe_1b_7b")
    jp, tp = _params(jc, tc)
    je = JaxEngine(jax_get_model(jc), jp, max_batch=2, max_len=48)
    te = ServeEngine(get_model(tc), tp, max_batch=2, max_len=48)
    rng = np.random.default_rng(0)
    prompts = [[int(t) for t in rng.integers(3, 400, size=n)]
               for n in (5, 7, 6)]
    for e in (je, te):
        e.submit(prompts[0], max_new_tokens=5, prefix_key="p")
        e.submit(prompts[1], max_new_tokens=3)
        e.step()
        e.step()
        e.submit(prompts[2], max_new_tokens=4)          # late admission
        e.submit(prompts[0], max_new_tokens=5, prefix_key="p")
    jd, td = je.run_until_drained(), te.run_until_drained()
    out = lambda done: sorted((r.req_id, r.out_tokens) for r in done)
    assert len(te.finished) == 4
    assert out(te.finished) == out(je.finished)
    assert te.metrics()["decoded_tokens"] == je.metrics()["decoded_tokens"]


# ---------------------------------------------------------------------------
# converters, configs, shapes, make_batch
# ---------------------------------------------------------------------------
STACKED = ("layers", "enc_layers", "dec_layers")
TYPES = {jnp.float32: torch.float32, jnp.bfloat16: torch.bfloat16}


def _leaves(tree, path=()):
    """(path, leaf) pairs of a tree of dicts and lists."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (k,))
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _leaves(v, path + (i,))
    else:
        yield path, tree


def _jax_layers(jp):
    """The JAX tree's leaves in the port's layout: a stacked layer axis
    becomes a list index."""
    for path, a in _leaves(jp):
        if path[0] in STACKED:
            for i in range(a.shape[0]):
                yield (path[0], i) + path[1:], a[i]
        else:
            yield path, a


@pytest.mark.parametrize("arch", ["olmoe_1b_7b", "pixtral_12b", "whisper_base"])
def test_converters_keep_each_leaf_type(arch):
    jc = jax_smoke_config(arch)                     # bf16 parameters
    tc = get_smoke_config(arch)
    jp = jax_get_model(jc).init(jax.random.key(1))
    conv = (whisper_params_from_numpy if tc.family == "encdec"
            else transformer_params_from_numpy)
    tp = dict(_leaves(conv(jax.tree.map(np.asarray, jp), tc, device="cpu")))
    want = dict(_jax_layers(jp))
    assert set(tp) == set(want)
    for key, a in want.items():
        t = tp[key]
        assert t.dtype == TYPES[a.dtype.type] and t.shape == a.shape, key
        np.testing.assert_array_equal(_np(t), _np(a))
    if tc.family == "moe":
        assert tp[("layers", 0, "moe", "router")].dtype == torch.float32
        assert tp[("layers", 0, "moe", "we_up")].dtype == torch.bfloat16


@pytest.mark.parametrize("arch", ["olmoe_1b_7b", "pixtral_12b", "whisper_base"])
def test_init_matches_the_reference_layout(arch):
    """The port's own init gives every family the reference's tree: the
    same keys, shapes and types."""
    jp = jax_get_model(jax_smoke_config(arch)).init(jax.random.key(0))
    tp = dict(_leaves(get_model(get_smoke_config(arch)).init(0,
                                                             device="cpu")))
    want = dict(_jax_layers(jp))
    assert set(tp) == set(want)
    for key, a in want.items():
        assert tp[key].dtype == TYPES[a.dtype.type], key
        assert tp[key].shape == a.shape, key


@pytest.mark.parametrize("arch", ARCHS)
def test_full_config_param_count(arch):
    """The port's configs are the reference's: equal fields, equal analytic
    parameter counts, within the ranges tests/test_models.py holds."""
    cfg, ref = get_config(arch), jax_config(arch)
    assert cfg.param_count() == ref.param_count()
    for f in ("name", "family", "num_layers", "d_model", "num_heads",
              "num_kv_heads", "head_dim", "d_ff", "vocab_size", "num_experts",
              "experts_per_token", "moe_capacity_factor", "encoder_layers",
              "encoder_seq_len", "num_patches", "rope_theta", "max_seq_len",
              "mlp_activation", "tie_embeddings", "dtype", "param_dtype"):
        assert getattr(cfg, f) == getattr(ref, f), (arch, f)
    lo, hi = {
        "whisper-base": (60e6, 120e6),
        "qwen3-moe-235b-a22b": (180e9, 280e9),
        "olmoe-1b-7b": (5e9, 9e9),
        "pixtral-12b": (10e9, 14e9),
    }.get(cfg.name, (0, math.inf))
    assert lo <= cfg.param_count() <= hi
    if cfg.family == "moe":
        assert cfg.param_count(active_only=True) == \
            ref.param_count(active_only=True) < cfg.param_count() / 4


@pytest.mark.parametrize("arch", ARCHS)
def test_shapes_match_the_reference(arch):
    cfg, ref = get_config(arch), jax_config(arch)
    assert set(SHAPES) == set(JAX_SHAPES)
    for name, shape in SHAPES.items():
        j = JAX_SHAPES[name]
        assert (shape.seq_len, shape.global_batch, shape.kind,
                shape.is_train) == (j.seq_len, j.global_batch, j.kind,
                                    j.is_train)
        assert shape_applicable(cfg, shape)[0] == jax_applicable(ref, j)[0]
    assert [s.name for s in cells_for_arch(cfg)] == [
        n for n in ("train_4k", "prefill_32k", "decode_32k", "long_500k")
        if jax_applicable(ref, JAX_SHAPES[n])[0]]


@pytest.mark.parametrize("kind", ["prefill", "decode", "train"])
@pytest.mark.parametrize("arch", ["whisper_base", "pixtral_12b", "olmoe_1b_7b"])
def test_make_batch(arch, kind):
    cfg = get_smoke_config(arch)
    a = make_batch(cfg, kind, 3, 10, 5, device="cpu")
    b = make_batch(cfg, kind, 3, 10, 5, device="cpu")
    assert set(a) == set(b) and all(torch.equal(a[k], b[k]) for k in a)
    want = {"tokens": (3,) if kind == "decode" else (3, 10)}
    if kind == "train":
        want["labels"] = (3, 10)
    if cfg.family == "encdec":
        want["frames"] = (3, cfg.encoder_seq_len, cfg.d_model)
    if cfg.family == "vlm":
        want["patch_embeds"] = (3, cfg.num_patches, cfg.d_model)
    assert {k: tuple(v.shape) for k, v in a.items()} == want
    for k in ("tokens", "labels"):
        if k in a:
            assert a[k].dtype == torch.int64
            assert 0 <= int(a[k].min()) and int(a[k].max()) < cfg.vocab_size
    for k in ("frames", "patch_embeds"):
        if k in a:
            assert a[k].dtype == torch.bfloat16
            assert abs(float(a[k].float().std()) - 1.0) < 0.1
    c = make_batch(cfg, kind, 3, 10, 6, device="cpu")
    assert not torch.equal(a["tokens"], c["tokens"])
