"""Training in the port against the JAX package's, on the CPU.

Inputs and parameters come from numpy with fixed seeds (the parameters from
the JAX init, carried across by the converters) and go to both packages; the
smoke configs run in float32. Checked:

- ``attention_bwd_ref`` (the plain version of ``flash_attention_bwd``)
  against ``jax.vjp`` of ``repro.kernels.ref.attention_ref`` and against
  ``torch.autograd`` of the port's ``attention_ref``, causal and full, groups
  1, 2 and 4, S in {1, 17, 64}, D in {16, 64, 96}: within 1e-5 (float32
  sums in another order). ``FlashAttention``'s plumbing (saved output,
  a non-contiguous output gradient) on CPU tensors.
- ``loss_fn`` and every gradient leaf of six families (llama3: dense,
  olmoe: moe, pixtral: vlm, whisper: encdec, zamba2: hybrid, rwkv6: ssm;
  the last two at S = 128, two chunks of their scans), with and without
  remat: the loss within 1e-5 relative, each gradient leaf within 1e-4 of
  its norm, layer by layer against the reference's stacked leaves.
- ``lr_schedule``, ``clip_by_global_norm`` and ``adamw_update`` on the same
  numpy trees (1e-6 relative: float32 in both); ``compress`` with ``topk``
  (ties planted at the threshold) and ``int8`` over three steps of error
  feedback, the port's per-layer tensors grouped as the reference's stacked
  leaves (1e-6); ``TokenPipeline.batch_at`` array-equal.
- Three whole train steps against ``jax.jit(make_train_step)``, llama3's
  smoke config with microbatch {0, 2} x compression {none, topk, int8},
  zamba2's and rwkv6's without either: loss and ``grad_norm`` within
  1e-4 relative, every parameter within 1e-4 absolute. With int8
  compression a gradient value within float32 noise of a rounding boundary
  can round to the neighbouring level in one package only, and Adam's
  normalised update then moves that parameter by up to the learning rate:
  there every parameter is within the learning rate (1e-3) and at most one
  in a thousand of a leaf beyond 1e-4.
- The JAX package's ``tests/test_training.py`` (seven cases) and
  ``tests/test_fault_tolerance.py`` (four) on the port's modules; the port's
  step updates its state in place, so where a case reuses a state it clones
  it first.
- Checkpoints: a round trip with bf16, float32 and int32 leaves, a torn
  ``.tmp`` that ``restore`` ignores, ``keep`` garbage collection,
  ``train_state_from_numpy``, and the format in both directions: a
  reference-written checkpoint restores in the port, a port-written one in
  the reference, and both write the same manifest and shard payloads.
- ``launch.train.main`` on the CPU, then ``--resume``; ``refuse_grad``;
  ``train_state_specs`` on ``meta``.
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.config import TrainConfig as JaxTrainConfig
from repro.configs import get_smoke_config as jax_smoke_config
from repro.data.pipeline import TokenPipeline as JaxPipeline
from repro.kernels import ref as jax_ref
from repro.models import get_model as jax_get_model
from repro.runtime import checkpoint as jax_ckpt
from repro.training import grad_compress as jax_compress
from repro.training import optimizer as jax_opt
from repro.training.train_loop import init_train_state as jax_init_state
from repro.training.train_loop import make_train_step as jax_make_step
from repro_torch import compression
from repro_torch.config import TrainConfig
from repro_torch.configs import get_smoke_config
from repro_torch.convert import (rwkv6_params_from_numpy,
                                 train_state_from_numpy,
                                 transformer_params_from_numpy,
                                 whisper_params_from_numpy,
                                 zamba2_params_from_numpy)
from repro_torch.core import codec
from repro_torch.data.pipeline import TokenPipeline
from repro_torch.kernels import _build, ref
from repro_torch.kernels.flash_attention import FlashAttention
from repro_torch.launch import train as train_cli
from repro_torch.models import get_model
from repro_torch.runtime import checkpoint as ckpt
from repro_torch.runtime.fault_tolerance import (DEFAULT_LADDER, ElasticScaler,
                                                 FaultTolerantRunner,
                                                 HeartbeatMonitor,
                                                 StragglerMitigator)
from repro_torch.training import grad_compress, optimizer
from repro_torch.training.train_loop import (init_train_state,
                                             make_train_step,
                                             train_state_specs)
from repro_torch.tree import leaves, leaves_with_paths

F32 = dict(dtype="float32", param_dtype="float32")


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().to(torch.float32).numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _ref_leaf(jtree, path):
    """The reference's leaf for a port path: list indices pick a layer of
    the stacked leaf."""
    node, idx = jtree, None
    for p in path:
        if isinstance(p, int):
            idx = p
        else:
            node = node[p]
    a = _np(node)
    return a if idx is None else a[idx]


def _cfgs(arch):
    return (jax_smoke_config(arch).replace(**F32),
            get_smoke_config(arch).replace(**F32))


CONVERTERS = {"encdec": whisper_params_from_numpy,
              "hybrid": zamba2_params_from_numpy,
              "ssm": rwkv6_params_from_numpy}


def _convert(jparams, tc):
    conv = CONVERTERS.get(tc.family, transformer_params_from_numpy)
    return conv(jax.tree.map(np.asarray, jparams), tc, device="cpu")


# ---------------------------------------------------------------------------
# the attention backward's plain version
# ---------------------------------------------------------------------------
def _qkv(rng, B, S, Hq, Hkv, D):
    return [rng.normal(size=(B, S, h, D)).astype(np.float32)
            for h in (Hq, Hkv, Hkv)]


@pytest.mark.parametrize("D", [16, 64, 96])
@pytest.mark.parametrize("S", [1, 17, 64])
@pytest.mark.parametrize("group", [1, 2, 4])
@pytest.mark.parametrize("causal", [True, False])
def test_attention_bwd_ref_matches_jax_vjp(causal, group, S, D):
    rng = np.random.default_rng(S * 1000 + D * 10 + group)
    q, k, v = _qkv(rng, 2, S, 4, 4 // group, D)
    do = rng.normal(size=q.shape).astype(np.float32)
    out, vjp = jax.vjp(lambda a, b, c: jax_ref.attention_ref(
        a, b, c, causal=causal), *(jnp.asarray(x) for x in (q, k, v)))
    want = vjp(jnp.asarray(do))
    tq, tk, tv, tdo = (torch.from_numpy(x) for x in (q, k, v, do))
    o = ref.attention_ref(tq, tk, tv, causal=causal)
    got = ref.attention_bwd_ref(tq, tk, tv, o, tdo, causal=causal)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5,
                                   rtol=0)


@pytest.mark.parametrize("S", [1, 17, 64])
@pytest.mark.parametrize("group", [1, 2, 4])
@pytest.mark.parametrize("causal", [True, False])
def test_attention_bwd_ref_matches_autograd(causal, group, S):
    rng = np.random.default_rng(S * 7 + group)
    q, k, v = (torch.from_numpy(x).requires_grad_()
               for x in _qkv(rng, 2, S, 4, 4 // group, 64))
    o = ref.attention_ref(q, k, v, causal=causal)
    do = torch.from_numpy(rng.normal(size=o.shape).astype(np.float32))
    want = torch.autograd.grad(o, (q, k, v), do)
    got = ref.attention_bwd_ref(q.detach(), k.detach(), v.detach(),
                                o.detach(), do, causal=causal)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, atol=1e-5, rtol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_function_on_cpu_tensors(dtype):
    """The Function's forward saves the output, its backward takes a
    non-contiguous gradient (as the reshape in attention_prefill gives it)
    and returns the plain gradients in the inputs' type."""
    rng = np.random.default_rng(3)
    q, k, v = (torch.from_numpy(x).to(dtype).requires_grad_()
               for x in _qkv(rng, 2, 17, 4, 2, 16))
    out = FlashAttention.apply(q, k, v, True)
    do = torch.from_numpy(rng.normal(size=(2, 4, 17, 16)).astype(np.float32)
                          ).to(dtype).transpose(1, 2)
    assert not do.is_contiguous()
    got = torch.autograd.grad(out, (q, k, v), do)
    want = ref.attention_bwd_ref(q.detach(), k.detach(), v.detach(),
                                 out.detach(), do.contiguous(), causal=True)
    for g, w in zip(got, want):
        assert g.dtype == dtype and torch.equal(g, w)


# ---------------------------------------------------------------------------
# losses and gradients of four families
# ---------------------------------------------------------------------------
FAMILIES = {"dense": "llama3_8b", "moe": "olmoe_1b_7b", "vlm": "pixtral_12b",
            "encdec": "whisper_base", "hybrid": "zamba2_7b",
            "ssm": "rwkv6_1b6"}
# the scan families take two chunks of 64, so the chunk carry is exercised
SCAN_FAMILIES = ("hybrid", "ssm")


def _train_batch(tc, rng, B=2, S=16):
    if tc.family in SCAN_FAMILIES:
        S = 128
    b = {"tokens": rng.integers(3, tc.vocab_size, size=(B, S)).astype(np.int32),
         "labels": rng.integers(3, tc.vocab_size, size=(B, S)).astype(np.int32)}
    if tc.family == "vlm":
        b["patch_embeds"] = rng.normal(
            size=(B, tc.num_patches, tc.d_model)).astype(np.float32)
    if tc.family == "encdec":
        b["frames"] = rng.normal(
            size=(B, tc.encoder_seq_len, tc.d_model)).astype(np.float32)
    return b


@pytest.mark.parametrize("remat", [True, False])
@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_loss_and_gradients_match_jax(family, remat):
    jc, tc = _cfgs(FAMILIES[family])
    jc, tc = jc.replace(remat=remat), tc.replace(remat=remat)
    jm, tm = jax_get_model(jc), get_model(tc)
    jp = jm.init(jax.random.key(1))
    tp = _convert(jp, tc)
    b = _train_batch(tc, np.random.default_rng(11))
    (jl, jmet), jg = jax.value_and_grad(jm.loss, has_aux=True)(
        jp, {k: jnp.asarray(v) for k, v in b.items()})
    ps = leaves(tp)
    for p in ps:
        p.requires_grad_(True)
    tl, tmet = tm.loss(tp, {k: torch.from_numpy(v) for k, v in b.items()})
    tg = torch.autograd.grad(tl, ps)
    assert set(tmet) == set(jmet)
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=1e-5)
    for k in jmet:
        np.testing.assert_allclose(float(tmet[k].detach()), float(jmet[k]),
                                   rtol=1e-5,
                                   atol=1e-7)
    paths = [path for path, _ in leaves_with_paths(tp)]
    assert len(paths) == len(tg)
    for path, g in zip(paths, tg):
        want = _ref_leaf(jg, path)
        assert g.shape == want.shape, path
        tol = 1e-4 * np.linalg.norm(want)
        assert np.abs(g.numpy() - want).max() <= tol, path


# ---------------------------------------------------------------------------
# optimizer, compression, pipeline
# ---------------------------------------------------------------------------
def test_lr_schedule_matches_jax():
    for w, total in ((10, 100), (0, 50), (5, 5)):
        jt = JaxTrainConfig(learning_rate=1e-3, warmup_steps=w,
                            total_steps=total)
        tt = TrainConfig(learning_rate=1e-3, warmup_steps=w,
                         total_steps=total)
        for s in (0, 1, 5, 10, 49, 50, 100, 150):
            want = float(jax_opt.lr_schedule(jnp.asarray(s, jnp.int32), jt))
            got = float(optimizer.lr_schedule(
                torch.tensor(s, dtype=torch.int32), tt))
            np.testing.assert_allclose(got, want, rtol=1e-6)


def _trees(rng, scale=1.0):
    """The same values as a reference tree (layers stacked) and a port
    tree (a list of layers)."""
    w = (rng.normal(size=(2, 8, 6)) * scale).astype(np.float32)
    b = (rng.normal(size=(16,)) * scale).astype(np.float32)
    jt = {"layers": {"w": jnp.asarray(w)}, "b": jnp.asarray(b)}
    tt = {"layers": [{"w": torch.from_numpy(w[i].copy())} for i in range(2)],
          "b": torch.from_numpy(b.copy())}
    return jt, tt


def _same(tt, jt, rtol=1e-6, atol=1e-7):
    for path, leaf in leaves_with_paths(tt):
        np.testing.assert_allclose(_np(leaf), _ref_leaf(jt, path), rtol=rtol,
                                   atol=atol)


def test_clip_by_global_norm_matches_jax():
    rng = np.random.default_rng(0)
    for scale in (0.01, 10.0):
        jt, tt = _trees(rng, scale)
        jc, jn = jax_opt.clip_by_global_norm(jt, 1.0)
        tc, tn = optimizer.clip_by_global_norm(tt, 1.0)
        np.testing.assert_allclose(float(tn), float(jn), rtol=1e-6)
        _same(tc, jc)


def test_adamw_update_matches_jax():
    rng = np.random.default_rng(1)
    jp, tp = _trees(rng)
    cfg = dict(learning_rate=1e-2, warmup_steps=2, total_steps=10)
    jt, tt = JaxTrainConfig(**cfg), TrainConfig(**cfg)
    js, ts = jax_opt.init_opt_state(jp), optimizer.init_opt_state(tp)
    assert ts["step"].dtype == torch.int32
    for _ in range(3):
        jg, tg = _trees(rng)
        jp, js, jm = jax_opt.adamw_update(jp, jg, js, jt)
        tp, ts, tm = optimizer.adamw_update(tp, tg, ts, tt)
        np.testing.assert_allclose(float(tm["lr"]), float(jm["lr"]),
                                   rtol=1e-6)
    assert int(ts["step"]) == int(js["step"]) == 3
    _same(tp, jp)
    _same(ts["m"], js["m"])
    _same(ts["v"], js["v"])


@pytest.mark.parametrize("method", ["topk", "int8"])
def test_compress_matches_jax(method):
    """Three steps of error feedback on the same gradients. The top-k rows
    plant ties at the threshold: 14 equal magnitudes above the rest of the
    96 stacked values, where k is 12, so the 12th largest is one of them
    and all 14 are kept (|g| >= the k-th largest) in both packages."""
    rng = np.random.default_rng(2)
    jg, tg = _trees(rng)
    je = jax_compress.init_error_state(jg)
    te = grad_compress.init_error_state(tg)
    for step in range(3):
        jg, tg = _trees(rng)
        if method == "topk":
            for i in range(14):
                tg["layers"][i % 2]["w"][i // 2, 0] = (-1) ** i * 9.0
            jg = {"layers": {"w": jnp.stack([jnp.asarray(
                tg["layers"][i]["w"].numpy()) for i in range(2)])},
                "b": jg["b"]}
        jc, je, jm = jax_compress.compress(jg, je, method=method, ratio=0.125)
        tc, te, tm = grad_compress.compress(tg, te, method=method, ratio=0.125)
        if method == "topk" and step == 0:
            kept = sum(int((t["w"] != 0).sum()) for t in tc["layers"])
            assert kept == 14 == int((jc["layers"]["w"] != 0).sum())
        np.testing.assert_allclose(float(tm["compress_ratio"]),
                                   float(jm["compress_ratio"]))
        _same(tc, jc, rtol=1e-6, atol=1e-6)
        _same(te, je, rtol=1e-6, atol=1e-6)


def test_compress_none_passes_through():
    _, tg = _trees(np.random.default_rng(4))
    err = grad_compress.init_error_state(tg)
    out, err2, m = grad_compress.compress(tg, err, method="none")
    assert out is tg and err2 is err and float(m["compress_ratio"]) == 1.0


CORPUS = ["Alice moved to Lisbon in May.", "Bob's favourite colour is teal!",
          "The meeting was moved to 3pm, then cancelled."] * 20


@pytest.mark.parametrize("corpus", [None, CORPUS])
@pytest.mark.parametrize("seed", [0, 7])
def test_token_pipeline_batches_equal_the_reference(seed, corpus):
    for dp_rank, dp_size in ((0, 1), (1, 2)):
        kw = dict(vocab_size=512, seq_len=24, global_batch=4, seed=seed,
                  dp_rank=dp_rank, dp_size=dp_size, corpus=corpus)
        jp, tp = JaxPipeline(**kw), TokenPipeline(**kw)
        for step in (0, 1, 5, 1000):
            a, b = jp.batch_at(step), tp.batch_at(step)
            assert sorted(a) == sorted(b)
            for k in a:
                assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k])


# ---------------------------------------------------------------------------
# whole train steps against jax.jit(make_train_step)
# ---------------------------------------------------------------------------
STEP_CASES = [pytest.param("llama3_8b", mb, comp, id=f"{mb}-{comp}")
              for comp in ("none", "topk", "int8") for mb in (0, 2)] + [
    pytest.param(arch, 0, "none", id=arch)
    for arch in ("zamba2_7b", "rwkv6_1b6")]


@pytest.mark.parametrize("arch,microbatch,compress", STEP_CASES)
def test_train_steps_match_jax(arch, microbatch, compress):
    jc, tc = _cfgs(arch)
    kw = dict(learning_rate=1e-3, warmup_steps=2, total_steps=10,
              microbatch_size=microbatch, grad_compression=compress)
    jt, tt = JaxTrainConfig(**kw), TrainConfig(**kw)
    jm, tm = jax_get_model(jc), get_model(tc)
    js = jax_init_state(jm, jt, jax.random.key(0))
    ts = train_state_from_numpy(jax.tree.map(np.asarray, js), tc,
                                device="cpu")
    jstep, tstep = jax.jit(jax_make_step(jm, jt)), make_train_step(tm, tt)
    rng = np.random.default_rng(5)
    for _ in range(3):
        b = _train_batch(tc, rng, B=4, S=32)
        js, jmet = jstep(js, {k: jnp.asarray(v) for k, v in b.items()})
        ts, tmet = tstep(ts, {k: torch.from_numpy(v) for k, v in b.items()})
        assert set(tmet) == set(jmet)
        for k in ("loss", "grad_norm", "lr"):
            np.testing.assert_allclose(float(tmet[k]), float(jmet[k]),
                                       rtol=1e-4)
    assert set(ts) == set(js) and int(ts["opt"]["step"]) == 3
    for path, leaf in leaves_with_paths(ts["params"]):
        assert not leaf.requires_grad
        diff = np.abs(_np(leaf) - _ref_leaf(js["params"], path))
        if compress == "int8":
            assert diff.max() <= tt.learning_rate, path
            assert (diff > 1e-4).mean() <= 1e-3, path
        else:
            assert diff.max() <= 1e-4, path


# ---------------------------------------------------------------------------
# tests/test_training.py's cases on the port
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def setup():
    cfg = get_smoke_config("llama3_8b")
    model = get_model(cfg)
    pipe = TokenPipeline(vocab_size=cfg.vocab_size, seq_len=32,
                         global_batch=4)
    return cfg, model, pipe


def _batch_of(pipe, step):
    return {k: torch.from_numpy(v) for k, v in pipe.batch_at(step).items()}


def test_loss_decreases_on_fixed_batch(setup):
    cfg, model, pipe = setup
    tcfg = TrainConfig(learning_rate=1e-3, total_steps=50, warmup_steps=2)
    state = init_train_state(model, tcfg, 0, device="cpu")
    step = make_train_step(model, tcfg)
    batch = _batch_of(pipe, 0)
    losses = []
    for _ in range(10):
        state, m = step(state, batch)
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0] - 0.5


def test_microbatching_matches_full_batch(setup):
    cfg, model, pipe = setup
    batch = _batch_of(pipe, 1)
    t_full = TrainConfig(learning_rate=1e-3, microbatch_size=0)
    t_micro = TrainConfig(learning_rate=1e-3, microbatch_size=2)
    s0 = init_train_state(model, t_full, 0, device="cpu")
    s1, m1 = make_train_step(model, t_full)(optimizer.clone_tree(s0), batch)
    s2, m2 = make_train_step(model, t_micro)(optimizer.clone_tree(s0), batch)
    np.testing.assert_allclose(float(m1["loss"]), float(m2["loss"]),
                               atol=2e-2, rtol=2e-2)
    w1 = _np(leaves(s1["params"])[0])
    w2 = _np(leaves(s2["params"])[0])
    np.testing.assert_allclose(w1, w2, atol=5e-2, rtol=5e-2)


def test_lr_schedule():
    tcfg = TrainConfig(learning_rate=1e-3, warmup_steps=10, total_steps=100)
    lr0 = float(optimizer.lr_schedule(torch.tensor(0), tcfg))
    lr10 = float(optimizer.lr_schedule(torch.tensor(10), tcfg))
    lr100 = float(optimizer.lr_schedule(torch.tensor(100), tcfg))
    assert lr0 < lr10
    assert abs(lr10 - 1e-3) < 1e-5
    assert lr100 < lr10 * 0.2


def test_grad_clip():
    g = {"w": torch.full((10,), 100.0)}
    clipped, norm = optimizer.clip_by_global_norm(g, 1.0)
    assert float(norm) > 100
    assert abs(float(optimizer.global_norm(clipped)) - 1.0) < 1e-4


def test_topk_compression_error_feedback():
    """Error feedback: the residual stays BOUNDED and the running average of
    compressed grads converges to the true grad (nothing permanently lost)."""
    g = {"w": torch.from_numpy(
        np.random.default_rng(0).normal(size=(64,)).astype(np.float32))}
    err = grad_compress.init_error_state(g)
    total_comp = torch.zeros(64)
    devs = []
    for t in range(1, 121):
        comp, err, _ = grad_compress.compress(g, err, method="topk", ratio=0.1)
        total_comp = total_comp + comp["w"]
        if t in (30, 120):
            devs.append(float(torch.max(torch.abs(total_comp / t - g["w"]))))
    assert float(torch.max(torch.abs(err["w"]))) < 30.0
    assert devs[1] < devs[0] / 2, devs
    assert devs[1] < 0.5


def test_int8_compression_bounded_error():
    g = {"w": torch.from_numpy(
        np.random.default_rng(1).normal(size=(128,)).astype(np.float32))}
    err = grad_compress.init_error_state(g)
    comp, err, m = grad_compress.compress(g, err, method="int8")
    scale = float(torch.max(torch.abs(g["w"]))) / 127
    assert float(torch.max(torch.abs(comp["w"] - g["w"]))) <= scale * 0.51
    assert float(m["compress_ratio"]) == 0.5


def test_compressed_training_still_learns(setup):
    cfg, model, pipe = setup
    tcfg = TrainConfig(learning_rate=1e-3, grad_compression="topk",
                       compression_ratio=0.25)
    state = init_train_state(model, tcfg, 0, device="cpu")
    step = make_train_step(model, tcfg)
    batch = _batch_of(pipe, 0)
    losses = []
    for _ in range(12):
        state, m = step(state, batch)
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0] - 0.3


# ---------------------------------------------------------------------------
# tests/test_fault_tolerance.py's cases on the port
# ---------------------------------------------------------------------------
def test_heartbeat_detection():
    t = [0.0]
    mon = HeartbeatMonitor(["w0", "w1", "w2"], timeout_s=5.0,
                           clock=lambda: t[0])
    t[0] = 3.0
    mon.beat("w0")
    mon.beat("w1")
    t[0] = 7.0
    assert mon.check() == ["w2"]
    assert set(mon.healthy) == {"w0", "w1"}
    mon.beat("w2")
    assert "w2" in mon.failed


def test_straggler_mitigation():
    m = StragglerMitigator(factor=3.0, min_samples=5)
    for i in range(10):
        assert m.check(i, "w0", 1.0) is None
    ev = m.check(10, "w0", 10.0)
    assert ev is not None and ev.action == "backup_dispatched"
    assert len(m.events) == 1


def test_elastic_ladder():
    es = ElasticScaler()
    assert es.ladder == list(DEFAULT_LADDER)
    assert es.pick(512) == (2, 16, 16)
    assert es.pick(511) == (1, 16, 16)
    assert es.pick(128) == (1, 8, 16)
    assert es.pick(63) is None
    shape, axes = es.replan(256)
    assert shape == (16, 16) and axes == ("data", "model")


def test_runner_restart_resumes_from_checkpoint():
    def step_fn(state, batch):
        return state + batch, {"loss": state}

    saved = {}

    def save_fn(s, step):
        saved["s"], saved["step"] = s, step

    def restore_fn():
        return saved["s"], saved["step"]

    batch_fn = lambda step: torch.tensor(float(step))  # noqa: E731
    want = torch.tensor(0.0)
    for step in range(0, 12):
        want, _ = step_fn(want, batch_fn(step))
    runner = FaultTolerantRunner(step_fn, save_fn, restore_fn,
                                 checkpoint_every=4)
    save_fn(torch.tensor(0.0), 0)
    runner.inject_failure(7)
    state, end = runner.run(torch.tensor(0.0), 0, 12, batch_fn)
    assert end == 12 and runner.log.restarts == 1
    assert float(state) == float(want)


def test_runner_restarts_a_train_step_from_a_checkpoint(tmp_path, setup):
    """The runner on the port's train step with ``checkpoint.save`` and
    ``restore``: a failure at step 2 restores step 2's checkpoint and ends
    bitwise equal to an uninterrupted run (the CPU's sums are
    deterministic)."""
    cfg, model, pipe = setup
    tcfg = TrainConfig(learning_rate=1e-3, warmup_steps=2, total_steps=8)
    step = make_train_step(model, tcfg)
    s0 = init_train_state(model, tcfg, 0, device="cpu")
    want = optimizer.clone_tree(s0)
    for i in range(4):
        want, _ = step(want, _batch_of(pipe, i))
    d = str(tmp_path)
    runner = FaultTolerantRunner(
        step, lambda s, i: ckpt.save(d, i, s, extra={"step": i}),
        lambda: (ckpt.restore(d, s0)[0], ckpt.latest_step(d)),
        checkpoint_every=2)
    runner.inject_failure(3)
    state, end = runner.run(optimizer.clone_tree(s0), 0, 4,
                            lambda i: _batch_of(pipe, i))
    assert end == 4 and runner.log.restarts == 1
    for a, b in zip(leaves(state), leaves(want)):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------
def _mixed_tree():
    g = torch.Generator().manual_seed(0)
    return {"params": {"layers": [{"w": torch.randn(3, 5, generator=g)
                                   .to(torch.bfloat16)} for _ in range(2)],
                       "b": torch.randn(7, generator=g)},
            "opt": {"step": torch.tensor(9, dtype=torch.int32)}}


def test_checkpoint_round_trip(tmp_path):
    tree = _mixed_tree()
    path = ckpt.save(str(tmp_path), 12, tree, extra={"step": 12, "a": "x"})
    assert os.path.basename(path) == "step_00000012"
    like = optimizer.clone_tree(tree)
    for t in leaves(like):
        t.zero_()
    out, extra = ckpt.restore(str(tmp_path), like)
    assert extra == {"step": 12, "a": "x"}
    for a, b in zip(leaves(out), leaves(tree)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    with open(os.path.join(path, "manifest.json")) as f:
        paths = [e["path"] for e in json.load(f)["leaves"]]
    assert paths == ["opt/step", "params/b", "params/layers/0/w",
                     "params/layers/1/w"]


def test_restore_ignores_a_torn_tmp_and_keeps_the_newest(tmp_path):
    d = str(tmp_path)
    tree = _mixed_tree()
    for s in (1, 2, 3, 4):
        ckpt.save(d, s, tree, keep=2)
    assert sorted(os.listdir(d)) == ["LATEST", "step_00000003",
                                     "step_00000004"]
    os.makedirs(os.path.join(d, "step_00000005.tmp"))
    assert ckpt.latest_step(d) == 4
    # LATEST pointing at a torn checkpoint falls back to the newest whole one
    ckpt.write_latest(d, "step_00000005")
    assert ckpt.latest_step(d) == 4
    out, _ = ckpt.restore(d, tree)
    assert torch.equal(out["params"]["b"], tree["params"]["b"])


def test_restore_refuses_meta_leaves_and_casts_to_the_leaf_type(tmp_path):
    tree = _mixed_tree()
    ckpt.save(str(tmp_path), 1, tree)
    specs = {"params": {"layers": [{"w": torch.empty(3, 5, device="meta")}
                                   for _ in range(2)],
                        "b": torch.empty(7, device="meta")},
             "opt": {"step": torch.empty((), dtype=torch.int32,
                                         device="meta")}}
    with pytest.raises(ValueError, match="meta"):
        ckpt.restore(str(tmp_path), specs)
    like = {"params": {"layers": [{"w": torch.zeros(3, 5)}
                                  for _ in range(2)],
                       "b": torch.zeros(7)},
            "opt": {"step": torch.zeros((), dtype=torch.int32)}}
    out, _ = ckpt.restore(str(tmp_path), like)
    assert out["params"]["layers"][1]["w"].dtype == torch.float32
    assert torch.equal(out["params"]["layers"][1]["w"],
                       tree["params"]["layers"][1]["w"].float())


def _numpy_tree():
    import ml_dtypes
    rng = np.random.default_rng(3)
    return {"a": rng.normal(size=(3, 4)).astype(np.float32),
            "b": {"c": np.asarray(5, np.int32),
                  "d": rng.normal(size=(2, 3)).astype(ml_dtypes.bfloat16)}}


def _torch_like(tree):
    def conv(a):
        a = np.asarray(a)
        if a.dtype.name == "bfloat16":
            return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
        return torch.from_numpy(a.copy())
    return {"a": conv(tree["a"]), "b": {"c": conv(tree["b"]["c"]),
                                        "d": conv(tree["b"]["d"])}}


def test_reference_checkpoint_restores_in_the_port(tmp_path):
    tree = _numpy_tree()
    jax_ckpt.save(str(tmp_path), 3, tree, extra={"step": 3})
    like = {k: (torch.zeros_like(v) if isinstance(v, torch.Tensor) else
                {kk: torch.zeros_like(vv) for kk, vv in v.items()})
            for k, v in _torch_like(tree).items()}
    out, extra = ckpt.restore(str(tmp_path), like)
    assert extra == {"step": 3}
    for a, b in zip(leaves(out), leaves(_torch_like(tree))):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_port_checkpoint_restores_in_the_reference(tmp_path):
    tree = _numpy_tree()
    ckpt.save(str(tmp_path), 4, _torch_like(tree), extra={"step": 4})
    out, extra = jax_ckpt.restore(str(tmp_path), tree)
    assert extra == {"step": 4}
    for a, b in zip(jax.tree.leaves(out), jax.tree.leaves(tree)):
        assert np.asarray(a).dtype == b.dtype
        assert np.asarray(a).tobytes() == np.asarray(b).tobytes()


def test_both_packages_write_the_same_files(tmp_path):
    """Manifest and decompressed shard payloads byte for byte (the
    compressed bytes depend on the codec the machine has)."""
    tree = _numpy_tree()
    a = jax_ckpt.save(str(tmp_path / "ref"), 2, tree, extra={"x": 1})
    b = ckpt.save(str(tmp_path / "port"), 2, _torch_like(tree),
                  extra={"x": 1})
    with open(os.path.join(a, "manifest.json")) as fa, \
            open(os.path.join(b, "manifest.json")) as fb:
        assert json.load(fa) == json.load(fb)
    for name in sorted(os.listdir(a)):
        if name.startswith("shard_"):
            with open(os.path.join(a, name), "rb") as fa, \
                    open(os.path.join(b, name), "rb") as fb:
                pa = compression.decompress(fa.read())
                pb = compression.decompress(fb.read())
            assert pa == pb
            assert codec.unpackb(pb)[0][0] == "a"


def test_train_state_from_numpy_matches_the_reference_state():
    jc, tc = _cfgs("olmoe_1b_7b")
    jt = JaxTrainConfig(grad_compression="int8")
    js = jax_init_state(jax_get_model(jc), jt, jax.random.key(2))
    js["opt"]["m"] = jax.tree.map(lambda x: x + 0.5, js["opt"]["m"])
    js["opt"]["step"] = jnp.asarray(7, jnp.int32)
    ts = train_state_from_numpy(jax.tree.map(np.asarray, js), tc,
                                device="cpu")
    assert set(ts) == {"params", "opt", "err"}
    assert ts["opt"]["step"].dtype == torch.int32 and int(
        ts["opt"]["step"]) == 7
    for part in (("params",), ("opt", "m"), ("opt", "v"), ("err",)):
        t, j = ts, js
        for p in part:
            t, j = t[p], j[p]
        for path, leaf in leaves_with_paths(t):
            np.testing.assert_array_equal(_np(leaf), _ref_leaf(j, path))
    router = ts["opt"]["m"]["layers"][0]["moe"]["router"]
    assert router.dtype == torch.float32


def test_train_state_specs_allocate_nothing():
    cfg = get_smoke_config("llama3_8b")
    tcfg = TrainConfig(grad_compression="topk")
    specs = train_state_specs(get_model(cfg), tcfg)
    real = init_train_state(get_model(cfg), tcfg, 0, device="cpu")
    assert [p for p, _ in leaves_with_paths(specs)] == [
        p for p, _ in leaves_with_paths(real)]
    for s, r in zip(leaves(specs), leaves(real)):
        assert s.device.type == "meta" and s.shape == r.shape
        assert s.dtype == r.dtype


# ---------------------------------------------------------------------------
# the driver, the guard
# ---------------------------------------------------------------------------
def test_train_driver_runs_and_resumes(tmp_path, capsys):
    args = ["--device", "cpu", "--seq", "16", "--batch", "4", "--log-every",
            "1", "--ckpt-every", "2", "--ckpt-dir", str(tmp_path)]
    assert train_cli.main(args + ["--steps", "3"]) == 0
    first = capsys.readouterr().out
    assert ckpt.latest_step(str(tmp_path)) == 2
    assert train_cli.main(args + ["--steps", "4", "--resume"]) == 0
    second = capsys.readouterr().out
    assert "resumed from step 2" in second

    def loss_at(out, step):
        line = next(ln for ln in out.splitlines()
                    if ln.startswith(f"step {step:5d}"))
        return line.split()[3]
    assert loss_at(first, 2) == loss_at(second, 2)
    assert ckpt.latest_step(str(tmp_path)) == 4


def test_refuse_grad_raises_for_inputs_that_require_grad():
    x = torch.zeros(3, requires_grad=True)
    with pytest.raises(RuntimeError, match="no backward kernel"):
        _build.refuse_grad("mamba2_ssd", torch.zeros(2), x)
    with torch.no_grad():
        _build.refuse_grad("mamba2_ssd", torch.zeros(2), x)
    _build.refuse_grad("mamba2_ssd", torch.zeros(2), x.detach())
