"""Sharded serve on the model mesh in the port against its unsharded self
and the JAX package, on the CPU.

A mesh here names the CPU at every position (``make_mesh(shape, axes,
"cpu")``), so the port's sharded path runs as it runs over one card or
four. Parameters come from each package's init (the JAX ones carried across
by the converters), tokens from ``np.random.default_rng``, everything in
float32 at the smoke configs. Checked:

- (a) The dry run's stand-ins and the cache rule at the published configs
  of all ten ``ARCHS``: ``cache_specs`` at ``decode_32k``'s and
  ``long_500k``'s sizes (the port's ``meta`` tensors against
  ``jax.eval_shape``'s), leaf by leaf in name, shape and type, and each
  leaf's ``cache_shardings`` spec against the reference's on the meshes
  (16, 16), (2, 16, 16), (2, 2), (1, 4) and (4, 1); ``param_specs`` (a
  per-layer leaf against the stacked leaf without its leading dim) and
  ``input_specs`` for every shape.
- (b) The port on a mesh against the port unsharded: prefill into a
  32-row cache, then 4 decode steps with fixed tokens. Logits within 1e-5
  of their largest magnitude (``REL``), the gathered cache too, lengths
  exact: llama3-8b on (2, 2) (the heads form) and (1, 4) (the sequence
  form: the smoke config's 2 KV heads), qwen3-moe-235b on (1, 4) (an MoE
  in the sequence form), olmoe-1b-7b on (1, 2) and (2, 2), pixtral-12b on
  (2, 2) (its patches in S), and a ragged batch of 3 on (2, 2) (replicated
  over ``data``; its rows run past the cache and keep overwriting the last
  one). On (2, 2) the MoE takes its capacity per data shard, as the
  reference's expert-parallel branch does, which is another function where
  choices are dropped: that case raises the capacity factor so that no
  choice is dropped in either run; (c) holds it at the published factor.
- (c) The same runs against the JAX package's ``build_cell`` prefill and
  decode cells, jitted with their shardings on 4 forced host devices, in
  one subprocess for the whole file: the port's own ``build_cell`` cells
  on the same mesh, its decode starting from the reference's prefill cache
  placed by ``cache_from_numpy``. Logits within 1e-4 of their largest
  magnitude (``JAX_REL``), lengths exact. ``place_cell`` runs a train,
  prefill and decode cell.
- (d) ``decode_attention_lse_ref`` against a float64 softmax's log-sum-exp;
  ``layers.lse_merge`` of sequence slices against one
  ``decode_attention_ref`` over the whole cache; a slice with every length
  0 gives zeros and -inf and weighs nothing.
- (e) Parameters or a cache not placed on the active mesh are refused (the
  ``ssm`` and ``hybrid`` families serve on a mesh in
  ``tests/test_torch_ssm_sharding.py``, ``encdec`` in
  ``tests/test_torch_encdec_sharding.py``).
"""
import functools
import os
import subprocess
import sys

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from jax.sharding import AbstractMesh

from repro.configs import get_config as jax_get_config
from repro.configs.shapes import SHAPES as JAX_SHAPES
from repro.models import get_model as jax_get_model
from repro.models.factory import input_specs as jax_input_specs
from repro_torch.config import ShapeConfig, TrainConfig
from repro_torch.configs import ARCHS, get_config, get_smoke_config
from repro_torch.configs.shapes import SHAPES
from repro_torch.convert import (cache_from_numpy,
                                 transformer_params_from_numpy)
from repro_torch.kernels import ref
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import activate_mesh, make_mesh, \
    make_production_mesh
from repro_torch.launch.sharding import (P, Sharded, axes_of, gather,
                                         gather_tree, param_shardings, place,
                                         place_tree)
from repro_torch.models import get_model, input_specs, param_specs
from repro_torch.models import layers as L
from repro_torch.tree import leaves_with_paths

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
F32 = dict(dtype="float32", param_dtype="float32")
AXES2 = ("data", "model")
REL = 1e-5          # the port on a mesh against the port unsharded
JAX_REL = 1e-4      # the port against the JAX package's cells
SMAX, STEPS = 32, 4
RULE_MESHES = {"16x16": ((16, 16), AXES2),
               "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
               "2x2": ((2, 2), AXES2), "1x4": ((1, 4), AXES2),
               "4x1": ((4, 1), AXES2)}
# (tag, arch, mesh shape, batch, prompt tokens, capacity factor or None)
CASES = (("llama_2x2", "llama3_8b", (2, 2), 4, 23, None),
         ("llama_1x4", "llama3_8b", (1, 4), 4, 23, None),
         ("qwen3_1x4", "qwen3_moe_235b", (1, 4), 4, 23, None),
         ("olmoe_1x2", "olmoe_1b_7b", (1, 2), 4, 23, None),
         ("olmoe_2x2", "olmoe_1b_7b", (2, 2), 4, 23, None),
         ("pixtral_2x2", "pixtral_12b", (2, 2), 4, 23, None),
         ("ragged_2x2", "llama3_8b", (2, 2), 3, 30, None))
NO_DROPS = 8.0      # a capacity factor at which no MoE choice is dropped


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """The lockstep runs many small ops a position: one intra-op thread
    keeps them off the thread pool, which several test workers on one
    host would oversubscribe."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def cpu_mesh(shape):
    return make_mesh(shape, AXES2, "cpu")


def _norm(spec):
    """A spec's entries as tuples of axis names, trailing ones dropped."""
    out = [tuple(axes_of(e)) for e in spec]
    while out and not out[-1]:
        out.pop()
    return tuple(out)


def _dtype_name(dt) -> str:
    return str(dt).replace("torch.", "")


@functools.lru_cache(maxsize=None)
def _ref_dryrun():
    """The reference's ``launch/dryrun.py``. It sets XLA_FLAGS for 512 host
    devices when imported: the backend is made first (so this process keeps
    its devices) and the variable is put back after."""
    jax.devices()
    before = os.environ.get("XLA_FLAGS")
    try:
        from repro.launch import dryrun as ref_dryrun
    finally:
        if before is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = before
    return ref_dryrun


def _jax_leaves(tree):
    from repro.launch import sharding as jshd
    flat, _ = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, jax.sharding.NamedSharding))
    return {jshd._path_str(p): leaf for p, leaf in flat}


# ---------------------------------------------------------------------------
# (a) the stand-ins and the cache rule, at the published configs
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("mesh_name", list(RULE_MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_cache_shardings_equal_the_reference(arch, mesh_name):
    rd = _ref_dryrun()
    shape, axes = RULE_MESHES[mesh_name]
    jm = AbstractMesh(shape, axes)
    tm = (make_production_mesh(multi_pod=len(shape) == 3, devices="meta")
          if shape[-1] == 16 else make_mesh(shape, axes, "meta"))
    jcfg, cfg = jax_get_config(arch), get_config(arch)
    for sname in ("decode_32k", "long_500k"):
        B, S = SHAPES[sname].global_batch, SHAPES[sname].seq_len
        jspecs = rd._resize_cache_specs(jcfg, B, S)
        specs = dryrun._resize_cache_specs(cfg, B, S)
        want = _jax_leaves(rd.cache_shardings(jcfg, jm, jspecs))
        got = dict((("/".join(map(str, p))), sh) for p, sh in
                   leaves_with_paths(dryrun.cache_shardings(cfg, tm, specs)))
        assert set(got) == set(want), (arch, sname, sorted(got), sorted(want))
        jleaves = _jax_leaves(jspecs)
        for path, x in leaves_with_paths(specs):
            key = "/".join(map(str, path))
            assert x.device.type == "meta"
            assert tuple(x.shape) == tuple(jleaves[key].shape), (key, x.shape)
            assert _dtype_name(x.dtype) == jleaves[key].dtype.name, key
            assert _norm(got[key].spec) == _norm(want[key].spec), (
                arch, mesh_name, sname, key, got[key].spec, want[key].spec)
    # the structure probe of the reference's default
    assert set(dict((("/".join(map(str, p))), 0) for p, _ in leaves_with_paths(
        dryrun.cache_shardings(cfg, tm)))) == set(_jax_leaves(
            rd.cache_shardings(jcfg, jm)))


@pytest.mark.parametrize("arch", ARCHS)
def test_param_and_input_specs_equal_the_reference(arch):
    jcfg, cfg = jax_get_config(arch), get_config(arch)
    jmodel = jax_get_model(jcfg)
    want = _jax_leaves(jax.eval_shape(jmodel.init, jax.random.key(0)))
    got = param_specs(cfg)
    layers = {}
    for path, x in leaves_with_paths(got):
        assert x.device.type == "meta"
        key = "/".join(str(p) for p in path if not isinstance(p, int))
        w = want[key]
        stacked = any(isinstance(p, int) for p in path)
        wshape = tuple(w.shape[1:]) if stacked else tuple(w.shape)
        assert tuple(x.shape) == wshape, (arch, path, x.shape, w.shape)
        assert _dtype_name(x.dtype) == w.dtype.name, (arch, path)
        if stacked:
            layers[key] = layers.get(key, 0) + 1
    for key, n in layers.items():
        assert want[key].shape[0] == n, (arch, key, n)
    assert {"/".join(str(p) for p in path if not isinstance(p, int))
            for path, _ in leaves_with_paths(got)} == set(want)
    for sname, shape in SHAPES.items():
        jb = jax_input_specs(jcfg, JAX_SHAPES[sname])
        tb = input_specs(cfg, shape)
        assert set(tb) == set(jb), (arch, sname)
        for k, x in tb.items():
            assert x.device.type == "meta"
            assert tuple(x.shape) == tuple(jb[k].shape), (arch, sname, k)
            assert _dtype_name(x.dtype) == jb[k].dtype.name, (arch, sname, k)


# ---------------------------------------------------------------------------
# (b) the port on a mesh against the port unsharded
# ---------------------------------------------------------------------------
def _case_inputs(cfg, B, S, seed=1):
    """(prompt batch, the decode steps' tokens), numpy."""
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (B, S)).astype(
        np.int32)}
    if cfg.family == "vlm":
        batch["patch_embeds"] = rng.normal(
            size=(B, cfg.num_patches, cfg.d_model)).astype(np.float32)
    steps = [rng.integers(0, cfg.vocab_size, (B,)).astype(np.int32)
             for _ in range(STEPS)]
    return batch, steps


def _torch_batch(batch):
    return {k: torch.from_numpy(v).long() if v.dtype == np.int32
            else torch.from_numpy(v) for k, v in batch.items()}


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _serve(model, params, batch, steps, mesh=None):
    """(logits of the prefill and of each step, the final cache), whole on
    the CPU."""
    def whole(lg):
        return gather(lg) if isinstance(lg, Sharded) else lg
    with activate_mesh(mesh):
        lg, cache = model.prefill(params, _torch_batch(batch), SMAX)
        out = [whole(lg)]
        for t in steps:
            lg, cache = model.decode(params, {"tokens": torch.from_numpy(
                t).long()}, cache)
            out.append(whole(lg))
    return out, gather_tree(cache)


@pytest.mark.parametrize("tag,arch,shape,B,S,cf", CASES,
                         ids=[c[0] for c in CASES])
def test_sharded_serve_equals_unsharded(tag, arch, shape, B, S, cf):
    cfg = get_smoke_config(arch).replace(**F32)
    if cfg.family == "moe" and shape[0] > 1:
        cfg = cfg.replace(moe_capacity_factor=NO_DROPS)
    model = get_model(cfg)
    params = model.init(0, device="cpu")
    batch, steps = _case_inputs(cfg, B, S)
    want, wcache = _serve(model, params, batch, steps)
    mesh = cpu_mesh(shape)
    sp = place_tree(params, mesh, param_shardings(
        mesh, params, moe_fsdp=cfg.moe_fsdp_params))
    got, gcache = _serve(model, sp, batch, steps, mesh)
    for i, (g, w) in enumerate(zip(got, want)):
        assert _rel(g, w) <= REL, (tag, i, _rel(g, w))
    for k in ("k", "v"):
        assert gcache[k].shape == wcache[k].shape
        assert _rel(gcache[k], wcache[k]) <= REL, (tag, k)
    assert torch.equal(gcache["lengths"], wcache["lengths"])
    S_total = S + (cfg.num_patches if cfg.family == "vlm" else 0)
    assert (gcache["lengths"] == S_total + STEPS).all()


def test_the_cache_is_laid_out_as_the_rule_says():
    """Each form holds what the rule gives it: the heads form a position's
    KV-head block and every row, the sequence form a position's rows of
    every KV head, the lengths each data shard's rows."""
    cfg = get_smoke_config("llama3_8b").replace(**F32)
    model = get_model(cfg)
    params = model.init(0, device="cpu")
    batch, _ = _case_inputs(cfg, 4, 23)
    for shape, spec, part in (((2, 2), P(None, ("data",), None, "model"),
                               (cfg.num_layers, 2, SMAX, 1, 16)),
                              ((1, 4), P(None, ("data",), "model"),
                               (cfg.num_layers, 4, SMAX // 4, 2, 16))):
        mesh = cpu_mesh(shape)
        sp = place_tree(params, mesh, param_shardings(mesh, params))
        with activate_mesh(mesh):
            logits, cache = model.prefill(sp, _torch_batch(batch), SMAX)
        assert _norm(cache["k"].spec) == _norm(spec)
        assert all(tuple(t.shape) == part for t in cache["k"].parts)
        assert all(t.shape == (4 // shape[0],) for t in cache["lengths"].parts)
        assert logits.shape == (4, cfg.vocab_size)
        assert _norm(logits.spec) == (("data",), ("model",))


# ---------------------------------------------------------------------------
# (c) against the JAX package's build_cell cells on the same mesh
# ---------------------------------------------------------------------------
def _run_jax(out_path):
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(ROOT, "src")
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    env["JAX_PLATFORMS"] = "cpu"
    r = subprocess.run([sys.executable, os.path.abspath(__file__),
                        str(out_path)], capture_output=True, text=True,
                       timeout=600, env=env, cwd=ROOT)
    assert r.returncode == 0, r.stdout[-4000:] + r.stderr[-4000:]
    return dict(np.load(out_path))


@pytest.fixture(scope="module")
def jax_runs(tmp_path_factory):
    return _run_jax(tmp_path_factory.mktemp("jax_serve") / "runs.npz")


def _tree_of(runs, prefix):
    out = {}
    for k, v in runs.items():
        if k.startswith(prefix + "/"):
            node = out
            *dirs, last = k[len(prefix) + 1:].split("/")
            for d in dirs:
                node = node.setdefault(d, {})
            node[last] = v
    return out


def _cells(cfg, mesh, B, S_total):
    tcfg = TrainConfig()
    pre = dryrun.build_cell(cfg, ShapeConfig("prefill", seq_len=S_total,
                                             global_batch=B, kind="prefill"),
                            mesh, tcfg)
    dec = dryrun.build_cell(cfg, ShapeConfig("decode", seq_len=SMAX,
                                             global_batch=B, kind="decode"),
                            mesh, tcfg)
    return pre, dec


@pytest.mark.parametrize("tag,arch,shape,B,S,cf", CASES,
                         ids=[c[0] for c in CASES])
def test_sharded_serve_equals_the_reference_cells(jax_runs, tag, arch, shape,
                                                 B, S, cf):
    cfg = get_smoke_config(arch).replace(**F32)
    model = get_model(cfg)
    jparams = _tree_of(jax_runs, f"{tag}/init")
    params = transformer_params_from_numpy(jparams, cfg, device="cpu")
    batch, steps = _case_inputs(cfg, B, S)
    S_total = S + (cfg.num_patches if cfg.family == "vlm" else 0)
    mesh = cpu_mesh(shape)
    (pre, _, pre_sh), (dec, dec_specs, dec_sh) = _cells(cfg, mesh, B,
                                                        S_total)
    sp = place_tree(params, mesh, pre_sh[0])
    logits, cache = pre(sp, _torch_batch(batch))
    gaps = [_rel(gather(logits), jax_runs[f"{tag}/prefill/logits"])]
    whole = gather_tree(cache)
    for k in ("k", "v"):
        assert _rel(whole[k], jax_runs[f"{tag}/prefill/cache/{k}"]) <= JAX_REL
    assert np.array_equal(whole["lengths"].numpy(),
                          jax_runs[f"{tag}/prefill/cache/lengths"])
    # the decode cell from the reference's prefill cache, padded to SMAX
    jcache = _tree_of(jax_runs, f"{tag}/padded")
    cache = cache_from_numpy(jcache, cfg, mesh)
    assert all(_norm(cache[k].spec) == _norm(dec_sh[2][k].spec)
               for k in cache)
    assert all(tuple(cache[k].shape) == tuple(dec_specs[2][k].shape)
               for k in cache)
    sp = place_tree(params, mesh, dec_sh[0])
    for i, t in enumerate(steps):
        logits, cache = dec(sp, {"tokens": torch.from_numpy(t).long()}, cache)
        gaps.append(_rel(gather(logits), jax_runs[f"{tag}/step{i}/logits"]))
        assert np.array_equal(gather(cache["lengths"]).numpy(),
                              jax_runs[f"{tag}/step{i}/lengths"])
    whole = gather_tree(cache)
    for k in ("k", "v"):
        assert _rel(whole[k], jax_runs[f"{tag}/final/{k}"]) <= JAX_REL, k
    print(f"{tag}: logits against the reference's cells, prefill and "
          f"{STEPS} steps: " + " ".join(f"{g:.2e}" for g in gaps)
          + " of the largest magnitude")
    assert max(gaps) <= JAX_REL, gaps


PLACE_CELLS = [(k, a) for a in ("llama3_8b", "rwkv6_1b6", "zamba2_7b")
               for k in ("train", "prefill", "decode")]


@pytest.mark.parametrize("kind,arch", PLACE_CELLS, ids=[
    k if a == "llama3_8b" else f"{k}-{a}" for k, a in PLACE_CELLS])
def test_place_cell_runs_each_kind_of_cell(kind, arch):
    cfg = get_smoke_config(arch).replace(**F32)
    mesh = cpu_mesh((2, 2))
    shape = ShapeConfig(kind, seq_len=16, global_batch=4, kind=kind)
    tcfg = TrainConfig(learning_rate=1e-3, warmup_steps=1, total_steps=2)
    cell = dryrun.build_cell(cfg, shape, mesh, tcfg)
    args = dryrun.place_cell(cfg, shape, mesh, cell, seed=3, tcfg=tcfg)
    out = cell[0](*args)
    if kind == "train":
        state, metrics = out
        assert np.isfinite(float(metrics["loss"]))
        assert int(gather(state["opt"]["step"])) == 1
        return
    logits, cache = out
    assert logits.shape == (4, cfg.vocab_size)
    assert torch.isfinite(gather(logits)).all()
    want = 16 if kind == "prefill" else 1
    assert (gather(cache["lengths"]) == want).all()
    specs = get_model(cfg).cache_specs(4, 16)
    assert set(cache) == set(specs)
    for k, c in cache.items():
        assert tuple(c.shape) == tuple(specs[k].shape), k


def test_build_cell_refuses_kv_replicate():
    """Cells with ``wk`` and ``wv`` replicated are not ported: asking for
    one raises rather than build a cell that no test holds."""
    cfg = get_smoke_config("llama3_8b").replace(**F32)
    shape = ShapeConfig("decode", seq_len=16, global_batch=4, kind="decode")
    with pytest.raises(NotImplementedError, match="kv_replicate"):
        dryrun.build_cell(cfg, shape, cpu_mesh((1, 4)), TrainConfig(),
                          kv_replicate=True)


# ---------------------------------------------------------------------------
# (d) the log-sum-exp and the merge
# ---------------------------------------------------------------------------
def _decode_inputs(rng, B, Smax, Hq, Hkv, D):
    q = torch.from_numpy(rng.normal(size=(B, Hq, D)).astype(np.float32))
    k = torch.from_numpy(rng.normal(size=(B, Smax, Hkv, D)).astype(
        np.float32))
    v = torch.from_numpy(rng.normal(size=(B, Smax, Hkv, D)).astype(
        np.float32))
    return q, k, v


def test_decode_lse_ref_is_a_float64_softmax_lse():
    rng = np.random.default_rng(5)
    B, Smax, Hq, Hkv, D = 5, 40, 8, 2, 16
    q, k, v = _decode_inputs(rng, B, Smax, Hq, Hkv, D)
    lens = torch.tensor([0, 1, 17, 40, 55], dtype=torch.int32)
    out, lse = ref.decode_attention_lse_ref(q, k, v, lens)
    assert lse.shape == (B, Hq) and lse.dtype == torch.float32
    assert torch.equal(out, ref.decode_attention_ref(q, k, v, lens))
    qd, kd = q.double().numpy(), k.double().numpy()
    for b in range(B):
        n = min(int(lens[b]), Smax)
        for h in range(Hq):
            if n == 0:
                assert lse[b, h] == -np.inf and not out[b, h].any()
                continue
            s = kd[b, :n, h // (Hq // Hkv)] @ qd[b, h] / np.sqrt(D)
            want = (s.max() + np.log(np.exp(s - s.max()).sum())) / np.log(2)
            assert abs(float(lse[b, h]) - want) <= 1e-5, (b, h)
    # float64 inputs compute in float64
    _, lse64 = ref.decode_attention_lse_ref(q.double(), k.double(),
                                            v.double(), lens)
    assert lse64.dtype == torch.float64


@pytest.mark.parametrize("slices", [1, 2, 4, 8])
def test_lse_merge_of_sequence_slices_is_one_decode(slices):
    """The cache cut into ``slices`` runs of rows, each decoded with its
    lengths clamp(lengths - j R, 0, R), the partials merged by
    ``layers.lse_merge`` on a (1, slices) mesh: one ``decode_attention_ref``
    over the whole cache. Length 0, a length inside the first slice only
    (the later slices have no valid row) and one past Smax."""
    rng = np.random.default_rng(slices)
    B, Smax, Hq, Hkv, D = 5, 32, 8, 2, 16
    q, k, v = _decode_inputs(rng, B, Smax, Hq, Hkv, D)
    lens = torch.tensor([0, 3, 17, 32, 40], dtype=torch.int32)
    R = Smax // slices
    parts, lses = [], []
    for j in range(slices):
        n = torch.clamp(lens - j * R, 0, R)
        o, lse = ref.decode_attention_lse_ref(
            q, k[:, j * R:(j + 1) * R].contiguous(),
            v[:, j * R:(j + 1) * R].contiguous(), n)
        assert (lse[n == 0] == -np.inf).all() and not o[n == 0].any()
        parts.append(o)
        lses.append(lse)
    merged = L.lse_merge(parts, lses, cpu_mesh((1, slices)))
    want = ref.decode_attention_ref(q, k, v, lens)
    for m in merged:
        assert (m - want).abs().max() <= 1e-6
        assert not m[0].any()


def test_a_slice_with_no_valid_row_weighs_nothing():
    rng = np.random.default_rng(9)
    q, k, v = _decode_inputs(rng, 3, 16, 4, 2, 16)
    lens = torch.tensor([5, 16, 9], dtype=torch.int32)
    o, lse = ref.decode_attention_lse_ref(q, k, v, lens)
    empty_o, empty_lse = ref.decode_attention_lse_ref(
        q, k, v, torch.zeros(3, dtype=torch.int32))
    assert (empty_lse == -np.inf).all() and not empty_o.any()
    mesh = cpu_mesh((1, 3))
    merged = L.lse_merge([empty_o, o, empty_o], [empty_lse, lse, empty_lse],
                         mesh)
    assert all(torch.equal(m, o) for m in merged)
    none = L.lse_merge([empty_o] * 3, [empty_lse] * 3, mesh)
    assert all(not m.any() and torch.isfinite(m).all() for m in none)


# ---------------------------------------------------------------------------
# (e) what is refused on a mesh
# ---------------------------------------------------------------------------
def test_unplaced_parameters_or_cache_are_refused():
    cfg = get_smoke_config("llama3_8b").replace(**F32)
    model = get_model(cfg)
    params = model.init(0, device="cpu")
    batch = _torch_batch(_case_inputs(cfg, 4, 8)[0])
    mesh, other = cpu_mesh((2, 2)), cpu_mesh((1, 4))
    with activate_mesh(mesh):
        with pytest.raises(ValueError, match="placed on the active mesh"):
            model.prefill(params, batch, 16)
    sp = place_tree(params, mesh, param_shardings(mesh, params))
    with activate_mesh(mesh):
        _, cache = model.prefill(sp, batch, 16)
    tok = {"tokens": torch.zeros(4, dtype=torch.long)}
    with activate_mesh(other):
        with pytest.raises(ValueError, match="placed on the active mesh"):
            model.decode(place_tree(params, other, param_shardings(
                other, params)), tok, cache)
    with activate_mesh(mesh):
        with pytest.raises(ValueError, match="does not|goes over"):
            model.decode(sp, {"tokens": torch.zeros(3, dtype=torch.long)},
                         cache)
        placed = {k: place(gather(c), mesh, P()) for k, c in cache.items()}
        with pytest.raises(ValueError, match="goes over"):
            model.decode(sp, tok, placed)


# ---------------------------------------------------------------------------
# the subprocess: the JAX package on 4 forced host devices
# ---------------------------------------------------------------------------
def jax_side(out_path) -> None:
    assert len(jax.devices()) == 4, jax.devices()
    from repro.config import ShapeConfig as JaxShape
    from repro.config import TrainConfig as JaxTrainConfig
    from repro.configs import get_smoke_config as jax_smoke
    from repro.launch import sharding as jshd
    from repro.launch.dryrun import build_cell
    from repro.launch.mesh import activate_mesh as jax_activate
    from repro.launch.mesh import make_mesh as jax_mesh

    out = {}

    def save(prefix, tree):
        flat, _ = jax.tree_util.tree_flatten_with_path(tree)
        for p, leaf in flat:
            out[f"{prefix}/{jshd._path_str(p)}"] = np.asarray(leaf)

    for tag, arch, shape, B, S, _ in CASES:
        cfg = jax_smoke(arch).replace(**F32)
        model = jax_get_model(cfg)
        params = model.init(jax.random.key(0))
        save(f"{tag}/init", params)
        batch, steps = _case_inputs(cfg, B, S)
        S_total = S + (cfg.num_patches if cfg.family == "vlm" else 0)
        mesh = jax_mesh(shape, AXES2)
        tcfg = JaxTrainConfig()
        pre, _, pre_sh = build_cell(cfg, JaxShape(
            "prefill", seq_len=S_total, global_batch=B, kind="prefill"),
            mesh, tcfg)
        dec, _, dec_sh = build_cell(cfg, JaxShape(
            "decode", seq_len=SMAX, global_batch=B, kind="decode"), mesh,
            tcfg)
        with jax_activate(mesh):
            logits, cache = jax.jit(pre, in_shardings=pre_sh)(params, batch)
            out[f"{tag}/prefill/logits"] = np.asarray(logits)
            save(f"{tag}/prefill/cache", cache)
            pad = SMAX - S_total
            cache = {k: (np.pad(np.asarray(c), ((0, 0), (0, 0), (0, pad),
                                                (0, 0), (0, 0)))
                         if k in ("k", "v") else np.asarray(c))
                     for k, c in cache.items()}
            save(f"{tag}/padded", cache)
            step = jax.jit(dec, in_shardings=dec_sh)
            for i, t in enumerate(steps):
                logits, cache = step(params, {"tokens": t}, cache)
                out[f"{tag}/step{i}/logits"] = np.asarray(logits)
                out[f"{tag}/step{i}/lengths"] = np.asarray(cache["lengths"])
        save(f"{tag}/final", {"k": cache["k"], "v": cache["v"]})
    np.savez(out_path, **out)


if __name__ == "__main__":
    # at the workers' own priority: at a lower one, six busy test workers
    # starve it past the fixture's timeout
    jax_side(sys.argv[1])
