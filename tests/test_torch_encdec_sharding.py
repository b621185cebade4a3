"""Whisper (the ``encdec`` family) on the model mesh in the port, against its
unsharded self and the JAX package, on the CPU.

A mesh here names the CPU at every position (``make_mesh(shape, axes,
"cpu")``), so the port's sharded path runs as it runs over one card or
four. Parameters come from each package's init (the JAX ones carried across
by ``whisper_params_from_numpy``), frames, tokens and labels from
``np.random.default_rng``, everything in float32 at whisper-smoke: 2 + 2
layers, d 64, 4 heads of 16, 32 frames, vocab 512, ``tie_embeddings``
False as whisper-base's. Checked:

- The port on a mesh against the port unsharded on (2, 1), (1, 2), (2, 2),
  (1, 4) and (1, 8): the loss within ``REL`` (1e-5) relative, every
  gradient leaf, summed over its holders, within ``GRAD_REL`` (2e-5) of the
  leaf's largest magnitude; a prefill into a 48-row cache and 4 decode
  steps: logits within ``REL`` of their largest magnitude, every cache leaf
  gathered within ``REL``, ``lengths`` exact; three ZeRO-1 steps on (2, 2).
- The port against the JAX package on 4 forced host devices (one
  subprocess for the whole file, which runs this module as ``__main__``):
  the loss (within 1e-3) and every gradient leaf (within ``JAX_REL``, 1e-4,
  of its largest magnitude) against ``jax.value_and_grad`` of the
  reference's loss jitted with ``param_shardings`` on (2, 2) and (1, 4);
  one step of ``build_cell``'s train cell on (2, 2); ``build_cell``'s
  prefill cell and 4 steps of its decode cell on (2, 2) and (1, 4), the
  port's decode starting from the reference's prefill cache placed by
  ``convert.cache_from_numpy``; ``place_cell`` runs each kind of cell.
- The six hazards of whisper on a mesh, each test failing under the wrong
  design it names: (a) the logits are the embedding's transpose on a config
  that does not tie them; (b) an odd vocab leaves the embedding and the
  logits whole; (c) the cross cache splits by heads, else by frames (the
  partials merged by their log-sum-exp), else stays whole; (d) at a width
  past the heads every position computes every head; (e) each device holds
  its own position table, freed with the weights; (f) the frames split
  over the data axes as the tokens do, or are replicated with them.
"""
import gc
import os
import subprocess
import sys
import weakref

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.launch import sharding as jshd
from repro.models import get_model as jax_get_model
from repro_torch.config import ShapeConfig, TrainConfig
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.convert import (cache_from_numpy,
                                 sharded_train_state_from_numpy,
                                 whisper_params_from_numpy)
from repro_torch.launch import dryrun, spmd
from repro_torch.launch.mesh import activate_mesh, make_mesh
from repro_torch.launch.sharding import (Sharded, axes_of, cache_shardings,
                                         gather, gather_tree, param_shardings,
                                         place_tree)
from repro_torch.models import get_model
from repro_torch.models import layers as L
from repro_torch.models import whisper as W
from repro_torch.training import optimizer
from repro_torch.training.train_loop import make_train_step, shard_train_state
from repro_torch.tree import leaves, leaves_with_paths, map_tree, path_str

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
ARCH = "whisper_base"
F32 = dict(dtype="float32", param_dtype="float32")
AXES2 = ("data", "model")
REL = 1e-5          # the port on a mesh against the port unsharded
GRAD_REL = 2e-5     # the same, for a gradient leaf
JAX_REL = 1e-4      # the port against the JAX package's cells
JAX_TOL = 1e-3      # the same: the loss
ZERO1_ATOL = 1e-4   # the ZeRO-1 steps' parameters, sharded against
#                     unsharded: AdamW moves an element whose gradient is
#                     near its eps (1e-8) by up to the learning rate on a
#                     rounding difference
B, S = 4, 16        # the train batch: B rows of S decoder tokens
PROMPT, SMAX, STEPS = 12, 48, 4
SELF_MESHES = ((2, 1), (1, 2), (2, 2), (1, 4), (1, 8))
JAX_MESHES = ((2, 2), (1, 4))


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


def _cfg(**kw):
    return get_smoke_config(ARCH).replace(**F32, **kw)


def _norm(spec):
    out = [tuple(axes_of(e)) for e in spec]
    while out and not out[-1]:
        out.pop()
    return tuple(out)


def _rel(got, want) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _frames(cfg, rng, b):
    return rng.standard_normal((b, cfg.encoder_seq_len, cfg.d_model)
                               ).astype(np.float32)


def _np_batch(cfg, rng, b=B):
    return {"frames": _frames(cfg, rng, b),
            "tokens": rng.integers(0, cfg.vocab_size, (b, S)).astype(np.int32),
            "labels": rng.integers(0, cfg.vocab_size, (b, S)).astype(np.int32)}


def _serve_inputs(cfg, seed=1, b=B):
    rng = np.random.default_rng(seed)
    prompt = {"frames": _frames(cfg, rng, b),
              "tokens": rng.integers(0, cfg.vocab_size, (b, PROMPT)
                                     ).astype(np.int32)}
    steps = [rng.integers(0, cfg.vocab_size, (b,)).astype(np.int32)
             for _ in range(STEPS)]
    return prompt, steps


def _torch_batch(batch):
    return {k: (torch.from_numpy(np.asarray(v)) if k == "frames"
                else torch.from_numpy(np.asarray(v)).long())
            for k, v in batch.items()}


def _long(a):
    return torch.from_numpy(np.asarray(a)).long()


def _placed(params, mesh):
    return place_tree(params, mesh, param_shardings(mesh, params))


# ---------------------------------------------------------------------------
# the port on a mesh against the port unsharded
# ---------------------------------------------------------------------------
def _plain_grads(model, params, batch):
    ps = leaves(params)
    for p in ps:
        p.requires_grad_(True)
    loss, _ = model.loss(params, batch)
    g = torch.autograd.grad(loss, ps)
    for p in ps:
        p.requires_grad_(False)
    return loss.detach(), g


def _sharded_grads(model, params, batch, mesh):
    """(loss, the gradient tree whole, each block summed over its
    holders)."""
    sp = _placed(params, mesh)
    parts = [t for w in leaves(sp) for t in w.parts]
    for t in parts:
        t.requires_grad_(True)
    with activate_mesh(mesh):
        loss, m = model.loss(sp, batch)
    assert torch.equal(m["xent"], loss)
    g = iter(torch.autograd.grad(loss, parts, allow_unused=True,
                                 materialize_grads=True))
    grads = map_tree(lambda w: Sharded(w.mesh, w.spec, w.shape,
                                       [next(g) for _ in w.parts]), sp)
    return loss.detach(), gather_tree(optimizer.reduce_grads(grads))


def _check_grads(cfg, shape, b=B, seed=1):
    model = get_model(cfg)
    params = model.init(0, device="cpu")
    batch = _torch_batch(_np_batch(cfg, np.random.default_rng(seed), b))
    loss0, g0 = _plain_grads(model, params, batch)
    loss, g = _sharded_grads(model, params, batch, cpu_mesh(shape))
    assert abs(float(loss) - float(loss0)) <= REL * abs(float(loss0))
    for (path, got), want in zip(leaves_with_paths(g), g0):
        top = want.abs().max().item()
        assert top > 0, path_str(path)
        err = (got - want).abs().max().item()
        assert err <= GRAD_REL * top, (path_str(path), err, top)


@pytest.mark.parametrize("shape", SELF_MESHES)
def test_sharded_loss_and_gradients_equal_unsharded(shape):
    _check_grads(_cfg(), shape)


def _serve(model, params, prompt, steps, mesh=None):
    """(logits of the prefill and of each step, the final cache whole on
    the CPU, the cache as the run left it)."""
    def whole(lg):
        return gather(lg) if isinstance(lg, Sharded) else lg
    with activate_mesh(mesh):
        lg, cache = model.prefill(params, _torch_batch(prompt), SMAX)
        out = [whole(lg)]
        for t in steps:
            lg, cache = model.decode(params, {"tokens": _long(t)}, cache)
            out.append(whole(lg))
    return out, gather_tree(cache), cache


def _check_serve(cfg, shape, b=B):
    model = get_model(cfg)
    params = model.init(0, device="cpu")
    prompt, steps = _serve_inputs(cfg, b=b)
    want, wcache, _ = _serve(model, params, prompt, steps)
    mesh = cpu_mesh(shape)
    got, gcache, cache = _serve(model, _placed(params, mesh), prompt, steps,
                                mesh)
    for i, (g, w) in enumerate(zip(got, want)):
        assert _rel(g, w) <= REL, (shape, i, _rel(g, w))
    assert set(gcache) == set(wcache)
    for k in wcache:
        assert gcache[k].shape == wcache[k].shape, k
        if k == "lengths":
            assert torch.equal(gcache[k], wcache[k])
            assert (gcache[k] == PROMPT + STEPS).all()
        else:
            assert _rel(gcache[k], wcache[k]) <= REL, (shape, k)
    return cache, wcache


@pytest.mark.parametrize("shape", SELF_MESHES)
def test_sharded_serve_equals_unsharded(shape):
    _check_serve(_cfg(), shape)


def test_zero1_steps_equal_unsharded():
    cfg = _cfg()
    model = get_model(cfg)
    tcfg = TrainConfig(learning_rate=3e-4, warmup_steps=1, total_steps=3)
    rng = np.random.default_rng(2)
    start = {"params": model.init(0, device="cpu")}
    start["opt"] = optimizer.init_opt_state(start["params"])
    mesh = cpu_mesh((2, 2))
    state = shard_train_state(optimizer.clone_tree(start), mesh, cfg)
    plain = optimizer.clone_tree(start)
    step = make_train_step(model, tcfg)
    for i in range(3):
        b = _torch_batch(_np_batch(cfg, rng))
        with activate_mesh(mesh):
            state, m = step(state, b)
        plain, m0 = step(plain, b)
        for k in ("loss", "grad_norm"):
            a, c = float(m[k]), float(m0[k])
            assert abs(a - c) <= REL * abs(c), (i, k, a, c)
    got = gather_tree(state, "cpu")
    perr = max((a - b).abs().max().item() for a, b in zip(
        leaves(got["params"]), leaves(plain["params"])))
    assert perr <= ZERO1_ATOL, perr
    assert int(got["opt"]["step"]) == 3


# ---------------------------------------------------------------------------
# against the JAX package on the same mesh
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
    return _run_jax(tmp_path_factory.mktemp("jax_encdec") / "runs.npz")


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


def _ref_leaf(jtree, path):
    """The reference's leaf for a port path: a list index picks a layer of
    the stacked leaf."""
    node, idx = jtree, None
    for p in path:
        if isinstance(p, int):
            idx = p
        else:
            node = node[p]
    a = np.asarray(node, dtype=np.float32)
    return a if idx is None else a[idx]


def _jax_params(jax_runs, cfg):
    return whisper_params_from_numpy(_tree_of(jax_runs, "init"), cfg,
                                     device="cpu")


@pytest.mark.parametrize("shape", JAX_MESHES)
def test_loss_and_gradients_equal_the_reference(jax_runs, shape):
    cfg = _cfg()
    model = get_model(cfg)
    batch = _torch_batch(_tree_of(jax_runs, "batch"))
    tag = f"{shape[0]}x{shape[1]}"
    loss, g = _sharded_grads(model, _jax_params(jax_runs, cfg), batch,
                             cpu_mesh(shape))
    gap = abs(float(loss) - float(jax_runs[f"{tag}/loss"]))
    jg = _tree_of(jax_runs, f"{tag}/grad")
    worst = 0.0
    for path, got in leaves_with_paths(g):
        rel = _rel(got.numpy(), _ref_leaf(jg, path))
        worst = max(worst, rel)
        assert rel <= JAX_REL, (path_str(path), rel)
    print(f"{tag}: loss gap {gap:.2e}, worst gradient leaf {worst:.2e} of "
          "its largest magnitude")
    assert gap <= JAX_TOL, gap


def test_train_cell_step_equals_the_reference(jax_runs):
    cfg = _cfg()
    tcfg = TrainConfig(learning_rate=3e-4, warmup_steps=1, total_steps=3)
    jstate = {"params": _tree_of(jax_runs, "cell/init/params"),
              "opt": {"m": _tree_of(jax_runs, "cell/init/opt/m"),
                      "v": _tree_of(jax_runs, "cell/init/opt/v"),
                      "step": jax_runs["cell/init/opt/step"]}}
    mesh = cpu_mesh((2, 2))
    state = sharded_train_state_from_numpy(jstate, cfg, mesh)
    cell = dryrun.build_cell(cfg, ShapeConfig("train", seq_len=S,
                                              global_batch=B, kind="train"),
                             mesh, tcfg)
    assert set(cell[1][1]) == {"frames", "tokens", "labels"}
    state, m = cell[0](state, _torch_batch(_tree_of(jax_runs, "batch")))
    for k in ("loss", "grad_norm"):
        a, j = float(m[k]), float(jax_runs[f"cell/{k}"])
        assert abs(a - j) <= JAX_TOL * abs(j), (k, a, j)
    jp = _tree_of(jax_runs, "cell/final")
    got = gather_tree(state["params"], "cpu")
    moved = 0.0
    for path, t in leaves_with_paths(got):
        want = _ref_leaf(jp, path)
        assert np.abs(t.numpy() - want).max() <= ZERO1_ATOL, path_str(path)
        moved = max(moved, np.abs(want - _ref_leaf(jstate["params"],
                                                   path)).max())
    assert moved > 2 * ZERO1_ATOL, moved


@pytest.mark.parametrize("shape", JAX_MESHES)
def test_prefill_and_decode_equal_the_reference_cells(jax_runs, shape):
    cfg = _cfg()
    params = _jax_params(jax_runs, cfg)
    prompt, steps = _serve_inputs(cfg)
    tag = f"{shape[0]}x{shape[1]}"
    mesh = cpu_mesh(shape)
    tcfg = TrainConfig()
    pre, _, pre_sh = dryrun.build_cell(cfg, ShapeConfig(
        "prefill", seq_len=PROMPT, global_batch=B, kind="prefill"), mesh,
        tcfg)
    dec, dec_specs, dec_sh = dryrun.build_cell(cfg, ShapeConfig(
        "decode", seq_len=SMAX, global_batch=B, kind="decode"), mesh, tcfg)
    logits, cache = pre(place_tree(params, mesh, pre_sh[0]),
                        _torch_batch(prompt))
    gaps = [_rel(gather(logits), jax_runs[f"{tag}/prefill/logits"])]
    for k, c in gather_tree(cache).items():
        want = jax_runs[f"{tag}/prefill/cache/{k}"]
        if k == "lengths":
            assert np.array_equal(c.numpy(), want)
        else:
            assert _rel(c, want) <= JAX_REL, k
    # the decode cell from the reference's prefill cache, padded to SMAX
    cache = cache_from_numpy(_tree_of(jax_runs, f"{tag}/padded"), cfg, mesh)
    for k in cache:
        assert _norm(cache[k].spec) == _norm(dec_sh[2][k].spec), k
        assert tuple(cache[k].shape) == tuple(dec_specs[2][k].shape), k
    sp = place_tree(params, mesh, dec_sh[0])
    for i, t in enumerate(steps):
        logits, cache = dec(sp, {"tokens": _long(t)}, cache)
        gaps.append(_rel(gather(logits), jax_runs[f"{tag}/step{i}/logits"]))
        assert np.array_equal(gather(cache["lengths"]).numpy(),
                              jax_runs[f"{tag}/step{i}/lengths"])
    print(f"{tag}: logits against the reference's cells, prefill and "
          f"{STEPS} steps: " + " ".join(f"{g:.2e}" for g in gaps))
    assert max(gaps) <= JAX_REL, gaps


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_place_cell_runs_each_cell(kind):
    cfg = _cfg()
    mesh = cpu_mesh((2, 2))
    shape = ShapeConfig(kind, seq_len=SMAX if kind == "decode" else S,
                        global_batch=B, kind=kind)
    cell = dryrun.build_cell(cfg, shape, mesh, TrainConfig())
    args = dryrun.place_cell(cfg, shape, mesh, cell, seed=3)
    if kind != "decode":
        assert tuple(args[1]["frames"].shape) == (
            B, cfg.encoder_seq_len, cfg.d_model)
    out = cell[0](*args)
    if kind == "train":
        assert np.isfinite(float(out[1]["loss"]))
        assert int(gather(out[0]["opt"]["step"])) == 1
    else:
        logits, cache = out
        assert tuple(logits.shape) == (B, cfg.vocab_size)
        assert bool(torch.isfinite(gather(logits)).all())
        assert set(cache) == set(W._CACHE_LEAVES)


# ---------------------------------------------------------------------------
# the hazards of whisper on a mesh
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("shape", [(2, 2), (1, 4)])
def test_logits_are_the_embeddings_transpose_on_an_untied_config(shape):
    """(a) whisper-base's config says ``tie_embeddings=False`` and its
    parameters hold no ``unembed``: the logits read the embedding's
    transpose. Read through the config, as the transformer families read
    it, they look for the missing ``unembed``."""
    cfg = _cfg()
    assert not cfg.tie_embeddings and not get_config(ARCH).tie_embeddings
    mesh = cpu_mesh(shape)
    sp = _placed(get_model(cfg).init(0, device="cpu"), mesh)
    assert "unembed" not in sp
    hs = [torch.ones(2, cfg.d_model) for _ in range(mesh.size)]
    logits, split = L.logits_shards(sp, cfg, hs, tied=True)
    embed = gather(sp["embed"])
    want = hs[0] @ embed.T
    got = torch.cat(logits[:shape[1]], dim=-1) if split else logits[0]
    assert _rel(got, want) <= REL
    with pytest.raises(KeyError, match="unembed"):
        L.logits_shards(sp, cfg, hs)
    with pytest.raises(KeyError, match="unembed"):
        L.serve_layout(sp, cfg, B, mesh, "a serve call")
    _check_grads(cfg, shape)
    _check_serve(cfg, shape)


@pytest.mark.parametrize("vocab", [512, 515])
def test_an_odd_vocab_leaves_the_embedding_whole(vocab):
    """(b) The rule drops ``model`` from a vocab the width does not divide
    (whisper-base's 51865 at every width): the embedding and the logits are
    whole at every position. 512 divides, so the smoke config alone would
    take only the split path; 515 takes the other."""
    cfg = _cfg(vocab_size=vocab)
    mesh = cpu_mesh((1, 4))
    sp = _placed(get_model(cfg).init(0, device="cpu"), mesh)
    split = "model" in [a for e in sp["embed"].spec for a in axes_of(e)]
    assert split == (vocab % 4 == 0)
    for m in (2, 4, 8, 16):
        spec = param_shardings(make_mesh((1, m), AXES2, "meta"), {
            "embed": torch.empty(51865, 512, device="meta")})["embed"].spec
        assert "model" not in [a for e in spec for a in axes_of(e)], m
    _check_grads(cfg, (1, 4))
    _check_grads(cfg, (2, 2))
    prompt, _ = _serve_inputs(cfg)
    with activate_mesh(mesh):
        logits, _ = get_model(cfg).prefill(sp, _torch_batch(prompt), SMAX)
    assert ("model" in [a for e in logits.spec for a in axes_of(e)]) == split
    _check_serve(cfg, (1, 4))


def _cross_specs(cfg, m):
    mesh = make_mesh((1, m), AXES2, "meta")
    sh = cache_shardings(cfg, mesh, get_model(cfg).cache_specs(8, 64))
    return {k: _norm(sh[k].spec) for k in ("self_k", "cross_k")}


def test_whisper_base_cache_layout_at_each_width():
    """(c) and (d) for whisper-base (8 heads, 1500 frames, a 64-row self
    cache): the cross cache by heads at widths 2, 4 and 8 and whole at 16
    (1500 % 16 != 0); the self cache by heads, then by rows at 16."""
    cfg = get_config(ARCH)
    heads = ((), ("data",), (), ("model",))
    for m in (2, 4, 8):
        assert _cross_specs(cfg, m) == {"self_k": heads, "cross_k": heads}
    assert _cross_specs(cfg, 16) == {
        "self_k": ((), ("data",), ("model",)), "cross_k": ((), ("data",))}
    # the smoke config at (1, 8): 4 heads, 32 frames, both by rows
    rows = ((), ("data",), ("model",))
    assert _cross_specs(_cfg(), 8) == {"self_k": rows, "cross_k": rows}


def test_a_frame_split_cross_cache_merges_by_log_sum_exp():
    """(c) At (1, 8) the smoke config's cross cache is split by frames:
    each position attends over its 4 frames and the partials merge by their
    log-sum-exp in float32. Equal weights for the partials (their mean) are
    another function, far from the unsharded one."""
    cfg = _cfg()
    cache, want = _check_serve(cfg, (1, 8))
    assert _norm(cache["cross_k"].spec) == ((), ("data",), ("model",))
    assert all(p.shape[2] == cfg.encoder_seq_len // 8
               for p in cache["cross_k"].parts)
    model = get_model(cfg)
    params = model.init(0, device="cpu")
    prompt, _ = _serve_inputs(cfg)
    lg0, _ = model.prefill(params, _torch_batch(prompt), SMAX)
    real = L.lse_merge
    try:
        L.lse_merge = lambda parts, lses, mesh, axis="model": spmd.pmean(
            [o.to(torch.float32) for o in parts], mesh, axis)
        mesh = cpu_mesh((1, 8))
        with activate_mesh(mesh):
            lg, _ = model.prefill(_placed(params, mesh),
                                  _torch_batch(prompt), SMAX)
    finally:
        L.lse_merge = real
    assert _rel(gather(lg), lg0) > 1e-3


def test_half_a_head_per_position_computes_every_head():
    """(d) At (1, 8) the smoke config's ``wq`` (64 columns, heads of 16) is
    stored 8 columns a position, half a head; every position then computes
    every head from the all-gathered weights and no head is cut. Loss,
    gradients and serve equal the unsharded run."""
    cfg = _cfg()
    mesh = cpu_mesh((1, 8))
    sp = _placed(get_model(cfg).init(0, device="cpu"), mesh)
    for name in ("self_attn", "cross_attn"):
        wq = sp["dec_layers"][0][name]["wq"]
        assert "model" in axes_of(wq.spec[1])
        assert wq.parts[0].shape[1] * 2 == cfg.head_dim
    assert wq.parts[0].shape[1] == cfg.q_dim // 8
    assert all(L.heads_of(cfg.num_heads, mesh, pos) == (0, cfg.num_heads)
               for pos in range(mesh.size))
    _check_grads(cfg, (1, 8))
    cache, _ = _check_serve(cfg, (1, 8))
    assert _norm(cache["self_k"].spec) == ((), ("data",), ("model",))


def test_position_tables_are_per_device_and_freed_with_the_weights():
    """(e) ``embed`` is a ``Sharded`` on a mesh, which cannot key a weak
    dictionary: each device's table is keyed by the first part of
    ``embed`` on it, so the positions on one device share one table, every
    device gets its own, every table holds the host's bits, and it goes
    with the weights."""
    cfg = _cfg()
    mesh = cpu_mesh((2, 2))
    sp = _placed(get_model(cfg).init(0, device="cpu"), mesh)
    with pytest.raises(TypeError):
        weakref.ref(sp["embed"])
    before = len(W._TABLES)
    tables = W.position_tables(sp["embed"], cfg, cfg.max_seq_len)
    assert len(W._TABLES) == before + 1
    assert all(t.data_ptr() == tables[0].data_ptr() for t in tables)
    want = L.sinusoidal_positions(cfg.max_seq_len, cfg.d_model)
    assert all(torch.equal(t, want) for t in tables)
    assert W.position_tables(sp["embed"], cfg, 8)[0].data_ptr() == \
        tables[0].data_ptr()
    del tables, sp
    gc.collect()
    assert len(W._TABLES) == before
    # parts on two devices (the CPU and ``meta``, which holds no data): a
    # table on each, shared by the positions there
    emb = torch.zeros(cfg.vocab_size, cfg.d_model)
    parts = [emb, emb.clone(), emb.to("meta"), emb.to("meta")]
    two = W.position_tables(Sharded(mesh, (), emb.shape, parts), cfg, 4)
    assert [t.device.type for t in two] == ["cpu", "cpu", "meta", "meta"]
    assert two[0].data_ptr() == two[1].data_ptr()
    assert torch.equal(two[0], want[:4])


@pytest.mark.parametrize("b", [4, 3])
def test_frames_split_over_the_data_axes_as_the_tokens(b):
    """(f) The frames (B, S_enc, D) split over the data axes with the
    tokens: each position's cross cache holds its own rows' frames. A batch
    of 3 does not divide over data = 2, so frames and tokens are both
    replicated, and the cache's batch dim is whole."""
    cfg = _cfg()
    _check_grads(cfg, (2, 2), b=b)
    cache, want = _check_serve(cfg, (2, 2), b=b)
    ck = cache["cross_k"]
    split = b % 2 == 0
    assert ("data" in axes_of(ck.spec[1])) == split
    for pos, part in enumerate(ck.parts):
        assert part.shape[1] == (b // 2 if split else b)
        assert _rel(part, want["cross_k"][ck.region(pos)]) <= REL, pos


# ---------------------------------------------------------------------------
# the subprocess: the JAX package on 4 forced host devices
# ---------------------------------------------------------------------------
def jax_side(out_path) -> None:
    assert len(jax.devices()) == 4, jax.devices()
    from repro.config import ShapeConfig as JaxShape
    from repro.config import TrainConfig as JaxTrainConfig
    from repro.configs import get_smoke_config as jax_smoke
    from repro.launch.dryrun import build_cell
    from repro.launch.mesh import activate_mesh as jax_activate
    from repro.launch.mesh import make_mesh as jax_mesh
    from repro.training.train_loop import init_train_state as jax_init

    out = {}

    def save(prefix, tree):
        flat, _ = jax.tree_util.tree_flatten_with_path(tree)
        for p, leaf in flat:
            out[f"{prefix}/{jshd._path_str(p)}"] = np.asarray(leaf)

    cfg = jax_smoke(ARCH).replace(**F32)
    model = jax_get_model(cfg)
    params = model.init(jax.random.key(0))
    batch = _np_batch(cfg, np.random.default_rng(0))
    save("init", params)
    save("batch", batch)
    prompt, steps = _serve_inputs(cfg)
    for shape in JAX_MESHES:
        mesh = jax_mesh(shape, AXES2)
        tag = f"{shape[0]}x{shape[1]}"
        with jax_activate(mesh):
            psh = jshd.param_shardings(mesh, params)
            bsh = {k: jshd.data_sharding(mesh, v.ndim, v.shape[0])
                   for k, v in batch.items()}
            f = jax.jit(jax.value_and_grad(model.loss, has_aux=True),
                        in_shardings=(psh, bsh))
            (loss, _), g = f(params, batch)
        out[f"{tag}/loss"] = np.asarray(loss)
        save(f"{tag}/grad", g)
        tcfg = JaxTrainConfig()
        pre, _, pre_sh = build_cell(cfg, JaxShape(
            "prefill", seq_len=PROMPT, global_batch=B, kind="prefill"),
            mesh, tcfg)
        dec, _, dec_sh = build_cell(cfg, JaxShape(
            "decode", seq_len=SMAX, global_batch=B, kind="decode"), mesh,
            tcfg)
        with jax_activate(mesh):
            logits, cache = jax.jit(pre, in_shardings=pre_sh)(params, prompt)
            out[f"{tag}/prefill/logits"] = np.asarray(logits)
            save(f"{tag}/prefill/cache", cache)
            pad = SMAX - PROMPT
            cache = {k: (np.pad(np.asarray(c), ((0, 0), (0, 0), (0, pad),
                                                (0, 0), (0, 0)))
                         if k.startswith("self_") else np.asarray(c))
                     for k, c in cache.items()}
            save(f"{tag}/padded", cache)
            step = jax.jit(dec, in_shardings=dec_sh)
            for i, t in enumerate(steps):
                logits, cache = step(params, {"tokens": t}, cache)
                cache = jax.tree.map(np.asarray, cache)
                out[f"{tag}/step{i}/logits"] = np.asarray(logits)
                out[f"{tag}/step{i}/lengths"] = np.asarray(cache["lengths"])
    tcfg = JaxTrainConfig(learning_rate=3e-4, warmup_steps=1, total_steps=3)
    mesh = jax_mesh((2, 2), AXES2)
    step, _, (state_sh, batch_sh) = build_cell(
        cfg, JaxShape("cell", seq_len=S, global_batch=B, kind="train"),
        mesh, tcfg)
    state = jax_init(model, tcfg, jax.random.key(1))
    save("cell/init", state)
    with jax_activate(mesh):
        state, m = jax.jit(step, in_shardings=(state_sh, batch_sh))(
            state, batch)
    out["cell/loss"] = np.asarray(m["loss"])
    out["cell/grad_norm"] = np.asarray(m["grad_norm"])
    save("cell/final", state["params"])
    np.savez(out_path, **out)


if __name__ == "__main__":
    # at the workers' own priority: at a lower one, six busy test workers
    # starve it past the fixture's timeout
    jax_side(sys.argv[1])
