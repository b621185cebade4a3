"""The ssm and hybrid families on the model mesh in the port, against its
unsharded self and the JAX package, on the CPU.

A mesh here names the CPU at every position (``make_mesh(shape, axes,
"cpu")``), so the port's sharded path runs as it runs over one card or
four. Parameters come from each package's init (the JAX ones carried across
by the converters), tokens and labels from ``np.random.default_rng``,
everything in float32 at the smoke configs: rwkv6-smoke (4 heads of 16) and
zamba2-smoke (8 Mamba2 heads of 16, 5 layers: two groups of two and one
remainder layer, the shared block's 4 attention heads). Checked:

- (a) The port on a mesh against the port unsharded: rwkv6 and zamba2 on
  (2, 1), (1, 2), (2, 2) and (1, 4), rwkv6 also on (1, 8), where the model
  width divides the columns of ``wr`` but not the 4 heads, so that every
  position computes every head. The loss within ``REL`` (1e-5) relative,
  every gradient leaf, summed over its holders, within ``GRAD_REL`` (2e-5)
  of the leaf's largest magnitude; a prefill into a 96-row cache and 4
  decode steps: logits within ``REL`` of their largest magnitude, every
  cache leaf gathered within ``REL``, ``lengths`` exact. Three ZeRO-1 steps
  of zamba2 on (2, 2) against the unsharded step: the loss and
  ``grad_norm`` within ``REL`` relative, the parameters within
  ``ZERO1_ATOL``.
- (b) The port against the JAX package on 4 forced host devices (one
  subprocess for the whole file, which runs this module as ``__main__``),
  on (2, 2) and (1, 4): the loss (within 1e-3) and every gradient leaf
  (within ``JAX_REL``, 1e-4, of its largest magnitude) against
  ``jax.value_and_grad`` of the reference's loss jitted with
  ``param_shardings``; one step of ``build_cell``'s train cell on (2, 2)
  (the loss and ``grad_norm`` within 1e-3, the parameters within
  ``ZERO1_ATOL``);
  ``build_cell``'s prefill cell and 4 steps of its decode cell (logits
  within ``JAX_REL``, ``lengths`` exact), the port's decode starting from
  the reference's prefill cache placed by ``convert.cache_from_numpy``.
- (c) The four hazards of Mamba2 on a mesh, each test failing under the
  wrong design it names: ``norm_g`` normalises the whole d_inner, not each
  position's block; the conv state is whole and equal at every model
  position after a prefill and after each decode step; dB and dC reach
  the owners of B's and C's columns of ``w_in`` summed over the positions;
  ``w_in``'s blocks are not the positions' heads.
- (d) ``cache_shardings`` lays the sharded prefill's cache out as the rule
  says, leaf by leaf, every part the block of its region.

The gradients: a float32 run and another order of the same sums differ by
up to about 1e-5 of the largest magnitude in the leaves that sum over the
batch and the time with cancellation (rwkv6's ``u``, mamba2's ``A_log``);
splitting the batch alone, on (2, 1), gives 6e-6. Run in float64, the
sharded and unsharded gradients agree within 3e-7 (the cross-entropy
computes in float32), so ``GRAD_REL`` is 2e-5.
"""
import os
import subprocess
import sys

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.launch import sharding as jshd
from repro.models import get_model as jax_get_model
from repro_torch.config import ShapeConfig, TrainConfig
from repro_torch.configs import get_smoke_config
from repro_torch.convert import (cache_from_numpy, rwkv6_params_from_numpy,
                                 sharded_train_state_from_numpy,
                                 zamba2_params_from_numpy)
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import activate_mesh, make_mesh
from repro_torch.launch.sharding import (Sharded, axes_of, cache_shardings,
                                         gather, gather_tree, param_shardings,
                                         place_tree)
from repro_torch.models import get_model
from repro_torch.models import layers as L
from repro_torch.models import mamba2 as M
from repro_torch.training import optimizer
from repro_torch.training.train_loop import make_train_step, shard_train_state
from repro_torch.tree import leaves, leaves_with_paths, map_tree, path_str

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
F32 = dict(dtype="float32", param_dtype="float32")
AXES2 = ("data", "model")
REL = 1e-5          # the port on a mesh against the port unsharded
GRAD_REL = 2e-5     # the same, for a gradient leaf (see the docstring)
JAX_REL = 1e-4      # the port against the JAX package's cells
JAX_TOL = 1e-3      # the same: the loss
ZERO1_ATOL = 1e-4   # the ZeRO-1 steps' parameters, sharded against
#                     unsharded: AdamW moves an element whose gradient is
#                     near its eps (1e-8) by up to the learning rate on a
#                     rounding difference (5.2e-5 after three steps here);
#                     a missing or misplaced update moves 3e-4 a step
B, S = 4, 32        # the train batch
PROMPT, SMAX, STEPS = 23, 96, 4
ARCHS = ("rwkv6_1b6", "zamba2_7b")
SELF_CASES = ([("rwkv6_1b6", s) for s in ((2, 1), (1, 2), (2, 2), (1, 4),
                                           (1, 8))]
              + [("zamba2_7b", s) for s in ((2, 1), (1, 2), (2, 2), (1, 4))])
JAX_MESHES = ((2, 2), (1, 4))
CONVERT = {"rwkv6_1b6": rwkv6_params_from_numpy,
           "zamba2_7b": zamba2_params_from_numpy}


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


def _cfg(arch):
    return get_smoke_config(arch).replace(**F32)


def _norm(spec):
    out = [tuple(axes_of(e)) for e in spec]
    while out and not out[-1]:
        out.pop()
    return tuple(out)


def _rel(got, want) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _np_batch(vocab, rng):
    return {"tokens": rng.integers(0, vocab, (B, S)).astype(np.int32),
            "labels": rng.integers(0, vocab, (B, S)).astype(np.int32)}


def _serve_inputs(cfg, seed=1):
    rng = np.random.default_rng(seed)
    prompt = rng.integers(0, cfg.vocab_size, (B, PROMPT)).astype(np.int32)
    steps = [rng.integers(0, cfg.vocab_size, (B,)).astype(np.int32)
             for _ in range(STEPS)]
    return prompt, steps


def _long(a):
    return torch.from_numpy(np.asarray(a)).long()


def _placed(params, mesh):
    return place_tree(params, mesh, param_shardings(mesh, params))


# ---------------------------------------------------------------------------
# (a) the port on a mesh against the port unsharded
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


def _torch_batch(batch):
    return {k: _long(v) for k, v in batch.items()}


@pytest.mark.parametrize("arch,shape", SELF_CASES)
def test_sharded_loss_and_gradients_equal_unsharded(arch, shape):
    cfg = _cfg(arch)
    model = get_model(cfg)
    params = model.init(0, device="cpu")
    batch = _torch_batch(_np_batch(cfg.vocab_size, np.random.default_rng(1)))
    loss0, g0 = _plain_grads(model, params, batch)
    loss, g = _sharded_grads(model, params, batch, cpu_mesh(shape))
    assert abs(float(loss) - float(loss0)) <= REL * abs(float(loss0))
    for (path, got), want in zip(leaves_with_paths(g), g0):
        top = want.abs().max().item()
        assert top > 0, path_str(path)
        err = (got - want).abs().max().item()
        assert err <= GRAD_REL * top, (path_str(path), err, top)


def _serve(model, params, prompt, steps, mesh=None):
    """(logits of the prefill and of each step, the final cache), whole on
    the CPU, and the cache as the run left it."""
    def whole(lg):
        return gather(lg) if isinstance(lg, Sharded) else lg
    with activate_mesh(mesh):
        lg, cache = model.prefill(params, {"tokens": _long(prompt)}, SMAX)
        out = [whole(lg)]
        for t in steps:
            lg, cache = model.decode(params, {"tokens": _long(t)}, cache)
            out.append(whole(lg))
    return out, gather_tree(cache), cache


@pytest.mark.parametrize("arch,shape", SELF_CASES)
def test_sharded_serve_equals_unsharded(arch, shape):
    cfg = _cfg(arch)
    model = get_model(cfg)
    params = model.init(0, device="cpu")
    prompt, steps = _serve_inputs(cfg)
    want, wcache, _ = _serve(model, params, prompt, steps)
    mesh = cpu_mesh(shape)
    got, gcache, _ = _serve(model, _placed(params, mesh), prompt, steps, mesh)
    for i, (g, w) in enumerate(zip(got, want)):
        assert _rel(g, w) <= REL, (arch, shape, i, _rel(g, w))
    assert set(gcache) == set(wcache)
    for k in wcache:
        assert gcache[k].shape == wcache[k].shape, k
        if k == "lengths":
            assert torch.equal(gcache[k], wcache[k])
            assert (gcache[k] == PROMPT + STEPS).all()
        else:
            assert _rel(gcache[k], wcache[k]) <= REL, (arch, shape, k)


def test_zero1_steps_of_zamba2_equal_unsharded():
    cfg = _cfg("zamba2_7b")
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
        b = _torch_batch(_np_batch(cfg.vocab_size, rng))
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
# (b) against the JAX package on the same mesh
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
    return _run_jax(tmp_path_factory.mktemp("jax_ssm") / "runs.npz")


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


@pytest.mark.parametrize("shape", JAX_MESHES)
@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_gradients_equal_the_reference(jax_runs, arch, shape):
    cfg = _cfg(arch)
    model = get_model(cfg)
    params = CONVERT[arch](_tree_of(jax_runs, f"{arch}/init"), cfg,
                           device="cpu")
    batch = _torch_batch(_tree_of(jax_runs, f"{arch}/batch"))
    tag = f"{arch}/{shape[0]}x{shape[1]}"
    loss, g = _sharded_grads(model, params, batch, cpu_mesh(shape))
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


@pytest.mark.parametrize("arch", ARCHS)
def test_train_cell_step_equals_the_reference(jax_runs, arch):
    cfg = _cfg(arch)
    model = get_model(cfg)
    tcfg = TrainConfig(learning_rate=3e-4, warmup_steps=1, total_steps=3)
    jstate = {"params": _tree_of(jax_runs, f"{arch}/cell/init/params"),
              "opt": {"m": _tree_of(jax_runs, f"{arch}/cell/init/opt/m"),
                      "v": _tree_of(jax_runs, f"{arch}/cell/init/opt/v"),
                      "step": jax_runs[f"{arch}/cell/init/opt/step"]}}
    mesh = cpu_mesh((2, 2))
    state = sharded_train_state_from_numpy(jstate, cfg, mesh)
    cell = dryrun.build_cell(cfg, ShapeConfig("train", seq_len=S,
                                              global_batch=B, kind="train"),
                             mesh, tcfg)
    state, m = cell[0](state, _torch_batch(_tree_of(jax_runs,
                                                    f"{arch}/batch")))
    for k in ("loss", "grad_norm"):
        a, j = float(m[k]), float(jax_runs[f"{arch}/cell/{k}"])
        assert abs(a - j) <= JAX_TOL * abs(j), (k, a, j)
    jp = _tree_of(jax_runs, f"{arch}/cell/final")
    got = gather_tree(state["params"], "cpu")
    moved = 0.0
    for path, t in leaves_with_paths(got):
        want = _ref_leaf(jp, path)
        assert np.abs(t.numpy() - want).max() <= ZERO1_ATOL, path_str(path)
        moved = max(moved, np.abs(want - _ref_leaf(jstate["params"],
                                                   path)).max())
    assert moved > 2 * ZERO1_ATOL, moved


@pytest.mark.parametrize("shape", JAX_MESHES)
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_equal_the_reference_cells(jax_runs, arch, shape):
    cfg = _cfg(arch)
    params = CONVERT[arch](_tree_of(jax_runs, f"{arch}/init"), cfg,
                           device="cpu")
    prompt, steps = _serve_inputs(cfg)
    tag = f"{arch}/{shape[0]}x{shape[1]}"
    mesh = cpu_mesh(shape)
    tcfg = TrainConfig()
    pre, _, pre_sh = dryrun.build_cell(cfg, ShapeConfig(
        "prefill", seq_len=PROMPT, global_batch=B, kind="prefill"), mesh,
        tcfg)
    dec, dec_specs, dec_sh = dryrun.build_cell(cfg, ShapeConfig(
        "decode", seq_len=SMAX, global_batch=B, kind="decode"), mesh, tcfg)
    logits, cache = pre(place_tree(params, mesh, pre_sh[0]),
                        {"tokens": _long(prompt)})
    gaps = [_rel(gather(logits), jax_runs[f"{tag}/prefill/logits"])]
    whole = gather_tree(cache)
    for k, c in whole.items():
        want = jax_runs[f"{tag}/prefill/cache/{k}"]
        if k == "lengths":
            assert np.array_equal(c.numpy(), want)
        else:
            assert _rel(c[:, :, :PROMPT] if k.startswith("kv_") else c,
                        want) <= JAX_REL, k
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


# ---------------------------------------------------------------------------
# (c) the hazards of Mamba2 on a mesh
# ---------------------------------------------------------------------------
def _mamba_layer(cfg, mesh, seed=3):
    """One Mamba2 layer's parameters (random gains and conv bias, so that
    every leaf shows), unsharded and placed, and an input (B, T, D); the x
    columns of ``w_in``'s first half of the heads are scaled by 10, so that
    the heads' sums of squares differ about 100x between the halves."""
    gen = torch.Generator().manual_seed(seed)
    p = M.mamba2_init(gen, cfg, torch.float32)
    p["norm_g"] = 1.0 + torch.rand(p["norm_g"].shape, generator=gen)
    p["conv_b"] = 0.1 * torch.randn(p["conv_b"].shape, generator=gen)
    p["D_skip"] = torch.randn(p["D_skip"].shape, generator=gen)
    Din = cfg.d_inner
    scale = torch.ones(2 * Din + 2 * cfg.ssm_state_dim
                       + Din // cfg.ssm_head_dim)
    scale[Din:Din + Din // 2] = 10.0       # the first half's x: the heads
    p["w_in"] = p["w_in"] * scale          # of model position 0 at width 2
    x = torch.randn((B, S, cfg.d_model), generator=gen)
    return p, place_tree(p, mesh, param_shardings(mesh, p)), x


def _seq(cfg, mesh, sp, x):
    """``mamba2_seq_shards`` from zero states at every position."""
    _, H, P_, conv_dim = M.mamba2_dims(cfg)
    n = L.heads_of(H, mesh, 0)[1]
    dp = mesh.shape["data"]
    xs = [x[mesh.coord(pos, "data") * (B // dp):][:B // dp]
          for pos in range(mesh.size)]
    ssd = [torch.zeros(B // dp, n, P_, cfg.ssm_state_dim) for _ in xs]
    conv = [torch.zeros(B // dp, cfg.ssm_conv_width - 1, conv_dim)
            for _ in xs]
    return xs, M.mamba2_seq_shards(sp, xs, cfg, mesh, ssd, conv)


def _plain_seq(cfg, p, x):
    _, H, P_, conv_dim = M.mamba2_dims(cfg)
    return M.mamba2_seq(p, x, cfg,
                        torch.zeros(B, H, P_, cfg.ssm_state_dim),
                        torch.zeros(B, cfg.ssm_conv_width - 1, conv_dim))


@pytest.mark.parametrize("shape", [(1, 2), (2, 2), (1, 4)])
def test_norm_g_normalises_the_whole_d_inner(shape):
    """The gated norm's sum of squares runs over all of d_inner: each
    position's block is scaled by the whole row's mean square. With the
    halves' sums of squares about 100x apart, a norm over each position's
    block alone is another function, far from the unsharded one."""
    cfg = _cfg("zamba2_7b")
    mesh = cpu_mesh(shape)
    p, sp, x = _mamba_layer(cfg, mesh)
    want = _plain_seq(cfg, p, x)[0]
    xs, (out, _, _) = _seq(cfg, mesh, sp, x)
    dp = mesh.shape["data"]
    for pos, o in enumerate(out):
        b0 = mesh.coord(pos, "data") * (B // dp)
        assert _rel(o, want[b0:b0 + B // dp]) <= REL, pos
    # the per-block norm, as a check that the input tells the two apart
    real = L.rms_norm_shards
    try:
        L.rms_norm_shards = lambda ys, gs, eps, dim, mesh, split: [
            L.rms_norm(y, g, eps) for y, g in zip(ys, gs)]
        wrong = _seq(cfg, mesh, sp, x)[1][0]
    finally:
        L.rms_norm_shards = real
    assert _rel(wrong[0], want[:B // dp]) > 1e-2


@pytest.mark.parametrize("shape", [(1, 4), (2, 2)])
def test_conv_state_is_whole_and_equal_at_every_model_position(shape):
    """After a prefill and after each decode step, every position holds the
    whole conv state of its data shard's rows, equal to the unsharded
    cache's: every part, not only the first holder's."""
    cfg = _cfg("zamba2_7b")
    model = get_model(cfg)
    params = model.init(0, device="cpu")
    prompt, steps = _serve_inputs(cfg)
    mesh = cpu_mesh(shape)
    sp = _placed(params, mesh)
    _, cache = model.prefill(params, {"tokens": _long(prompt)}, SMAX)
    with activate_mesh(mesh):
        _, sc = model.prefill(sp, {"tokens": _long(prompt)}, SMAX)
    for t in [None] + steps:
        if t is not None:
            _, cache = model.decode(params, {"tokens": _long(t)}, cache)
            with activate_mesh(mesh):
                _, sc = model.decode(sp, {"tokens": _long(t)}, sc)
        conv = sc["conv"]
        assert "model" not in [a for e in conv.spec for a in axes_of(e)]
        for pos, part in enumerate(conv.parts):
            region = conv.region(pos)
            assert part.shape == cache["conv"][region].shape
            assert _rel(part, cache["conv"][region]) <= REL, pos
        for group in conv.holders():
            assert all(torch.equal(conv.parts[group[0]], conv.parts[q])
                       for q in group[1:]), group


@pytest.mark.parametrize("shape", [(1, 2), (1, 4), (2, 2)])
def test_dB_and_dC_reach_their_owners_summed(shape):
    """Every position's heads read B and C, which only the last model
    positions' blocks of ``w_in`` produce: the gradients of those columns
    (and of the conv's B and C channels) are the sums over the positions'
    heads. Each position's own contribution is far from the whole."""
    cfg = _cfg("zamba2_7b")
    mesh = cpu_mesh(shape)
    p, sp, x = _mamba_layer(cfg, mesh)
    Din, N = cfg.d_inner, cfg.ssm_state_dim
    bc = slice(2 * Din, 2 * Din + 2 * N)
    ps = [p["w_in"], p["conv_w"]]
    for t in ps:
        t.requires_grad_(True)
    out = _plain_seq(cfg, p, x)[0]
    probe = torch.randn(out.shape, generator=torch.Generator().manual_seed(4))
    want = torch.autograd.grad((out * probe).sum(), ps)
    for t in ps:
        t.requires_grad_(False)
    parts = sp["w_in"].parts + sp["conv_w"].parts
    for t in parts:
        t.requires_grad_(True)
    xs, (outs, _, _) = _seq(cfg, mesh, sp, x)
    dp = mesh.shape["data"]
    loss = sum((o * probe[mesh.coord(pos, "data") * (B // dp):][:B // dp]
                ).sum() for pos, o in enumerate(outs)
               if mesh.coord(pos, "model") == 0)
    got = torch.autograd.grad(loss, parts, allow_unused=True,
                              materialize_grads=True)
    n = mesh.size
    w_in = Sharded(mesh, sp["w_in"].spec, sp["w_in"].shape, list(got[:n]))
    conv_w = Sharded(mesh, sp["conv_w"].spec, sp["conv_w"].shape,
                     list(got[n:]))
    own = [g.clone() for g in conv_w.parts]
    optimizer.reduce_grads({"a": w_in, "b": conv_w})
    gw, gc = gather(w_in), gather(conv_w)
    assert _rel(gw[:, bc], want[0][:, bc]) <= GRAD_REL
    assert _rel(gw, want[0]) <= GRAD_REL
    cbc = slice(Din, Din + 2 * N)
    assert _rel(gc[:, cbc], want[1][:, cbc]) <= GRAD_REL
    if mesh.shape["model"] > 1:
        assert _rel(own[0][:, cbc], want[1][:, cbc]) > 1e-2


@pytest.mark.parametrize("shape", [(1, 2), (1, 4), (1, 8)])
def test_w_in_blocks_are_not_the_positions_heads(shape):
    """``w_in`` (D, 2 Din + 2N + H) is split over ``model`` at column
    boundaries that are not its heads': at width 2 position 0's block holds
    all of z and the first columns of x. The layer's output still equals
    the unsharded one."""
    cfg = _cfg("zamba2_7b")
    mesh = cpu_mesh(shape)
    p, sp, x = _mamba_layer(cfg, mesh)
    Din, H, P_, _ = M.mamba2_dims(cfg)
    tp = shape[1]
    block = sp["w_in"].shape[1] // tp
    assert "model" in axes_of(sp["w_in"].spec[1])
    assert block != 2 * Din // tp + 2 * cfg.ssm_state_dim + H // tp
    assert torch.equal(sp["w_in"].parts[0], p["w_in"][:, :block])
    want = _plain_seq(cfg, p, x)[0]
    _, (out, _, _) = _seq(cfg, mesh, sp, x)
    assert all(_rel(o, want) <= REL for o in out)


# ---------------------------------------------------------------------------
# (d) the cache as the rule lays it out
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch,shape", [("rwkv6_1b6", (2, 2)),
                                        ("rwkv6_1b6", (1, 8)),
                                        ("zamba2_7b", (2, 2)),
                                        ("zamba2_7b", (1, 4))])
def test_the_cache_is_laid_out_as_the_rule_says(arch, shape):
    cfg = _cfg(arch)
    model = get_model(cfg)
    params = model.init(0, device="cpu")
    prompt, _ = _serve_inputs(cfg)
    mesh = cpu_mesh(shape)
    _, whole = model.prefill(params, {"tokens": _long(prompt)}, SMAX)
    with activate_mesh(mesh):
        logits, cache = model.prefill(_placed(params, mesh),
                                      {"tokens": _long(prompt)}, SMAX)
    rule = cache_shardings(cfg, mesh, whole)
    assert set(cache) == set(whole)
    for k, c in cache.items():
        assert _norm(c.spec) == _norm(rule[k].spec), (k, c.spec)
        for pos, part in enumerate(c.parts):
            region = c.region(pos)
            assert tuple(part.shape) == tuple(whole[k][region].shape), k
            assert part.dtype == whole[k].dtype, k
    if arch == "rwkv6_1b6":
        heads = "model" if shape == (2, 2) else None
        assert _norm(cache["wkv"].spec) == _norm((None, ("data",), heads))
    else:
        assert _norm(cache["ssd"].spec) == (
            (), ("data",), ("model",))
        assert _norm(cache["kv_k"].spec) == ((), ("data",), (), ("model",))
    assert _norm(logits.spec) == (("data",), ("model",))


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

    for arch in ARCHS:
        cfg = jax_smoke(arch).replace(**F32)
        model = jax_get_model(cfg)
        params = model.init(jax.random.key(0))
        batch = _np_batch(cfg.vocab_size, np.random.default_rng(0))
        save(f"{arch}/init", params)
        save(f"{arch}/batch", batch)
        prompt, steps = _serve_inputs(cfg)
        for shape in JAX_MESHES:
            mesh = jax_mesh(shape, AXES2)
            tag = f"{arch}/{shape[0]}x{shape[1]}"
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
                logits, cache = jax.jit(pre, in_shardings=pre_sh)(
                    params, {"tokens": prompt})
                out[f"{tag}/prefill/logits"] = np.asarray(logits)
                save(f"{tag}/prefill/cache", cache)
                pad = SMAX - PROMPT
                cache = {k: (np.pad(np.asarray(c), ((0, 0), (0, 0), (0, pad),
                                                    (0, 0), (0, 0)))
                             if k.startswith("kv_") else np.asarray(c))
                         for k, c in cache.items()}
                save(f"{tag}/padded", cache)
                step = jax.jit(dec, in_shardings=dec_sh)
                for i, t in enumerate(steps):
                    logits, cache = step(params, {"tokens": t}, cache)
                    # the step returns conv split by channels: back to the
                    # cell's layout through the host
                    cache = jax.tree.map(np.asarray, cache)
                    out[f"{tag}/step{i}/logits"] = np.asarray(logits)
                    out[f"{tag}/step{i}/lengths"] = np.asarray(
                        cache["lengths"])
        tcfg = JaxTrainConfig(learning_rate=3e-4, warmup_steps=1,
                              total_steps=3)
        mesh = jax_mesh((2, 2), AXES2)
        step, _, (state_sh, batch_sh) = build_cell(
            cfg, JaxShape("cell", seq_len=S, global_batch=B, kind="train"),
            mesh, tcfg)
        state = jax_init(model, tcfg, jax.random.key(1))
        save(f"{arch}/cell/init", state)
        with jax_activate(mesh):
            state, m = jax.jit(step, in_shardings=(state_sh, batch_sh))(
                state, batch)
        out[f"{arch}/cell/loss"] = np.asarray(m["loss"])
        out[f"{arch}/cell/grad_norm"] = np.asarray(m["grad_norm"])
        save(f"{arch}/cell/final", state["params"])
    np.savez(out_path, **out)


if __name__ == "__main__":
    # at the workers' own priority: at a lower one, six busy test workers
    # starve it past the fixture's timeout
    jax_side(sys.argv[1])
