"""Model sharding in the port against its unsharded self and the JAX
package, on the CPU.

A mesh here names the CPU at every position (``make_mesh(shape, axes,
"cpu")``): the port's sharded path is the same code on one device, one card
or four. Parameters come from each package's init (the JAX ones carried
across by the converters), tokens and labels from ``np.random.default_rng``,
everything in float32 at the smoke configs. Checked:

- The sharding rules: for all ten ``ARCHS`` at their published configs
  (shapes only: ``jax.eval_shape`` against the port's ``meta`` tensors), on
  meshes (16, 16), (2, 16, 16), (2, 2), (1, 4) and (4, 1), with ``moe_fsdp``
  True and False and ``kv_heads`` 0 and ``num_kv_heads``: every leaf's
  ``param_shardings`` and ``zero1_shardings`` spec equals the reference's,
  a per-layer leaf's equal to the stacked leaf's without its leading
  ``None``. ``data_sharding`` replicates a ragged batch as the reference's.
- The port sharded against the port unsharded: llama3-8b and pixtral-12b
  on (2, 1), (1, 2), (2, 2), (4, 1) and (1, 4), llama3 also with a loss mask
  on (2, 2) and (4, 1) and without remat, olmoe-1b-7b on (1, 2) and (1, 4)
  (with data axes the MoE is another function): the loss and every
  gradient leaf, summed over the positions that hold it, within 1e-5 of the
  leaf's largest magnitude (``REL``).
- The port against the JAX package on the same mesh (4 forced host devices
  in a subprocess, so that this process keeps one JAX device): llama3-8b
  and olmoe-1b-7b on (2, 2), (4, 1) and (1, 4): loss, xent and aux within
  1e-3 (``JAX_TOL``), every gradient leaf within ``JAX_REL`` (1e-4) of its
  largest magnitude; the gaps are printed (on the CPU they stay below 1e-6
  in the loss and 4e-6 of a leaf's largest gradient). The MoE on (2, 2) and (4, 1) lands on the JAX package's
  mesh value, not its single-device one.
- ZeRO-1: three steps of llama3-8b on (2, 2) with ``microbatch_size`` 2 of
  B = 4 against the port's unsharded step (parameters within 1e-5 absolute,
  ``grad_norm`` within 1e-5 relative) and against the reference's step
  jitted with ``build_cell``'s shardings (within 1e-3); each moment the
  data axes split holds 1 / dp of its parameter block a position
  (compression on a mesh: ``tests/test_torch_sharded_state.py``).
- The mesh, the collectives and their gradients, placement round trips and
  the errors: an MoE batch the data width does not divide, a state placed
  on no mesh or on another one (whisper's ``encdec`` on a mesh:
  ``tests/test_torch_encdec_sharding.py``).
"""
import functools
import os
import subprocess
import sys
import threading

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from jax.sharding import AbstractMesh

from repro.config import TrainConfig as JaxTrainConfig
from repro.configs import get_config as jax_get_config
from repro.launch import sharding as jshd
from repro.models import get_model as jax_get_model
from repro.training.train_loop import train_state_specs as jax_state_specs
from repro_torch.config import TrainConfig
from repro_torch.configs import ARCHS, get_config, get_smoke_config
from repro_torch.convert import (sharded_train_state_from_numpy,
                                 transformer_params_from_numpy)
from repro_torch.launch import spmd
from repro_torch.launch.mesh import (Mesh, activate_mesh, current_mesh,
                                     make_host_mesh, make_mesh,
                                     make_production_mesh)
from repro_torch.launch.sharding import (DATA_AXES, P, Sharded, axes_of,
                                         data_sharding, gather, gather_tree,
                                         param_shardings, place, place_tree,
                                         spec_axes, zero1_shardings)
from repro_torch.models import get_model
from repro_torch.training import optimizer
from repro_torch.training.train_loop import (init_train_state,
                                             make_train_step,
                                             shard_train_state,
                                             train_state_specs)
from repro_torch.tree import leaves, leaves_with_paths, map_tree, path_str

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
F32 = dict(dtype="float32", param_dtype="float32")
AXES2 = ("data", "model")
REL = 1e-5          # port sharded against port unsharded, float32
JAX_REL = 1e-4      # port against the JAX package on one mesh: gradients
JAX_TOL = 1e-3      # the same: loss, xent, aux, and the ZeRO-1 steps' loss
#                     and grad_norm
ZERO1_JAX_ATOL = 2e-5    # the ZeRO-1 steps' parameters against the JAX
#                          package's (three steps move an element ~5e-4)
ZERO1_JAX_DELTA = 5e-2   # each leaf's change over the steps against the JAX
#                          package's, relative to its largest element: a
#                          missing update gives 1, a wrong sign 2
B, S = 4, 32
RULE_MESHES = {"16x16": ((16, 16), AXES2),
               "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
               "2x2": ((2, 2), AXES2), "1x4": ((1, 4), AXES2),
               "4x1": ((4, 1), AXES2)}
JAX_MESHES = ((2, 2), (4, 1), (1, 4))


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """The lockstep runs many small ops a position: one intra-op thread
    keeps them off the thread pool, which several test workers on one
    host would oversubscribe."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def cpu_mesh(shape, axes=AXES2) -> Mesh:
    return make_mesh(shape, axes, "cpu")


def _norm(spec):
    """A spec's entries as tuples of axis names, trailing ones dropped."""
    out = [tuple(axes_of(e)) for e in spec]
    while out and not out[-1]:
        out.pop()
    return tuple(out)


def _jax_paths(tree):
    flat, _ = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, jax.sharding.NamedSharding))
    return {jshd._path_str(p): leaf for p, leaf in flat}


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


# ---------------------------------------------------------------------------
# the rules, at the published configs
# ---------------------------------------------------------------------------
@functools.lru_cache(maxsize=None)
def _state_specs(arch):
    jst = jax_state_specs(jax_get_model(jax_get_config(arch)),
                          JaxTrainConfig())
    tst = train_state_specs(get_model(get_config(arch)), TrainConfig())
    return jst, tst


def _same_specs(jax_tree, port_tree, what):
    want = _jax_paths(jax_tree)
    seen = set()
    for path, sh in leaves_with_paths(port_tree):
        stacked = any(isinstance(p, int) for p in path)
        key = "/".join(str(p) for p in path if not isinstance(p, int))
        jspec = tuple(want[key].spec)
        if stacked:
            assert not jspec or jspec[0] is None, (what, key, jspec)
            jspec = jspec[1:]
        assert _norm(sh.spec) == _norm(jspec), (what, path_str(path),
                                                sh.spec, jspec)
        seen.add(key)
    assert seen == set(want), (what, sorted(set(want) ^ seen))


@pytest.mark.parametrize("moe_fsdp", [True, False])
@pytest.mark.parametrize("mesh_name", list(RULE_MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_rules_equal_the_reference(arch, mesh_name, moe_fsdp):
    shape, axes = RULE_MESHES[mesh_name]
    jm = AbstractMesh(shape, axes)
    tm = (make_production_mesh(multi_pod=len(shape) == 3, devices="meta")
          if shape[-1] == 16 else make_mesh(shape, axes, "meta"))
    assert tm.shape == dict(zip(axes, shape))
    jst, tst = _state_specs(arch)
    for kv in (0, get_config(arch).num_kv_heads):
        _same_specs(jshd.param_shardings(jm, jst["params"], moe_fsdp=moe_fsdp,
                                         kv_heads=kv),
                    param_shardings(tm, tst["params"], moe_fsdp=moe_fsdp,
                                    kv_heads=kv), (arch, mesh_name, kv))
    for k in ("m", "v"):
        _same_specs(jshd.zero1_shardings(jm, jst["opt"][k]),
                    zero1_shardings(tm, tst["opt"][k]), (arch, mesh_name, k))


@pytest.mark.parametrize("mesh_name", list(RULE_MESHES))
def test_data_sharding_replicates_a_ragged_batch(mesh_name):
    shape, axes = RULE_MESHES[mesh_name]
    jm, tm = AbstractMesh(shape, axes), make_mesh(shape, axes, "meta")
    for batch in (None, 1, 2, 3, 4, 6, 8, 16, 32, 48, 256):
        for ndim in (1, 2, 3):
            got = data_sharding(tm, ndim, batch).spec
            want = jshd.data_sharding(jm, ndim, batch).spec
            assert _norm(got) == _norm(want), (batch, ndim, got, want)
    assert _norm(jshd.batch_spec(None)) == _norm(P(DATA_AXES, None))


# ---------------------------------------------------------------------------
# the mesh, placement and the collectives
# ---------------------------------------------------------------------------
def test_mesh_positions_groups_and_ambient():
    m = make_production_mesh(multi_pod=True, devices="meta")
    assert m.size == 512 and m.axis_names == ("pod", "data", "model")
    assert m.coords(16 * 16 + 3 * 16 + 5) == (1, 3, 5)
    assert m.index_over(16 * 16 + 3 * 16 + 5, DATA_AXES) == 16 + 3
    g = m.groups(DATA_AXES)
    assert len(g) == 16 and all(len(x) == 32 for x in g)
    assert g[1][:3] == [1, 17, 33]
    mesh = cpu_mesh((2, 2))
    assert mesh.distinct() == (torch.device("cpu"),)
    assert make_host_mesh(2) is None             # no card here
    with pytest.raises(ValueError):
        make_mesh((2, 2), AXES2, ["cpu"] * 3)
    assert current_mesh() is None
    seen = []
    with activate_mesh(mesh):
        assert current_mesh() is mesh
        with activate_mesh(None):
            assert current_mesh() is None
        t = threading.Thread(target=lambda: seen.append(current_mesh()))
        t.start()
        t.join(timeout=10)
        assert current_mesh() is mesh
    assert not t.is_alive() and seen == [None]
    assert current_mesh() is None


@pytest.mark.parametrize("spec", [P(), P("model"), P(None, "data"),
                                  P(("data", "model")), P("data", "model")])
def test_place_and_gather_round_trip(spec):
    mesh = cpu_mesh((2, 2))
    x = torch.arange(48, dtype=torch.float32).reshape(4, 12)
    s = place(x, mesh, spec)
    assert torch.equal(gather(s), x)
    used = 1
    for e in spec:
        used *= mesh.axis_size(axes_of(e))
    assert all(p.numel() * used == x.numel() for p in s.parts)
    assert sum(len(g) for g in s.holders()) == 4
    assert len(s.holders()) == used


def test_collectives_and_their_gradients():
    mesh = cpu_mesh((2, 3))
    rng = np.random.default_rng(3)
    xs = [torch.tensor(rng.normal(size=(2, 5)), requires_grad=True)
          for _ in range(6)]
    ws = [torch.tensor(rng.normal(size=(2, 5))) for _ in range(6)]
    ys = spmd.psum(xs, mesh, "model")
    for group in mesh.groups(["model"]):
        total = sum(xs[p] for p in group)
        for p in group:
            assert torch.allclose(ys[p], total)
    gs = torch.autograd.grad(sum((y * w).sum() for y, w in zip(ys, ws)), xs)
    for group in mesh.groups(["model"]):
        want = sum(ws[p] for p in group)
        for p in group:
            assert torch.allclose(gs[p], want)
    zs = spmd.all_gather(xs, mesh, "data", 1)
    for group in mesh.groups(["data"]):
        whole = torch.cat([xs[p] for p in group], 1)
        for p in group:
            assert torch.equal(zs[p], whole)
    gs = torch.autograd.grad(sum((z * torch.cat([w, w], 1)).sum()
                                 for z, w in zip(zs, ws)), xs)
    for group in mesh.groups(["data"]):
        total = sum(torch.cat([ws[p], ws[p]], 1) for p in group)
        for i, p in enumerate(group):
            assert torch.allclose(gs[p], total[:, 5 * i:5 * (i + 1)])
    means = spmd.pmean(xs, mesh, DATA_AXES)
    assert torch.allclose(means[0], (xs[0] + xs[3]) / 2)
    tops = spmd.pmax(xs, mesh, "model")
    assert torch.equal(tops[4], torch.maximum(torch.maximum(xs[3], xs[4]),
                                              xs[5]).detach())
    assert [spmd.axis_index(mesh, p, "model") for p in range(6)] == [
        0, 1, 2, 0, 1, 2]
    # remat: the same values and gradients, the body run again backward
    calls = []

    def body(ts):
        calls.append(1)
        return spmd.psum([t * t for t in ts], mesh, "data")

    plain = torch.autograd.grad(sum(y.sum() for y in body(xs)), xs)
    again = spmd.remat(body, xs)
    got = torch.autograd.grad(sum(y.sum() for y in again), xs)
    assert len(calls) == 3
    assert all(torch.equal(a, b) for a, b in zip(plain, got))


def test_shard_map_places_and_wraps():
    mesh = cpu_mesh((2, 2))
    x = torch.arange(16, dtype=torch.float32).reshape(4, 4)

    def body(xs):
        return spmd.psum([t.sum(0, keepdim=True) for t in xs.parts], mesh,
                         DATA_AXES)

    out = spmd.shard_map(body, mesh, (P("data"),), P(None, "model"))(x)
    assert out.shape == (1, 8)
    assert torch.equal(gather(out)[0, :4], x.sum(0))


# ---------------------------------------------------------------------------
# the port sharded against the port unsharded
# ---------------------------------------------------------------------------
def _batch(cfg, seed, masked=False):
    rng = np.random.default_rng(seed)
    b = {"tokens": torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, S))),
         "labels": torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, S)))}
    if cfg.family == "vlm":
        b["patch_embeds"] = torch.from_numpy(rng.normal(
            size=(B, cfg.num_patches, cfg.d_model)).astype(np.float32))
    if masked:
        m = (rng.random((B, S)) < 0.6).astype(np.float32)
        m[0] = 0.0                        # one shard's rows all masked out
        b["loss_mask"] = torch.from_numpy(m)
    return b


def _sharded_grads(model, params, batch, mesh):
    """(loss, metrics, whole gradient tree) of the port on ``mesh``."""
    sp = place_tree(params, mesh, param_shardings(
        mesh, params, moe_fsdp=model.cfg.moe_fsdp_params))
    parts = [t for w in leaves(sp) for t in w.parts]
    for t in parts:
        t.requires_grad_(True)
    with activate_mesh(mesh):
        loss, m = model.loss(sp, batch)
    g = iter(torch.autograd.grad(loss, parts, allow_unused=True,
                                 materialize_grads=True))
    grads = map_tree(lambda w: Sharded(w.mesh, w.spec, w.shape,
                                       [next(g) for _ in w.parts]), sp)
    return (loss.detach(), {k: v.detach() for k, v in m.items()},
            gather_tree(optimizer.reduce_grads(grads)))


def _plain_grads(model, params, batch):
    ps = leaves(params)
    for p in ps:
        p.requires_grad_(True)
    loss, m = model.loss(params, batch)
    g = torch.autograd.grad(loss, ps)
    for p in ps:
        p.requires_grad_(False)
    return loss.detach(), m, g


SELF_CASES = ([("llama3_8b", s, False, True) for s in
               ((2, 1), (1, 2), (2, 2), (4, 1), (1, 4))]
              + [("pixtral_12b", s, False, True) for s in
                 ((2, 1), (1, 2), (2, 2), (4, 1), (1, 4))]
              + [("olmoe_1b_7b", s, False, True) for s in ((1, 2), (1, 4))]
              + [("llama3_8b", s, True, True) for s in ((2, 2), (4, 1))]
              + [("llama3_8b", (2, 2), False, False)])


@pytest.mark.parametrize("arch,shape,masked,remat", SELF_CASES)
def test_sharded_loss_and_gradients_equal_unsharded(arch, shape, masked,
                                                     remat):
    cfg = get_smoke_config(arch).replace(remat=remat, **F32)
    model = get_model(cfg)
    params = model.init(0, device="cpu")
    batch = _batch(cfg, 1, masked)
    loss0, m0, g0 = _plain_grads(model, params, batch)
    loss, m, g = _sharded_grads(model, params, batch, cpu_mesh(shape))
    assert abs(float(loss) - float(loss0)) <= REL * abs(float(loss0))
    aux, aux0 = float(m["aux"]), float(m0["aux"].detach())
    assert abs(aux - aux0) <= REL * max(abs(aux0), 1e-30)
    for (path, got), want in zip(leaves_with_paths(g), g0):
        top = want.abs().max().item()
        err = (got - want).abs().max().item()
        assert err <= REL * top, (path_str(path), err, top)


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
    return _run_jax(tmp_path_factory.mktemp("jax_mesh") / "runs.npz")


def _np_batch(vocab, rng):
    return {"tokens": rng.integers(0, vocab, (B, S)).astype(np.int32),
            "labels": rng.integers(0, vocab, (B, S)).astype(np.int32)}


def _jax_tree(runs, prefix):
    """The arrays saved under ``prefix/`` back as a nested dict."""
    out = {}
    for k, v in runs.items():
        if k.startswith(prefix + "/"):
            node = out
            *dirs, last = k[len(prefix) + 1:].split("/")
            for d in dirs:
                node = node.setdefault(d, {})
            node[last] = v
    return out


@pytest.mark.parametrize("shape", JAX_MESHES)
@pytest.mark.parametrize("arch", ["llama3_8b", "olmoe_1b_7b"])
def test_loss_and_gradients_equal_the_reference_on_its_mesh(jax_runs, arch,
                                                            shape):
    cfg = get_smoke_config(arch).replace(**F32)
    model = get_model(cfg)
    params = transformer_params_from_numpy(_jax_tree(jax_runs, f"{arch}/init"),
                                           cfg, device="cpu")
    batch = {k: torch.from_numpy(jax_runs[f"{arch}/batch/{k}"]).long()
             for k in ("tokens", "labels")}
    tag = f"{arch}/{shape[0]}x{shape[1]}"
    loss, m, g = _sharded_grads(model, params, batch, cpu_mesh(shape))
    gaps = {k: abs(float(v) - float(jax_runs[f"{tag}/{k}"]))
            for k, v in (("loss", loss), ("xent", m["xent"]),
                         ("aux", m["aux"]))}
    jg = _jax_tree(jax_runs, f"{tag}/grad")
    worst = 0.0
    for path, got in leaves_with_paths(g):
        want = _ref_leaf(jg, path)
        rel = np.abs(got.numpy() - want).max() / max(np.abs(want).max(),
                                                     1e-30)
        worst = max(worst, rel)
        assert rel <= JAX_REL, (path_str(path), rel)
    print(f"{tag}: loss {float(loss):.6f} (jax {float(jax_runs[tag + '/loss']):.6f}, "
          f"one device {float(jax_runs[arch + '/single/loss']):.6f}) gaps "
          + " ".join(f"{k}={v:.2e}" for k, v in gaps.items())
          + f" worst gradient leaf {worst:.2e} of its max")
    assert max(gaps.values()) <= JAX_TOL, gaps
    if cfg.family == "moe" and shape[0] > 1:
        single = float(jax_runs[f"{arch}/single/loss"])
        assert abs(float(loss) - single) > 10 * gaps["loss"], (loss, single)


def test_zero1_steps_equal_unsharded_and_the_reference(jax_runs):
    cfg = get_smoke_config("llama3_8b").replace(**F32)
    model = get_model(cfg)
    tcfg = TrainConfig(learning_rate=3e-4, warmup_steps=1, total_steps=3,
                       microbatch_size=2)
    jstate = {"params": _jax_tree(jax_runs, "zero1/init/params"),
              "opt": {"m": _jax_tree(jax_runs, "zero1/init/opt/m"),
                      "v": _jax_tree(jax_runs, "zero1/init/opt/v"),
                      "step": jax_runs["zero1/init/opt/step"]}}
    mesh = cpu_mesh((2, 2))
    state = sharded_train_state_from_numpy(jstate, cfg, mesh)
    plain = gather_tree(state, "cpu")
    dp = mesh.axis_size(DATA_AXES)
    split = 0
    for p, mo in zip(leaves(state["params"]), leaves(state["opt"]["m"])):
        if "data" in spec_axes(mo.spec) and "data" not in spec_axes(p.spec):
            split += 1
            assert all(mo.parts[i].numel() * dp == p.parts[i].numel()
                       for i in range(mesh.size)), (mo.spec, p.spec)
    assert split == len(leaves(state["params"]))     # every leaf here
    step = make_train_step(model, tcfg)
    for i in range(3):
        b = {k: torch.from_numpy(v).long() for k, v in (
            ("tokens", jax_runs[f"zero1/batch{i}/tokens"]),
            ("labels", jax_runs[f"zero1/batch{i}/labels"]))}
        with activate_mesh(mesh):
            state, m = step(state, b)
        plain, m0 = step(plain, b)
        for k in ("loss", "grad_norm"):
            a, c = float(m[k]), float(m0[k])
            assert abs(a - c) <= REL * abs(c), (i, k, a, c)
            j = float(jax_runs[f"zero1/step{i}/{k}"])
            assert abs(a - j) <= JAX_TOL * abs(j), (i, k, a, j)
    got = gather_tree(state, "cpu")
    perr = max((a - b).abs().max().item() for a, b in zip(
        leaves(got["params"]), leaves(plain["params"])))
    assert perr <= REL, perr
    jp = _jax_tree(jax_runs, "zero1/final")
    j0 = jstate["params"]
    jerr = dmax = 0.0
    for path, t in leaves_with_paths(got["params"]):
        want = _ref_leaf(jp, path)
        jerr = max(jerr, np.abs(t.numpy() - want).max())
        jd = want - _ref_leaf(j0, path)
        d = np.abs((t.numpy() - _ref_leaf(j0, path)) - jd).max()
        dmax = max(dmax, d / max(np.abs(jd).max(), 1e-30))
    assert int(got["opt"]["step"]) == 3
    print(f"zero1: params vs unsharded {perr:.2e}, vs the reference "
          f"{jerr:.2e}, change vs the reference's {dmax:.2e} of its max")
    assert jerr <= ZERO1_JAX_ATOL, jerr
    assert dmax <= ZERO1_JAX_DELTA, dmax


# ---------------------------------------------------------------------------
# errors
# ---------------------------------------------------------------------------
def test_what_does_not_run_on_a_mesh_raises():
    mesh = cpu_mesh((2, 2))
    cfg = get_smoke_config("olmoe_1b_7b").replace(**F32)
    model = get_model(cfg)
    state = init_train_state(model, TrainConfig(), 0, device="cpu")
    sharded = shard_train_state(state, mesh, cfg)
    odd = {k: v[:3] for k, v in _batch(cfg, 2).items()}
    with activate_mesh(mesh):
        with pytest.raises(ValueError, match="does not divide"):
            model.loss(sharded["params"], odd)
    step = make_train_step(model, TrainConfig())
    with pytest.raises(ValueError, match="activate_mesh"):
        step(sharded, _batch(cfg, 2))
    with activate_mesh(mesh):
        with pytest.raises(ValueError, match="shard_train_state"):
            step(state, _batch(cfg, 2))
        with pytest.raises(ValueError, match="shard_train_state"):
            step(shard_train_state(state, cpu_mesh((4, 1)), cfg),
                 _batch(cfg, 2))


# ---------------------------------------------------------------------------
# the subprocess: the JAX package on 4 forced host devices
# ---------------------------------------------------------------------------
def jax_side(out_path) -> None:
    assert len(jax.devices()) == 4, jax.devices()
    from repro.config import ShapeConfig
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

    rng = np.random.default_rng(0)
    for arch in ("llama3_8b", "olmoe_1b_7b"):
        cfg = jax_smoke(arch).replace(**F32)
        model = jax_get_model(cfg)
        params = model.init(jax.random.key(0))
        batch = _np_batch(cfg.vocab_size, rng)
        save(f"{arch}/init", params)
        save(f"{arch}/batch", batch)
        loss, _ = jax.jit(model.loss)(params, batch)
        out[f"{arch}/single/loss"] = np.asarray(loss)
        for shape in JAX_MESHES:
            mesh = jax_mesh(shape, AXES2)
            tag = f"{arch}/{shape[0]}x{shape[1]}"
            with jax_activate(mesh):
                psh = jshd.param_shardings(mesh, params,
                                           moe_fsdp=cfg.moe_fsdp_params)
                bsh = {k: jshd.data_sharding(mesh, v.ndim, v.shape[0])
                       for k, v in batch.items()}
                f = jax.jit(jax.value_and_grad(model.loss, has_aux=True),
                            in_shardings=(psh, bsh))
                (loss, m), g = f(params, batch)
            out[f"{tag}/loss"] = np.asarray(loss)
            out[f"{tag}/xent"] = np.asarray(m["xent"])
            out[f"{tag}/aux"] = np.asarray(m["aux"])
            save(f"{tag}/grad", g)
    cfg = jax_smoke("llama3_8b").replace(**F32)
    model = jax_get_model(cfg)
    tcfg = JaxTrainConfig(learning_rate=3e-4, warmup_steps=1, total_steps=3,
                          microbatch_size=2)
    mesh = jax_mesh((2, 2), AXES2)
    step, _, (state_sh, batch_sh) = build_cell(
        cfg, ShapeConfig("zero1", seq_len=S, global_batch=B, kind="train"),
        mesh, tcfg)
    state = jax_init(model, tcfg, jax.random.key(1))
    save("zero1/init", state)
    with jax_activate(mesh):
        f = jax.jit(step, in_shardings=(state_sh, batch_sh),
                    out_shardings=(state_sh, None))
        for i in range(3):
            batch = _np_batch(cfg.vocab_size, rng)
            save(f"zero1/batch{i}", batch)
            state, m = f(state, batch)
            out[f"zero1/step{i}/loss"] = np.asarray(m["loss"])
            out[f"zero1/step{i}/grad_norm"] = np.asarray(m["grad_norm"])
    save("zero1/final", state["params"])
    np.savez(out_path, **out)


if __name__ == "__main__":
    # at the workers' own priority: at a lower one, six busy test workers
    # starve it past the fixture's timeout
    jax_side(sys.argv[1])
