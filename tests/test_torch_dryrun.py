"""The port's dry run on the CPU: cells traced on fake tensors, their
collective bytes, memory and operations, against real runs and the JAX
package's cells.

Meshes here name the CPU at every position (``make_mesh(shape, axes,
"cpu")``), and ``--device cpu`` gives fake ``cpu`` positions, which take
the kernels' plain versions (a fake ``cuda`` tensor cannot be indexed on a
build without CUDA, so the card's path runs whole only on a card:
``chip_smoke.py``'s ``dryrun`` phase). Everything runs in this process: the
reference's ``build_cell`` on an ``AbstractMesh``. Checked:

- (a) every smoke cell's arguments (shapes, types, partition specs) equal
  to the reference's ``build_cell``'s, for the ten archs, every applicable
  shape, on (2, 4) and (2, 2, 2), with ``kv_replicate`` where the model
  width does not divide the KV heads;
- (b) the collective counter's units, the counterpart of
  ``test_hlo_collective_parser_units``: a ``psum`` of f32[100] over 4
  positions, ``pmean``, an ``all_gather`` and its backward, ``pmax``,
  ``reduce_grads``, and the sites they record;
- (c) a fake run of a train and a decode cell equal to a real run of the
  same cell on the CPU mesh, to the byte: collectives by kind and site,
  each position's argument, output and peak bytes, the operations, the
  kernels' calls;
- (d) zamba2-7b's smoke train cell through ``main`` on (2, 4); the other
  families' and (e), ``attribution`` and ``report``, are in
  ``tests/test_torch_dryrun_main.py`` (the five fake train traces at (2, 4)
  take about 40 s on one CPU: split over two files, each runs on its own
  test worker in under a minute);
- (f) ``build_cell(kv_replicate=True)``'s train cell: ``wk`` and ``wv``
  replicated, the loss equal to the default layout's within ``REL``;
- (g) every kernel wrapper's fake branch (fake ``cuda`` tensors) giving the
  plain version's output shapes and types, counted as fake calls with
  their operations, and real tensors never taking it;
- (h) the depth expansion exact at a third depth for the families whose
  train cells use it, and a serve cell whose check misses running whole.
"""
import dataclasses
import functools
import json
import os

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from jax.sharding import AbstractMesh
from torch._subclasses.fake_tensor import FakeTensorMode

from repro.config import TrainConfig as JaxTrainConfig
from repro.configs import get_smoke_config as jax_smoke_config
from repro.configs.shapes import SHAPES as JAX_SHAPES
from repro_torch import kernels
from repro_torch.config import ShapeConfig, TrainConfig
from repro_torch.configs import ARCHS, get_smoke_config
from repro_torch.configs.shapes import SHAPES, shape_applicable
from repro_torch.kernels import (browse_scores, decode_attention,
                                 flash_attention, mamba2_ssd, ref, rwkv6_scan,
                                 topk_sim, tree_refresh)
from repro_torch.launch import dryrun, spmd
from repro_torch.launch.collectives import CollectiveCounter
from repro_torch.launch.mesh import make_mesh
from repro_torch.launch.sharding import (NamedSharding, P, axes_of, gather,
                                         place)
from repro_torch.training import optimizer
from repro_torch.tree import leaves_with_paths

REL = 1e-5          # the model-mesh files' tolerance: a layout against another
F32 = dict(dtype="float32", param_dtype="float32")
SMOKE_MESHES = {"single": ((2, 4), ("data", "model")),
                "multi": ((2, 2, 2), ("pod", "data", "model"))}


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """The lockstep runs many small ops a position: one intra-op thread
    keeps them off the thread pool, which several test workers on one
    host would oversubscribe."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def cpu_mesh(shape, axes=("data", "model")):
    return make_mesh(shape, axes, "cpu")


def _norm(spec):
    """A spec's entries as tuples of axis names, trailing ones dropped."""
    out = [tuple(axes_of(e)) for e in spec]
    while out and not out[-1]:
        out.pop()
    return tuple(out)


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


def _jax_paths(tree):
    from repro.launch import sharding as jshd
    flat, _ = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, jax.sharding.NamedSharding))
    return {jshd._path_str(p): leaf for p, leaf in flat}


def _spec_of(sh):
    return sh.spec if isinstance(sh, NamedSharding) else P(*sh)


def _same_cell(jspecs, jshards, specs, shards, what):
    """Each port leaf's shape, type and spec against the reference's leaf:
    a per-layer port leaf against the stacked leaf without its leading
    dim (and its spec without the leading None)."""
    want_x, want_sh = _jax_paths(jspecs), _jax_paths(jshards)
    layers, seen = {}, set()
    for (path, x), (_, sh) in zip(leaves_with_paths(specs),
                                  leaves_with_paths(shards)):
        stacked = any(isinstance(p, int) for p in path)
        key = "/".join(str(p) for p in path if not isinstance(p, int))
        jx, jspec = want_x[key], tuple(want_sh[key].spec)
        jshape = tuple(jx.shape)
        if stacked:
            assert not jspec or jspec[0] is None, (what, key, jspec)
            jspec, jshape = jspec[1:], jshape[1:]
            layers[key] = layers.get(key, 0) + 1
        assert x.device.type == "meta", (what, key)
        assert tuple(x.shape) == jshape, (what, key, x.shape, jx.shape)
        assert str(x.dtype).replace("torch.", "") == jx.dtype.name, (what,
                                                                    key)
        assert _norm(_spec_of(sh)) == _norm(jspec), (what, key, sh, jspec)
        seen.add(key)
    assert seen == set(want_x), (what, sorted(seen ^ set(want_x)))
    for key, n in layers.items():
        assert want_x[key].shape[0] == n, (what, key, n)


# ---------------------------------------------------------------------------
# (a) every smoke cell's arguments against the reference's build_cell
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ARCHS)
def test_smoke_cells_equal_the_reference(arch):
    rd = _ref_dryrun()
    jtcfg = JaxTrainConfig(microbatch_size=0, grad_compression="none",
                           zero1=True)
    tcfg = TrainConfig(microbatch_size=0, grad_compression="none", zero1=True)
    checked = 0
    for mesh_kind, (shape, axes) in SMOKE_MESHES.items():
        jm = AbstractMesh(shape, axes)
        for sname in SHAPES:
            cfg, tshape, tm = dryrun.smoke_cell(arch, sname, mesh_kind, "meta")
            if not shape_applicable(cfg, tshape)[0]:
                continue
            jcfg = jax_smoke_config(arch)
            jshape = dataclasses.replace(JAX_SHAPES[sname],
                                         seq_len=tshape.seq_len,
                                         global_batch=tshape.global_batch)
            tp = dict(zip(axes, shape))["model"]
            kvs = (False, True) if cfg.num_kv_heads % tp else (False,)
            for kv in kvs:
                _, jargs, jsh = rd.build_cell(jcfg, jshape, jm, jtcfg,
                                              kv_replicate=kv)
                _, args, sh = dryrun.build_cell(cfg, tshape, tm, tcfg,
                                                kv_replicate=kv)
                assert len(args) == len(jargs)
                for i in range(len(args)):
                    _same_cell(jargs[i], jsh[i], args[i], sh[i],
                               (arch, sname, mesh_kind, kv, i))
                checked += 1
    assert checked >= 6


# ---------------------------------------------------------------------------
# (b) the counter's units
# ---------------------------------------------------------------------------
def test_collective_counter_units():
    mesh = cpu_mesh((1, 4))
    xs = [torch.ones(100) for _ in range(4)]
    with CollectiveCounter() as c:
        spmd.psum(xs, mesh, "model")
    assert c.totals() == {"all-reduce": 400.0, "total": 400.0,
                          "num_collectives": 1.0}
    assert c.per_position() == {p: {"all-reduce": 400.0} for p in range(4)}
    (b, kind, calls, shapes, site), = c.sites()
    assert (b, kind, calls, shapes) == (400.0, "all-reduce", 1, ["f32[100]"])
    assert site == "?"              # no frame of the package called it

    with CollectiveCounter() as c:                # through its psum
        spmd.pmean(xs, mesh, "model")
        spmd.pmax(xs, mesh, "model")
    assert c.totals() == {"all-reduce": 800.0, "total": 800.0,
                          "num_collectives": 2.0}

    parts = [torch.ones(25, requires_grad=True) for _ in range(4)]
    with CollectiveCounter() as c:
        ys = spmd.all_gather(parts, mesh, "model", 0)
        sum(torch.sum(y * (i + 1)) for i, y in enumerate(ys)).backward()
    # the gather's result at each position, then its backward's
    # reduce-scatter at the gathered whole's bytes
    assert c.totals() == {"all-gather": 400.0, "reduce-scatter": 400.0,
                          "total": 800.0, "num_collectives": 2.0}
    sites = {kind: site for _, kind, _, _, site in c.sites()}
    assert sites["reduce-scatter"] == sites["all-gather"] + " backward"
    assert all(torch.equal(p.grad, torch.full((25,), 10.0)) for p in parts)

    mesh = cpu_mesh((2, 2))                       # a block held twice
    g = place(torch.ones(6, 8), mesh, P(None, "model"))
    with CollectiveCounter() as c:
        optimizer.reduce_grads({"w": g})
    assert c.totals(0) == {"all-reduce": 6 * 4 * 4.0, "total": 96.0,
                           "num_collectives": 1.0}
    assert torch.equal(gather(g), torch.full((6, 8), 2.0))
    site = c.sites(0)[0][4]
    assert site.startswith("training/optimizer.py:") and "reduce_grads" in \
        site

    with CollectiveCounter() as c:                # a group of one: nothing
        spmd.psum(xs[:1], cpu_mesh((1, 1)), "model")
    assert c.calls == []


# ---------------------------------------------------------------------------
# (c) a fake run equals a real run of the same cell
# ---------------------------------------------------------------------------
TCFG = TrainConfig(microbatch_size=0, grad_compression="none", zero1=True)


@pytest.mark.parametrize("sname", ["train_4k", "decode_32k"])
def test_fake_run_equals_a_real_run(sname):
    cfg, shape, _ = dryrun.smoke_cell("llama3_8b", sname, "single", "cpu")
    mesh = cpu_mesh((2, 2))
    fake = dryrun.trace_cell(cfg, shape, mesh, TCFG, fake=True)
    real = dryrun.trace_cell(cfg, shape, mesh, TCFG, fake=False)
    assert dryrun.differ(fake["nums"], real["nums"]) == []
    assert fake["shapes"] == real["shapes"]
    nums = fake["nums"]
    assert nums["mem|0|peak"] > nums["mem|0|argument"] > 0
    assert nums["flops"] > 0 and nums["kernel|flash_attention|calls" if
                                       shape.is_train else
                                       "kernel|decode_attention|calls"] > 0
    coll = [k for k in nums if k.startswith("coll|")]
    assert coll and all(nums[k] > 0 for k in coll)


# ---------------------------------------------------------------------------
# (d) the hybrid family's train cell through main
# ---------------------------------------------------------------------------
def test_smoke_zamba2_train_cell_through_main(tmp_path):
    dryrun.main(["--smoke", "--device", "cpu", "--arch", "zamba2_7b",
                 "--shape", "train_4k", "--mesh", "single", "--out",
                 str(tmp_path)])
    with open(tmp_path / "zamba2_7b__train_4k__single.json") as fh:
        data = json.load(fh)
    assert data["ok"], data.get("traceback")
    assert data["mesh_shape"] == [2, 4] and data["depth"]["mode"] == "whole"
    assert data["roofline"]["hlo_flops_total"] > 0
    assert data["memory"]["peak_gb"] >= data["memory"]["argument_gb"] > 0
    assert data["collectives"]["total"] > 0
    assert data["kernels"]["mamba2_ssd"]["calls_per_position"] > 0


# ---------------------------------------------------------------------------
# (f) kv_replicate
# ---------------------------------------------------------------------------
def test_kv_replicate_train_cell_equals_the_default_layout():
    cfg = get_smoke_config("llama3_8b").replace(**F32)
    assert cfg.num_kv_heads % 4 != 0           # 2 KV heads on 4 model shards
    mesh = cpu_mesh((2, 4))
    shape = ShapeConfig("train", seq_len=16, global_batch=4, kind="train")
    tcfg = TrainConfig(learning_rate=1e-3, warmup_steps=1, total_steps=2)
    losses = []
    for kv in (False, True):
        cell = dryrun.build_cell(cfg, shape, mesh, tcfg, kv_replicate=kv)
        specs = {"/".join(map(str, p)): sh.spec for p, sh in
                 leaves_with_paths(cell[2][0]["params"])}
        want = P() if kv else P(None, "model")
        assert _norm(specs["layers/0/attn/wk"]) == _norm(want)
        assert _norm(specs["layers/0/attn/wv"]) == _norm(want)
        args = dryrun.place_cell(cfg, shape, mesh, cell, seed=3, tcfg=tcfg)
        _, metrics = cell[0](*args)
        losses.append(float(metrics["loss"]))
    assert np.isfinite(losses[0])
    assert abs(losses[1] - losses[0]) <= REL * abs(losses[0])


# ---------------------------------------------------------------------------
# (g) the wrappers' fake branch
# ---------------------------------------------------------------------------
def _wrapper_calls(dev):
    """(name, call) of every wrapper at small shapes whose dims need no
    padding (a fake CUDA tensor cannot be sliced on a CPU-only build)."""
    bf, f32, i32 = torch.bfloat16, torch.float32, torch.int32
    e = lambda *s, dt=f32: torch.empty(*s, dtype=dt, device=dev)  # noqa
    q, k = e(2, 64, 4, 16, dt=bf), e(2, 64, 2, 16, dt=bf)
    qd, kc, ln = e(2, 4, 16, dt=bf), e(2, 256, 2, 16, dt=bf), e(2, dt=i32)
    B, T, H, N = 2, 128, 4, 16
    x, dt, A = e(B, T, H, 16, dt=bf), e(B, T, H), e(H)
    Bm, st, sts = e(B, T, N, dt=bf), e(B, H, 16, N), e(B, H, T // 64, 16, N)
    r, w, u = e(B, T, H, 16, dt=bf), e(B, T, H, 16), e(H, 16, dt=bf)
    ce, cm = e(16, 8, 64), e(16, 8)
    return [
        ("flash_attention", lambda: flash_attention.flash_attention(q, k, k)),
        ("flash_attention", lambda: flash_attention.flash_attention_lse(
            q, k, k)),
        ("flash_attention_bwd", lambda: flash_attention.flash_attention_bwd(
            q, k, k, q, e(2, 4, 64), q)),
        ("decode_attention", lambda: decode_attention.decode_attention(
            qd, kc, kc, ln)),
        ("decode_attention", lambda: decode_attention.decode_attention_lse(
            qd, kc, kc, ln)),
        ("mamba2_ssd", lambda: mamba2_ssd.mamba2_ssd(x, dt, A, Bm, Bm, st)),
        ("mamba2_ssd_bwd", lambda: mamba2_ssd.mamba2_ssd_bwd(
            x, dt, A, Bm, Bm, st, x, None, states=sts)),
        ("rwkv6_scan", lambda: rwkv6_scan.rwkv6_scan(r, r, r, w, u, st)),
        ("rwkv6_scan_bwd", lambda: rwkv6_scan.rwkv6_scan_bwd(
            r, r, r, w, u, st, r, None, states=sts)),
        ("topk_sim", lambda: topk_sim.topk_sim(e(8, 64), e(1000, 64), 8)),
        ("tree_refresh", lambda: tree_refresh.tree_refresh(ce, cm)),
        ("browse_scores", lambda: browse_scores.browse_scores(
            ce, e(16, 64), cm)),
        ("browse_scores", lambda: browse_scores.browse_scores_rows(
            e(100, 64), e(16, 8, dt=i32), e(4, 64), e(16, dt=i32), cm)),
    ]


def _meta(out):
    outs = out if isinstance(out, tuple) else (out,)
    return [(tuple(o.shape), o.dtype) for o in outs]


def test_wrappers_fake_branch_gives_the_plain_shapes():
    with FakeTensorMode(), torch.no_grad():
        plain = [(n, _meta(f())) for n, f in _wrapper_calls("cpu")]
        kernels.reset_counts()
        fake = [(n, _meta(f())) for n, f in _wrapper_calls("cuda")]
        counts = {k: (c.fake_calls, c.plain_calls, c.launches, c.ops)
                  for k, c in kernels.COUNTS.items()}
    assert fake == plain
    for name in kernels.COUNTS:
        calls = sum(1 for n, _ in plain if n == name)
        fake_calls, plain_calls, launches, ops = counts[name]
        assert (fake_calls, plain_calls, launches) == (calls, 0, 0), name
        assert ops > 0, name


def test_real_tensors_never_take_the_fake_branch():
    kernels.reset_counts()
    q = torch.randn(1, 8, 2, 16)
    with torch.no_grad():
        out = flash_attention.flash_attention(q, q, q)
    assert torch.equal(out, ref.attention_ref(q, q, q))
    c = kernels.COUNTS["flash_attention"]
    assert (c.plain_calls, c.fake_calls) == (1, 0)
    from repro_torch.kernels import _build
    assert not _build.is_fake(q)
    with FakeTensorMode():
        assert _build.is_fake(torch.empty(2))


# ---------------------------------------------------------------------------
# (h) the depth expansion
# ---------------------------------------------------------------------------
EXPANDING = ("llama3_8b", "olmoe_1b_7b", "rwkv6_1b6", "zamba2_7b",
             "pixtral_12b")


@pytest.mark.parametrize("arch", EXPANDING)
def test_depth_expansion_is_exact_at_a_third_depth(arch):
    """Each expanded family's train cell on (1, 2): the traces at the first
    two unit counts (2 and 3 layers; zamba2's 1 and 2 units of 2 past its
    remainder of 1) expanded three counts on equal the trace there, to the
    byte."""
    cfg, shape, _ = dryrun.smoke_cell(arch, "train_4k", "single", "cpu")
    mesh = cpu_mesh((1, 2))
    a, b, _ = dryrun.depths(dryrun.depth_unit(cfg)[0])
    runs = {n: dryrun.trace_cell(dryrun.at_depth(cfg, n), shape, mesh, TCFG,
                                 fake=False)["nums"] for n in (a, b, a + 3)}
    assert dryrun.differ(dryrun.expand(runs[a], runs[b], 4),
                         runs[a + 3]) == []
    assert runs[a + 3]["mem|0|peak"] > runs[b]["mem|0|peak"]


def test_an_expanded_cell_equals_its_whole_trace():
    """llama3-8b's train cell at ten layers on (1, 2): traced at 2 and 3
    layers, checked at 4, and equal to the whole trace to the byte."""
    cfg, shape, _ = dryrun.smoke_cell("llama3_8b", "train_4k", "single",
                                      "cpu")
    deep = cfg.replace(num_layers=10)
    mesh = cpu_mesh((1, 2))
    rec = dryrun.trace_at_depth(deep, shape, mesh, TCFG, fake=False)
    assert rec["depth"] == {"mode": "expanded", "unit": 1, "rest": 0,
                            "units": 10, "layers": [2, 3],
                            "checked_layers": [4]}
    whole = dryrun.trace_cell(deep, shape, mesh, TCFG, fake=False)
    assert dryrun.differ(rec["nums"], whole["nums"]) == []


def test_a_missed_expansion_runs_whole():
    """rwkv6's decode cell on (2, 2) at smoke widths: its state caches'
    blocks are not multiples of the allocator's 512 bytes a layer, so the
    arguments are not affine in depth; the check misses and the cell runs
    whole. Fewer units than the traces take run whole."""
    cfg, shape, _ = dryrun.smoke_cell("rwkv6_1b6", "decode_32k", "single",
                                      "cpu")
    rec = dryrun.trace_at_depth(cfg.replace(num_layers=10), shape,
                                cpu_mesh((2, 2)), TCFG, fake=False)
    assert rec["depth"]["mode"] == "whole"
    assert rec["depth"]["checked_layers"] == [2, 3, 4]
    assert dryrun.depths(1) == (2, 3, 4) and dryrun.depths(6) == (1, 2, 3)
    assert "mem|0|argument" in rec["depth"]["expansion_missed"]
    rec = dryrun.trace_at_depth(cfg.replace(num_layers=9), shape,
                                cpu_mesh((1, 2)), TCFG, fake=False)
    assert rec["depth"] == {"mode": "whole", "layers": [9]}
    assert dryrun.depth_unit(get_smoke_config("whisper_base")) is None
    assert dryrun.depth_unit(get_smoke_config("zamba2_7b")) == (2, 1, 2)
