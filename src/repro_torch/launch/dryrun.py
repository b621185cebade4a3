"""Dry run: every (architecture x input shape) cell on the production
meshes, traced on fake tensors, with the roofline's inputs (per-device
memory, operations, collective bytes).

    PYTHONPATH=src python -m repro_torch.launch.dryrun --mesh both --out artifacts/dryrun_torch
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch llama3_8b --shape decode_32k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --smoke --device cpu --out DIR

Counterpart of the JAX package's ``launch/dryrun.py``. The reference lowers
and compiles each cell with XLA and reads the compiled program. The port
has no compiler: ``run_cell`` runs the cell's own lockstep code once under
``FakeTensorMode``, on fake tensors at every mesh position, so no memory is
allocated and no kernel launched, and reads from that run each position's
memory (``launch.memory.MemoryTracker``), its collective bytes
(``launch.collectives.CollectiveCounter``, by kind and by site), its
operations (``torch.utils.flop_counter``'s count of the aten ops, plus
each kernel call's, ``kernels.costs``) and its kernel calls, and feeds
``roofline.roofline_terms``. Positions are fake ``cuda`` devices by default:
the card's path, through the kernel wrappers, which allocate what their
launch would and skip it; ``device="cpu"`` (``--device cpu``) traces fake
``cpu`` positions through the plain versions. A cell's JSON
(``artifacts/.../<arch>__<shape>__<mesh>.json``) holds the reference's
keys, ``trace_s`` in place of ``lower_s`` and ``compile_s``, no
``bytes_accessed`` (the trace reads no device's traffic), and the depth it
ran at (``depth``).

A production-mesh train cell run whole costs about a fifth of a second a
position and layer on a host's CPU, so a cell whose layers repeat is traced
at two consecutive counts of repeating units past the config's remainder
and its figures expanded linearly to the config's count (``depth_unit``,
``expand``): the counterpart of the reference's trip-count expansion. The
unit is a layer, or ``attn_every`` layers for the hybrid family (zamba2's
remainder runs at every depth); encdec runs whole. The counts start at two
layers (a step of one layer peaks elsewhere), at 2 and 3 layers for a
unit of one. Every expansion is checked as it runs: a trace at the next
count must equal the expansion to the byte, or the cell runs whole
(``trace_at_depth``).

Also here: ``cache_shardings`` (the reference's name-based rule for every
cache leaf of every family, ``launch.sharding.cache_shardings``, with the
reference's default probe of the cache's structure), ``build_cell`` (a
cell's function, its arguments' stand-ins as ``meta`` tensors and their
shardings) and ``place_cell`` (the stand-ins as tensors on the mesh from a
seed, so that a cell runs for real).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
import traceback
from collections import defaultdict
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro_torch import kernels
from repro_torch.config import ModelConfig, ShapeConfig, TrainConfig
from repro_torch.configs import ARCHS, get_config, get_smoke_config
from repro_torch.configs.shapes import SHAPE_ORDER, SHAPES, shape_applicable
from repro_torch.launch import sharding
from repro_torch.launch.collectives import CollectiveCounter
from repro_torch.launch.memory import MemoryTracker
from repro_torch.launch.mesh import (Mesh, activate_mesh, make_mesh,
                                     make_production_mesh)
from repro_torch.launch.roofline import roofline_terms
from repro_torch.launch.sharding import (NamedSharding, P, Sharded,
                                         _spec_leaves, data_sharding,
                                         param_shardings, place_tree,
                                         shard_region)
from repro_torch.models.factory import (get_model, input_specs, make_batch,
                                        param_specs)
from repro_torch.training.train_loop import (init_train_state,
                                             make_train_step,
                                             train_state_shardings,
                                             train_state_specs)
from repro_torch.tree import leaves, unflatten


# ---------------------------------------------------------------------------
# cache shardings (the rule is ``launch.sharding.cache_shardings``)
# ---------------------------------------------------------------------------
def cache_shardings(cfg: ModelConfig, mesh: Mesh, specs=None) -> Any:
    """``launch.sharding.cache_shardings`` over the cache tree ``specs``, by
    default ``cache_specs(2, 8)``, a probe of the structure."""
    if specs is None:
        specs = get_model(cfg).cache_specs(2, 8)
    return sharding.cache_shardings(cfg, mesh, specs)


def _resize_cache_specs(cfg: ModelConfig, batch: int, max_len: int):
    return get_model(cfg).cache_specs(batch, max_len)


# ---------------------------------------------------------------------------
# cells
# ---------------------------------------------------------------------------
def _on(mesh: Mesh, fn: Callable) -> Callable:
    """``fn`` called under ``activate_mesh(mesh)``: a cell runs on its mesh
    as the reference's jitted cell runs under its ``in_shardings``."""
    def run(*args):
        with activate_mesh(mesh):
            return fn(*args)
    return run


def build_cell(cfg: ModelConfig, shape: ShapeConfig, mesh: Mesh,
               tcfg: TrainConfig, *, kv_replicate: bool = False):
    """(fn, the arguments' stand-ins, their shardings), the reference's
    cell: a train cell's step on the train state and a batch (ZeRO-1's
    shardings, ``train_state_shardings``), a prefill cell's
    ``model.prefill(params, batch, shape.seq_len)`` and a decode cell's
    ``model.decode(params, batch, cache)`` on a ``shape.seq_len`` cache placed
    by ``cache_shardings``. The batch's shardings are ``data_sharding``'s.
    ``fn`` runs under ``activate_mesh(mesh)`` and takes the arguments placed
    on the mesh (``place_cell``) with the batch as whole tensors.
    ``kv_replicate`` (the reference's ``--kv-replicate``) lays out ``wk``
    and ``wv`` by ``param_shardings(kv_heads=cfg.num_kv_heads)``: replicated
    where the model width does not divide the KV heads."""
    model = get_model(cfg)
    kvh = cfg.num_kv_heads if kv_replicate else 0
    batch_sds = input_specs(cfg, shape)
    batch_sh = {k: data_sharding(mesh, v.dim(), batch_size=v.shape[0])
                for k, v in batch_sds.items()}

    if shape.is_train:
        state_sds = train_state_specs(model, tcfg)
        state_sh = train_state_shardings(mesh, state_sds, cfg, kv_heads=kvh)
        return (_on(mesh, make_train_step(model, tcfg)),
                (state_sds, batch_sds), (state_sh, batch_sh))

    param_sds = param_specs(cfg)
    param_sh = param_shardings(mesh, param_sds, moe_fsdp=cfg.moe_fsdp_params,
                               kv_heads=kvh)
    if shape.kind == "prefill":
        def prefill(params, batch):
            return model.prefill(params, batch, shape.seq_len)
        return _on(mesh, prefill), (param_sds, batch_sds), (param_sh, batch_sh)

    cache_sds = _resize_cache_specs(cfg, shape.global_batch, shape.seq_len)
    cache_sh = cache_shardings(cfg, mesh, cache_sds)
    return (_on(mesh, model.decode), (param_sds, batch_sds, cache_sds),
            (param_sh, batch_sh, cache_sh))


def empty_on_mesh(specs: Any, shardings: Any, mesh: Mesh) -> Any:
    """Each leaf of ``specs`` as a ``Sharded`` of zeros laid out by the
    matching leaf of ``shardings``: each position allocates its own block
    only, so a cache no one device could hold is never whole anywhere."""
    out = []
    for x, sh in zip(leaves(specs), _spec_leaves(shardings)):
        spec = sh.spec if isinstance(sh, NamedSharding) else P(*sh)
        parts = [torch.zeros(tuple(r.stop - r.start for r in shard_region(
            x.shape, spec, mesh, pos)), dtype=x.dtype, device=dev)
            for pos, dev in enumerate(mesh.devices)]
        out.append(Sharded(mesh, spec, x.shape, parts))
    return unflatten(specs, out)


def place_cell(cfg: ModelConfig, shape: ShapeConfig, mesh: Mesh, cell,
               seed: int = 0, tcfg: Optional[TrainConfig] = None):
    """The arguments of ``cell`` (``build_cell``'s triple) as tensors: the
    parameters (or a train cell's state) from ``init`` at ``seed`` on the
    mesh's first device, placed by the cell's shardings; the batch from
    ``make_batch(cfg, ..., seed)`` as whole tensors on the first device, in
    the stand-ins' types; a decode cell's cache empty (zeros, lengths 0, as
    ``init_cache`` gives it), each position's block made on its device."""
    _, specs, shardings = cell
    model = get_model(cfg)
    dev = mesh.devices[0]
    batch_sds = specs[1]
    seq = batch_sds["tokens"].shape[1] if shape.kind != "decode" else 0
    made = make_batch(cfg, shape.kind, shape.global_batch, seq, seed,
                      device=dev)
    batch = {k: made[k].to(v.dtype) for k, v in batch_sds.items()}
    if shape.is_train:
        state = init_train_state(model, tcfg or TrainConfig(), seed,
                                 device=dev)
        return place_tree(state, mesh, shardings[0]), batch
    params = place_tree(model.init(seed, device=dev), mesh, shardings[0])
    if shape.kind == "prefill":
        return params, batch
    return params, batch, empty_on_mesh(specs[2], shardings[2], mesh)


# ---------------------------------------------------------------------------
# one step of a cell, under the counters
# ---------------------------------------------------------------------------
def cell_arguments(cell, mesh: Mesh) -> Tuple[Any, ...]:
    """The arguments of ``cell`` (``build_cell``'s triple) as zeros: every
    sharded one placed by its shardings (``empty_on_mesh``, each position
    its own block), the batch whole on the first position, as the step
    takes it. Under ``FakeTensorMode`` they are fake: shapes without
    data."""
    _, specs, shardings = cell
    out = []
    for i, (sp, sh) in enumerate(zip(specs, shardings)):
        if i == 1:
            out.append({k: torch.zeros(v.shape, dtype=v.dtype,
                                       device=mesh.devices[0])
                        for k, v in sp.items()})
        else:
            out.append(empty_on_mesh(sp, sh, mesh))
    return tuple(out)


def _by_position(args, mesh: Mesh) -> Dict[int, List[torch.Tensor]]:
    """Each position's argument tensors; a whole tensor is the first
    position's."""
    by: Dict[int, List[torch.Tensor]] = {p: [] for p in range(mesh.size)}
    for x in leaves(args):
        if isinstance(x, Sharded):
            for pos, t in enumerate(x.parts):
                by[pos].append(t)
        elif isinstance(x, torch.Tensor):
            by[0].append(x)
    return by


def measure_step(fn: Callable, args, mesh: Mesh) -> Dict[str, Any]:
    """``fn(*args)`` once under a ``MemoryTracker`` (memory and the aten
    ops' operations) and a ``CollectiveCounter``: a flat record of
    numbers (``nums``, keys ``coll|pos|kind``, ``ncoll|pos``,
    ``site|pos|kind|site|bytes`` and ``|calls``, ``mem|pos|argument``,
    ``|output``, ``|peak``, ``mem_all|peak``, ``flops``,
    ``kernel|name|calls`` and ``|ops``), the sites' shapes and the seconds
    it took. Real or fake, the same step gives the same record where
    nothing depends on the data: the fake run is the real one's
    prediction."""
    tracker = MemoryTracker(mesh.size)
    tracker.add_arguments(_by_position(args, mesh))
    before = {k: (c.launches + c.plain_calls + c.fake_calls, c.ops)
              for k, c in kernels.COUNTS.items()}
    t0 = time.perf_counter()
    with CollectiveCounter() as cc, tracker:
        out = fn(*args)
    seconds = time.perf_counter() - t0
    mem = tracker.report(out)
    del out
    nums: Dict[str, float] = defaultdict(float)
    shapes: Dict[str, List[str]] = {}
    for kind, n, positions, site, shape in cc.calls:
        for pos in positions:
            nums[f"coll|{pos}|{kind}"] += n
            nums[f"ncoll|{pos}"] += 1
            nums[f"site|{pos}|{kind}|{site}|bytes"] += n
            nums[f"site|{pos}|{kind}|{site}|calls"] += 1
        seen = shapes.setdefault(f"{kind}|{site}", [])
        if shape not in seen and len(seen) < 4:
            seen.append(shape)
    for kind in ("argument", "output", "peak"):
        for pos, n in enumerate(mem["per_position_bytes"][kind]):
            nums[f"mem|{pos}|{kind}"] = n
    nums["mem_all|peak"] = mem["all_positions_peak_gb"] * 1e9
    ops = 0.0
    for k, c in kernels.COUNTS.items():
        calls = c.launches + c.plain_calls + c.fake_calls - before[k][0]
        if calls:
            nums[f"kernel|{k}|calls"] = calls
            nums[f"kernel|{k}|ops"] = c.ops - before[k][1]
            ops += c.ops - before[k][1]
    nums["flops"] = tracker.flops + ops
    return {"nums": dict(nums), "shapes": shapes, "seconds": seconds,
            "untagged": mem["untagged_allocations"]}


def trace_cell(cfg: ModelConfig, shape: ShapeConfig, mesh: Mesh,
               tcfg: TrainConfig, *, kv_replicate: bool = False,
               fake: bool = True) -> Dict[str, Any]:
    """``measure_step`` of the cell's step on its ``cell_arguments``: under
    ``FakeTensorMode`` (the dry run), or on real zeros (what it
    predicts)."""
    cell = build_cell(cfg, shape, mesh, tcfg, kv_replicate=kv_replicate)
    if not fake:
        return measure_step(cell[0], cell_arguments(cell, mesh), mesh)
    with FakeTensorMode():
        return measure_step(cell[0], cell_arguments(cell, mesh), mesh)


# ---------------------------------------------------------------------------
# depth expansion
# ---------------------------------------------------------------------------
# a cell whose layers repeat is traced at three consecutive unit counts
# (``depths``); where the first two expanded to the third equal it to the
# byte, the cell takes the expansion, else it runs whole: affinity in depth
# is checked, not assumed (a storage is rounded to the allocator's 512
# bytes, and the point of a step's peak can move with depth)
MIN_LAYERS = 2      # the first trace's layers at least: a step of one
                    # layer peaks elsewhere than one of two or more


def depths(unit: int) -> Tuple[int, int, int]:
    """The unit counts traced: the least that holds ``MIN_LAYERS`` layers,
    and the next two."""
    first = -(-MIN_LAYERS // unit)
    return first, first + 1, first + 2


def depth_unit(cfg: ModelConfig) -> Optional[Tuple[int, int, int]]:
    """(unit, rest, units): the config's layers as ``rest`` + ``units`` x
    ``unit``, the repeating unit of its family, or None where the depth is
    not expanded (encdec: whisper-base's train cell, at its smoke config,
    peaks at points that differ at 1, 2 and 3 layers, so its expansion
    would miss the check every time)."""
    if cfg.family == "hybrid" and cfg.attn_every > 0:
        u = cfg.attn_every
        return u, cfg.num_layers % u, cfg.num_layers // u
    if cfg.family == "encdec":     # its peak moves with depth: whole
        return None
    return 1, 0, cfg.num_layers


def at_depth(cfg: ModelConfig, units: int) -> ModelConfig:
    """``cfg`` cut to its remainder and ``units`` repeating units (zamba2's
    shared attention block follows every ``attn_every`` layers, so its
    remainder comes last in each)."""
    u, rest, _ = depth_unit(cfg)
    return dataclasses.replace(cfg, num_layers=rest + units * u)


def expand(one: Dict[str, float], two: Dict[str, float],
           units: int) -> Dict[str, float]:
    """Records at two consecutive depths (``one`` at n units, ``two`` at n
    + 1) extended linearly to n + ``units`` - 1 units: x1 + (units - 1) (x2
    - x1) for every key."""
    return {k: one.get(k, 0.0) + (units - 1) * (two.get(k, 0.0)
                                                - one.get(k, 0.0))
            for k in set(one) | set(two)}


def differ(a: Dict[str, float], b: Dict[str, float]) -> List[str]:
    """The keys whose numbers differ between two records."""
    return sorted(k for k in set(a) | set(b) if a.get(k, 0.0) != b.get(k, 0.0))


def trace_at_depth(cfg: ModelConfig, shape: ShapeConfig, mesh: Mesh,
                   tcfg: TrainConfig, *, kv_replicate: bool = False,
                   fake: bool = True) -> Dict[str, Any]:
    """The cell traced whole, or, where its layers hold more repeating
    units than the three traces take together, at
    three consecutive unit counts (``depths``): expanded to the config's
    count where the first two expanded to the third equal it, else whole. Adds ``depth``: the mode
    and the layer counts traced."""
    unit = depth_unit(cfg)
    counts = depths(unit[0]) if unit is not None else ()
    if unit is None or unit[2] <= sum(counts):
        rec = trace_cell(cfg, shape, mesh, tcfg, kv_replicate=kv_replicate,
                         fake=fake)
        rec["depth"] = {"mode": "whole", "layers": [cfg.num_layers]}
        return rec
    runs = [trace_cell(at_depth(cfg, n), shape, mesh, tcfg,
                       kv_replicate=kv_replicate, fake=fake) for n in counts]
    seconds = sum(r["seconds"] for r in runs)
    layers = [at_depth(cfg, n).num_layers for n in counts]
    a, _, c = counts
    missed = differ(expand(runs[0]["nums"], runs[1]["nums"], c - a + 1),
                    runs[2]["nums"])
    if missed:
        rec = trace_cell(cfg, shape, mesh, tcfg, kv_replicate=kv_replicate,
                         fake=fake)
        rec["seconds"] += seconds
        rec["depth"] = {"mode": "whole", "layers": [cfg.num_layers],
                        "expansion_missed": missed[:8],
                        "checked_layers": layers}
        return rec
    return {"nums": expand(runs[0]["nums"], runs[1]["nums"],
                           unit[2] - a + 1),
            "shapes": runs[1]["shapes"], "seconds": seconds,
            "untagged": runs[1]["untagged"],
            "depth": {"mode": "expanded", "unit": unit[0], "rest": unit[1],
                      "units": unit[2], "layers": layers[:2],
                      "checked_layers": layers[2:]}}


# ---------------------------------------------------------------------------
# a cell's JSON
# ---------------------------------------------------------------------------
def summarize(rec: Dict[str, Any], positions: int) -> Dict[str, Any]:
    """A trace's record as the reference's JSON fields: ``memory`` (the
    position with the highest peak), ``collectives`` (the reference's keys
    at the position whose collectives carry the most bytes), the sites
    there, ``cost_analysis_raw`` (operations a position) and the kernels'
    calls a position."""
    nums = rec["nums"]
    get = lambda k: nums.get(k, 0.0)  # noqa: E731
    peak = [get(f"mem|{p}|peak") for p in range(positions)]
    top = max(range(positions), key=lambda p: (peak[p], -p))
    memory = {"position": top,
              "argument_gb": get(f"mem|{top}|argument") / 1e9,
              "output_gb": get(f"mem|{top}|output") / 1e9,
              "temp_gb": (peak[top] - get(f"mem|{top}|argument")) / 1e9,
              "peak_gb": peak[top] / 1e9,
              "all_positions_peak_gb": get("mem_all|peak") / 1e9,
              "peak_gb_by_position": [p / 1e9 for p in peak]}
    coll_bytes = [sum(v for k, v in nums.items()
                      if k.startswith(f"coll|{p}|")) for p in range(positions)]
    cpos = max(range(positions), key=lambda p: (coll_bytes[p], -p))
    colls = {k.split("|")[2]: v for k, v in nums.items()
             if k.startswith(f"coll|{cpos}|")}
    colls["total"] = float(sum(colls.values()))
    colls["num_collectives"] = get(f"ncoll|{cpos}")
    sites = []
    for k, v in nums.items():
        parts = k.split("|")
        if parts[0] == "site" and parts[1] == str(cpos) and \
                parts[-1] == "bytes":
            kind, site = parts[2], "|".join(parts[3:-1])
            sites.append([v, kind, int(round(get(k[:-5] + "calls"))),
                          rec["shapes"].get(f"{kind}|{site}", []), site])
    sites.sort(key=lambda r: (-r[0], r[1], r[4]))
    kern = {}
    for k, v in nums.items():
        parts = k.split("|")
        if parts[0] == "kernel" and parts[2] == "calls" and v:
            kern[parts[1]] = {"calls_per_position": v / positions,
                              "ops": get(f"kernel|{parts[1]}|ops")}
    return {"memory": memory,
            "cost_analysis_raw": {"flops": get("flops") / positions},
            "collectives": colls, "collective_position": cpos,
            "collective_sites": sites, "kernels": kern}


def run_cell(arch: str, shape_name: str, mesh_kind: str, *,
             tcfg: Optional[TrainConfig] = None,
             out_dir: Optional[str] = None,
             cfg_override: Optional[ModelConfig] = None,
             shape_override: Optional[ShapeConfig] = None,
             mesh_override: Optional[Mesh] = None, tag: str = "",
             kv_replicate: bool = False, donate: bool = False,
             device: str = "cuda") -> Dict[str, Any]:
    """The reference's ``run_cell``: one cell traced (``trace_at_depth``)
    on the production mesh (``mesh_kind`` "single" or "multi") of fake
    ``device`` positions, or on ``mesh_override``; the result as JSON
    written to ``out_dir`` (``_dump``). A failure is data: ``ok`` false
    with the error and its traceback. ``donate`` is recorded: the port's
    train and decode steps update their state in place, the reference's
    donated layout, with or without it."""
    cfg = cfg_override or get_config(arch)
    shape = shape_override or SHAPES[shape_name]
    tcfg = tcfg or TrainConfig(microbatch_size=0, grad_compression="none",
                               zero1=True)
    mesh = mesh_override if mesh_override is not None else \
        make_production_mesh(multi_pod=(mesh_kind == "multi"),
                             devices=fake_device(device))
    result: Dict[str, Any] = {
        "arch": arch, "shape": shape_name, "mesh": mesh_kind + tag,
        "mesh_shape": list(mesh.dims), "device": mesh.devices[0].type,
        "ok": False,
    }
    ok, reason = shape_applicable(cfg, shape)
    if not ok:
        result["skipped"] = reason
        result["ok"] = True
        _dump(result, out_dir)
        return result
    try:
        rec = trace_at_depth(cfg, shape, mesh, tcfg,
                             kv_replicate=kv_replicate)
        out = summarize(rec, mesh.size)
        terms = roofline_terms(
            cfg, shape, num_devices=mesh.size,
            tp=mesh.shape.get(sharding.MODEL_AXIS, 1),
            collective_bytes_per_dev=out["collectives"]["total"])
        result.update(ok=True, trace_s=round(rec["seconds"], 2),
                      depth=rec["depth"], donate=donate,
                      untagged_allocations=rec["untagged"],
                      roofline=terms, **out)
    except Exception as e:  # noqa: BLE001 — report trace failures as data
        result["error"] = f"{type(e).__name__}: {e}"
        result["traceback"] = traceback.format_exc()[-2000:]
    _dump(result, out_dir)
    return result


def _dump(result: Dict[str, Any], out_dir: Optional[str]) -> None:
    if not out_dir:
        return
    os.makedirs(out_dir, exist_ok=True)
    name = f"{result['arch']}__{result['shape']}__{result['mesh']}.json"
    with open(os.path.join(out_dir, name), "w") as f:
        json.dump(result, f, indent=1, default=float)


def fake_device(device: str) -> str:
    """A fake position's device: ``cuda`` is the first card's, named so
    that no card is asked for its index (a fake position needs none)."""
    return "cuda:0" if device == "cuda" else device


def smoke_cell(arch: str, shape_name: str, mesh_kind: str, device: str):
    """The reference's ``--smoke`` cell: the reduced config, seq 64 (128
    for a decode cell's cache), batch 4, on (2, 4) or (2, 2, 2)."""
    shape = dataclasses.replace(
        SHAPES[shape_name],
        seq_len=64 if SHAPES[shape_name].kind != "decode" else 128,
        global_batch=4)
    device = fake_device(device)
    mesh = (make_mesh((2, 2, 2), ("pod", "data", "model"), device)
            if mesh_kind == "multi"
            else make_mesh((2, 4), ("data", "model"), device))
    return get_smoke_config(arch), shape, mesh


def main(argv: Optional[List[str]] = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--mesh", default="both",
                    choices=["single", "multi", "both"])
    ap.add_argument("--out", default="artifacts/dryrun_torch")
    ap.add_argument("--microbatch", type=int, default=0)
    ap.add_argument("--smoke", action="store_true",
                    help="reduced configs on a (2,4)/(2,2,2) mesh")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="the fake positions' device: cuda takes the "
                    "kernel wrappers' path, cpu the plain versions'")
    ap.add_argument("--tag", default="", help="suffix for artifact filenames")
    ap.add_argument("--mesh-shape", default=None,
                    help="override the single-pod mesh, e.g. 64x4")
    ap.add_argument("--serving-ep", action="store_true",
                    help="pure expert-parallel MoE weights (no FSDP)")
    ap.add_argument("--kv-replicate", action="store_true",
                    help="replicate wk/wv when kv_heads %% tp != 0")
    ap.add_argument("--no-remat", action="store_true")
    ap.add_argument("--donate", action="store_true",
                    help="donate the train state / decode cache (the "
                    "port's steps update them in place either way)")
    args = ap.parse_args(argv)

    archs = ARCHS if args.arch == "all" else [args.arch]
    shapes = SHAPE_ORDER if args.shape == "all" else [args.shape]
    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    tcfg = TrainConfig(microbatch_size=args.microbatch)

    n_fail = 0
    for arch in archs:
        for shape_name in shapes:
            for mesh_kind in meshes:
                if args.smoke:
                    cfg_o, shape_o, mesh_o = smoke_cell(
                        arch, shape_name, mesh_kind, args.device)
                    r = run_cell(arch, shape_name, mesh_kind, tcfg=tcfg,
                                 out_dir=args.out, cfg_override=cfg_o,
                                 shape_override=shape_o, mesh_override=mesh_o,
                                 kv_replicate=args.kv_replicate,
                                 donate=args.donate, device=args.device)
                else:
                    cfg_o = get_config(arch)
                    if args.serving_ep:
                        cfg_o = cfg_o.replace(moe_fsdp_params=False)
                    if args.no_remat:
                        cfg_o = cfg_o.replace(remat=False)
                    mesh_o = None
                    if args.mesh_shape and mesh_kind == "single":
                        dims = tuple(int(x) for x in
                                     args.mesh_shape.split("x"))
                        mesh_o = make_mesh(dims, ("data", "model"),
                                           fake_device(args.device))
                    r = run_cell(arch, shape_name, mesh_kind, tcfg=tcfg,
                                 out_dir=args.out, cfg_override=cfg_o,
                                 mesh_override=mesh_o, tag=args.tag,
                                 kv_replicate=args.kv_replicate,
                                 donate=args.donate, device=args.device)
                print(f"[{arch:16s}|{shape_name:12s}|{mesh_kind:6s}] "
                      f"{status_line(r)}", flush=True)
                n_fail += not r["ok"]
    if n_fail:
        raise SystemExit(f"{n_fail} cells failed")


def status_line(r: Dict[str, Any]) -> str:
    """One cell's result on a line, as the reference's ``main`` prints
    it."""
    if r.get("skipped"):
        return "SKIP " + r["skipped"][:40]
    if not r["ok"]:
        return "FAIL " + r.get("error", "?")[:80]
    t = r["roofline"]
    return (f"ok trace={r['trace_s']:.1f}s ({r['depth']['mode']}) "
            f"peak={r['memory']['peak_gb']:.1f}GB "
            f"comp={t['compute_s'] * 1e3:.2f}ms mem={t['memory_s'] * 1e3:.2f}ms "
            f"coll={t['collective_s'] * 1e3:.2f}ms dom={t['dominant']}")


if __name__ == "__main__":
    main()
