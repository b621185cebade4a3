"""The dry run's cells on a model mesh: the cache rules and ``build_cell``.

Counterpart of the JAX package's ``launch/dryrun.py`` in the parts that
sharded serve needs. ``cache_shardings`` is the reference's name-based rule
for every cache leaf of every family (``launch.sharding.cache_shardings``,
where the models and ``convert`` take it from), here with the reference's
default probe of the cache's structure. ``build_cell`` pairs a cell's
function with its arguments' stand-ins (``meta`` tensors) and their
shardings, as the reference's does for its ``jax.jit``; ``place_cell`` turns
the stand-ins into tensors on the mesh from a seed, so that a cell runs.
Train, prefill and decode cells run for every family, ``encdec``'s with its
frames in the batch as the reference's ``input_specs`` gives them.

Not ported yet (ROADMAP.md, queue 1, item 7): ``run_cell`` and ``main``
(lower and compile every arch and shape on the production meshes), and
``hlo_analysis.py``, ``attribution.py`` and ``report.py``, which read XLA's
compiled HLO.
"""
from __future__ import annotations

from typing import Any, Callable, Optional

import torch

from repro_torch.config import ModelConfig, ShapeConfig, TrainConfig
from repro_torch.launch import sharding
from repro_torch.launch.mesh import Mesh, activate_mesh
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
    ``kv_replicate`` (the reference's ``--kv-replicate``, set only by its
    ``main``) is not ported yet and raises."""
    if kv_replicate:
        raise NotImplementedError(
            "build_cell(kv_replicate=True): cells with wk and wv replicated "
            "are not ported yet (ROADMAP.md, queue 1, item 7)")
    model = get_model(cfg)
    batch_sds = input_specs(cfg, shape)
    batch_sh = {k: data_sharding(mesh, v.dim(), batch_size=v.shape[0])
                for k, v in batch_sds.items()}

    if shape.is_train:
        state_sds = train_state_specs(model, tcfg)
        state_sh = train_state_shardings(mesh, state_sds, cfg)
        return (_on(mesh, make_train_step(model, tcfg)),
                (state_sds, batch_sds), (state_sh, batch_sh))

    param_sds = param_specs(cfg)
    param_sh = param_shardings(mesh, param_sds, moe_fsdp=cfg.moe_fsdp_params)
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
