"""Train-step builder: loss -> grads (optional microbatch accumulation) ->
optional compression -> clip -> AdamW.

Counterpart of the JAX package's ``training/train_loop.py``. The step runs
eagerly on the parameters' device: on a card the attention forward and
backward are the ``flash_attention`` kernels, everything else is PyTorch.
It returns the new state and the metrics as 0-d tensors and waits for the
device nowhere, so consecutive steps queue up on the stream; reading a
metric (``float(m["loss"])``) is the caller's sync.

The state is ``{"params", "opt": {"m", "v", "step"}, "err"?}`` and is
updated IN PLACE (``optimizer.adamw_update``): the returned state holds the
same tensors. A caller that keeps an older state must clone it
(``optimizer.clone_tree``).

On a model mesh the step is the same step, as the reference jits its plain
step with ``param_shardings``, ``zero1_shardings`` and ``data_sharding`` at
the boundary (``dryrun.build_cell``): ``shard_train_state`` places the
state, and the step, called under ``launch.mesh.activate_mesh``, splits each
microbatch over the data axes, sums each parameter block's gradient over the
positions that hold it and takes the ZeRO-1 update::

    mesh = make_host_mesh(2)              # or make_mesh((2, 2), AXES, "cpu")
    state = shard_train_state(init_train_state(model, tcfg, 0, device="cpu"),
                              mesh, cfg)
    with activate_mesh(mesh):
        state, metrics = step(state, batch)   # batch: whole tensors
"""
from __future__ import annotations

from typing import Any, Callable, Dict

import torch

from repro_torch.config import TrainConfig
from repro_torch.launch.mesh import Mesh, current_mesh
from repro_torch.launch.sharding import (Sharded, is_sharded, param_shardings,
                                         place_tree, replicated,
                                         zero1_shardings)
from repro_torch.models.factory import Model
from repro_torch.models.layers import meta_specs
from repro_torch.training import grad_compress, optimizer
from repro_torch.tree import leaves, unflatten


def make_train_step(model: Model, tcfg: TrainConfig) -> Callable:
    """Returns train_step(state, batch) -> (state, metrics): metrics
    ``loss``, ``compress_ratio`` (with compression), ``grad_norm`` (before
    clipping) and ``lr``.

    Microbatching splits the batch along dim 0 into ``microbatch_size``
    slices, accumulates their gradients in float32 and divides by their
    number; the loss is the mean of the slices' losses. The parameters
    require grad only inside the step. Under an ambient mesh the state must
    be placed on it (``shard_train_state``) and the batch holds whole
    tensors; gradient compression there runs in the ZeRO-1 blocks
    (``grad_compress``)."""
    use_compress = tcfg.grad_compression != "none"

    def grads_of(params, batch, ps, sharded):
        loss, _ = model.loss(params, batch)
        # on a mesh a position's part may not reach the loss (a batch too
        # small to split over the data axes is replicated, and the loss is
        # the first data position's): its gradient is zero
        return loss.detach(), torch.autograd.grad(
            loss, ps, allow_unused=sharded, materialize_grads=sharded)

    def compute_grads(params, batch, ps, sharded=False):
        mb = tcfg.microbatch_size
        if not mb or mb <= 0:
            return grads_of(params, batch, ps, sharded)
        B = next(iter(batch.values())).shape[0]
        n = B // mb
        if n * mb != B:
            raise ValueError(f"microbatch_size {mb} does not divide the "
                             f"batch of {B}")
        acc, loss_sum = None, 0.0
        for i in range(n):
            part = {k: v[i * mb:(i + 1) * mb] for k, v in batch.items()}
            loss, g = grads_of(params, part, ps, sharded)
            g = [x.to(torch.float32) for x in g]
            acc = g if acc is None else [a + b for a, b in zip(acc, g)]
            loss_sum = loss_sum + loss
        return loss_sum / n, [a / n for a in acc]

    def sharded_grads(params, batch, mesh: Mesh):
        ws = leaves(params)
        if any(not isinstance(w, Sharded) or w.mesh != mesh for w in ws):
            raise ValueError("train_step: under a mesh the state must be "
                             "placed on it: shard_train_state(state, mesh, cfg)")
        ps = [t for w in ws for t in w.parts]
        loss, g = grads_with(params, batch, ps, sharded=True)
        it = iter(g)
        grads = unflatten(params, [Sharded(w.mesh, w.spec, w.shape,
                                           [next(it) for _ in w.parts])
                                   for w in ws])
        return loss, optimizer.reduce_grads(grads)

    def grads_with(params, batch, ps, sharded=False):
        for p in ps:
            p.requires_grad_(True)
        try:
            return compute_grads(params, batch, ps, sharded)
        finally:
            for p in ps:
                p.requires_grad_(False)

    def train_step(state: Dict[str, Any], batch: Dict[str, torch.Tensor]):
        params = state["params"]
        mesh = current_mesh()
        if mesh is not None:
            loss, grads = sharded_grads(params, batch, mesh)
        elif is_sharded(params):
            raise ValueError("train_step: the state is placed on a mesh; "
                             "call the step under activate_mesh(mesh)")
        else:
            ps = leaves(params)
            loss, g = grads_with(params, batch, ps)
            grads = unflatten(params, g)
        metrics: Dict[str, torch.Tensor] = {"loss": loss}
        if use_compress:
            grads, new_err, cm = grad_compress.compress(
                grads, state["err"], method=tcfg.grad_compression,
                ratio=tcfg.compression_ratio)
            metrics.update(cm)
        gnorm = optimizer.global_norm(grads)
        metrics["grad_norm"] = gnorm
        new_params, new_opt, om = optimizer.adamw_update(
            params, grads, state["opt"], tcfg,
            grad_scale=optimizer.clip_scale(gnorm, tcfg.grad_clip))
        metrics.update(om)
        new_state = {"params": new_params, "opt": new_opt}
        if use_compress:
            new_state["err"] = new_err
        return new_state, metrics

    return train_step


def init_train_state(model: Model, tcfg: TrainConfig, seed: int = 0, *,
                     device=None) -> Dict[str, Any]:
    """Parameters from ``model.init(seed, device=...)`` (None means the
    CUDA card), zero moments and step, and the error state when the config
    compresses gradients."""
    params = model.init(seed, device=device)
    state = {"params": params, "opt": optimizer.init_opt_state(params)}
    if tcfg.grad_compression != "none":
        state["err"] = grad_compress.init_error_state(params)
    return state


def train_state_shardings(mesh: Mesh, state: Dict[str, Any], cfg
                          ) -> Dict[str, Any]:
    """The train state's shardings on ``mesh``, the reference's
    ``build_cell``'s: the parameters by ``param_shardings`` with the model
    config ``cfg``'s ``moe_fsdp_params``, the moments and the error state by
    ``zero1_shardings``, the step replicated. ``state`` may hold ``meta``
    tensors (``train_state_specs``)."""
    specs: Dict[str, Any] = {
        "params": param_shardings(mesh, state["params"],
                                  moe_fsdp=cfg.moe_fsdp_params),
        "opt": {"m": zero1_shardings(mesh, state["opt"]["m"]),
                "v": zero1_shardings(mesh, state["opt"]["v"]),
                "step": replicated(mesh)}}
    if "err" in state:
        specs["err"] = zero1_shardings(mesh, state["err"])
    return specs


def shard_train_state(state: Dict[str, Any], mesh: Mesh, cfg
                      ) -> Dict[str, Any]:
    """The train state placed on ``mesh`` by ``train_state_shardings``, as
    ``dryrun.build_cell`` places the reference's. Each leaf becomes a
    ``Sharded``; ``launch.sharding.gather_tree`` gives the whole state
    back."""
    return place_tree(state, mesh, train_state_shardings(mesh, state, cfg))


def train_state_specs(model: Model, tcfg: TrainConfig) -> Dict[str, Any]:
    """The train state's tree with every leaf an empty tensor of its shape
    and type on the ``meta`` device: nothing is allocated (the init runs
    under a fake-tensor mode)."""
    return meta_specs(lambda: init_train_state(model, tcfg, device="cpu"))
