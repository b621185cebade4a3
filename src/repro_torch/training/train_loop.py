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
"""
from __future__ import annotations

from typing import Any, Callable, Dict

import torch

from repro_torch.config import TrainConfig
from repro_torch.models.factory import Model
from repro_torch.training import grad_compress, optimizer
from repro_torch.tree import leaves, map_tree, unflatten


def make_train_step(model: Model, tcfg: TrainConfig) -> Callable:
    """Returns train_step(state, batch) -> (state, metrics): metrics
    ``loss``, ``compress_ratio`` (with compression), ``grad_norm`` (before
    clipping) and ``lr``.

    Microbatching splits the batch along dim 0 into ``microbatch_size``
    slices, accumulates their gradients in float32 and divides by their
    number; the loss is the mean of the slices' losses. The parameters
    require grad only inside the step."""
    use_compress = tcfg.grad_compression != "none"

    def grads_of(params, batch, ps):
        loss, _ = model.loss(params, batch)
        return loss.detach(), torch.autograd.grad(loss, ps)

    def compute_grads(params, batch, ps):
        mb = tcfg.microbatch_size
        if not mb or mb <= 0:
            return grads_of(params, batch, ps)
        B = next(iter(batch.values())).shape[0]
        n = B // mb
        if n * mb != B:
            raise ValueError(f"microbatch_size {mb} does not divide the "
                             f"batch of {B}")
        acc, loss_sum = None, 0.0
        for i in range(n):
            part = {k: v[i * mb:(i + 1) * mb] for k, v in batch.items()}
            loss, g = grads_of(params, part, ps)
            g = [x.to(torch.float32) for x in g]
            acc = g if acc is None else [a + b for a, b in zip(acc, g)]
            loss_sum = loss_sum + loss
        return loss_sum / n, [a / n for a in acc]

    def train_step(state: Dict[str, Any], batch: Dict[str, torch.Tensor]):
        params = state["params"]
        ps = leaves(params)
        for p in ps:
            p.requires_grad_(True)
        try:
            loss, g = compute_grads(params, batch, ps)
        finally:
            for p in ps:
                p.requires_grad_(False)
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


def train_state_specs(model: Model, tcfg: TrainConfig) -> Dict[str, Any]:
    """The train state's tree with every leaf an empty tensor of its shape
    and type on the ``meta`` device: nothing is allocated (the init runs
    under a fake-tensor mode)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    with FakeTensorMode():
        fake = init_train_state(model, tcfg, device="cpu")
    return map_tree(lambda t: torch.empty(t.shape, dtype=t.dtype,
                                          device="meta"), fake)
