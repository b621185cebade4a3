"""AdamW with warmup + cosine schedule.

Counterpart of the JAX package's ``training/optimizer.py``, with its
semantics: an int32 step, float32 ``m`` and ``v``, bias correction by ``1 -
b^t``, weight decay on every leaf, the update in float32 cast to the
parameter's type, and the ``lr`` metric. Unlike the reference, which returns
new trees, ``adamw_update`` works one tensor at a time and updates the
parameters, ``m`` and ``v`` IN PLACE: a whole-tree float32 copy would not fit
beside phi3-mini's states on one card. A caller that keeps an older state
must clone it (``clone_tree``). The ZeRO-1 placement of the moments needs a
mesh the port does not have.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.config import TrainConfig
from repro_torch.tree import leaves, map_tree


def init_opt_state(params: Any) -> Dict[str, Any]:
    zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32,  # noqa: E731
                                  device=p.device)
    dev = leaves(params)[0].device
    return {"m": map_tree(zeros, params), "v": map_tree(zeros, params),
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


def clone_tree(tree: Any) -> Any:
    """A copy of a tree of tensors, detached: what a caller keeps before
    the in-place update."""
    return map_tree(lambda t: t.detach().clone(), tree)


def lr_schedule(step, cfg: TrainConfig) -> torch.Tensor:
    """Linear warmup to ``learning_rate`` over ``warmup_steps``, then a
    cosine to 0.1 x of it at ``total_steps``; float32, on the step's
    device."""
    step = torch.as_tensor(step)
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    progress = torch.clamp(
        (step - cfg.warmup_steps) / max(cfg.total_steps - cfg.warmup_steps, 1),
        0.0, 1.0)
    cosine = 0.5 * (1.0 + torch.cos(math.pi * progress))
    return cfg.learning_rate * warm * (0.1 + 0.9 * cosine)


def global_norm(tree: Any) -> torch.Tensor:
    """sqrt of the sum over leaves of each leaf's float32 sum of squares."""
    sums = [torch.sum(torch.square(x.to(torch.float32))) for x in leaves(tree)]
    return torch.sqrt(torch.sum(torch.stack(sums)))


def clip_scale(norm: torch.Tensor, max_norm: float) -> torch.Tensor:
    return torch.clamp(max_norm / (norm + 1e-9), max=1.0)


def clip_by_global_norm(grads: Any, max_norm: float) -> Tuple[Any,
                                                               torch.Tensor]:
    """(the gradients in float32 times ``min(1, max_norm / (norm +
    1e-9))``, the global norm). The train step does not build this tree: it
    passes the scale to ``adamw_update``, which applies it one tensor at a
    time, with the same arithmetic."""
    norm = global_norm(grads)
    scale = clip_scale(norm, max_norm)
    return map_tree(lambda g: g.to(torch.float32) * scale, grads), norm


@torch.no_grad()
def adamw_update(params: Any, grads: Any, state: Dict[str, Any],
                 cfg: TrainConfig, *, grad_scale: Optional[torch.Tensor] = None
                 ) -> Tuple[Any, Dict[str, Any], Dict[str, torch.Tensor]]:
    """One AdamW step, IN PLACE on ``params`` and on ``state``'s ``m`` and
    ``v``, one leaf at a time: each gradient in float32 (times
    ``grad_scale``, the clip factor, when given), then the moments, the
    bias-corrected update with weight decay, and the parameter in its own
    type. Returns (params, {"m", "v", "step": step + 1}, {"lr"})."""
    step = state["step"] + 1
    lr = lr_schedule(step, cfg)
    b1, b2, eps, wd = cfg.beta1, cfg.beta2, cfg.eps, cfg.weight_decay
    t = step.to(torch.float32)
    mhat_scale = 1.0 / (1 - torch.pow(b1, t))
    vhat_scale = 1.0 / (1 - torch.pow(b2, t))
    for p, g, m, v in zip(leaves(params), leaves(grads), leaves(state["m"]),
                          leaves(state["v"])):
        g32 = g.to(torch.float32)
        if grad_scale is not None:
            g32 = g32 * grad_scale
        m.mul_(b1).add_((1 - b1) * g32)
        v.mul_(b2).add_((1 - b2) * g32 * g32)
        p32 = p.to(torch.float32)
        u = (m * mhat_scale) / (torch.sqrt(v * vhat_scale) + eps)
        u = u + wd * p32
        p.copy_((p32 - lr * u).to(p.dtype))
    return params, {"m": state["m"], "v": state["v"], "step": step}, {"lr": lr}
