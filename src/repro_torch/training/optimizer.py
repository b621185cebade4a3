"""AdamW with warmup + cosine schedule.

Counterpart of the JAX package's ``training/optimizer.py``, with its
semantics: an int32 step, float32 ``m`` and ``v``, bias correction by ``1 -
b^t``, weight decay on every leaf, the update in float32 cast to the
parameter's type, and the ``lr`` metric. Unlike the reference, which returns
new trees, ``adamw_update`` works one tensor at a time and updates the
parameters, ``m`` and ``v`` IN PLACE: a whole-tree float32 copy would not fit
beside phi3-mini's states on one card. A caller that keeps an older state
must clone it (``clone_tree``).

On a model mesh the trees hold ``launch.sharding.Sharded`` leaves, and the
step is ZeRO-1, as the reference's jitted step is with ``zero1_shardings``
at its boundary: ``reduce_grads`` sums each gradient block over the
positions that hold it, ``global_norm`` counts each element once, and
``adamw_update`` has each position update the slice of its parameter block
that its moments hold (the data axes split them) and then gathers the
block's slices back into every holder's parameter, with the same arithmetic
one leaf at a time.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.config import TrainConfig
from repro_torch.launch.sharding import Sharded, is_sharded
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


def _sum_squares(x) -> torch.Tensor:
    """A leaf's float32 sum of squares; a ``Sharded`` leaf's over its
    blocks, each block once (from its first holder), on the first
    position's device."""
    if not isinstance(x, Sharded):
        return torch.sum(torch.square(x.to(torch.float32)))
    dev = x.parts[0].device
    total = None
    for group in x.holders():
        s = torch.sum(torch.square(x.parts[group[0]].to(torch.float32)))
        total = s.to(dev) if total is None else total + s.to(dev)
    return total


def global_norm(tree: Any) -> torch.Tensor:
    """sqrt of the sum over leaves of each leaf's float32 sum of squares:
    every element counted once, a replicated leaf's too."""
    return torch.sqrt(torch.sum(torch.stack([_sum_squares(x)
                                             for x in leaves(tree)])))


def reduce_grads(grads: Any) -> Any:
    """A tree of ``Sharded`` gradients, each position's part its own
    contribution, -> each part the sum over the positions that hold its
    block, IN PLACE: in float32, in mesh order on the group's first device,
    written back in the parts' type into the first part and copied into the
    others. Returns the tree."""
    for g in leaves(grads):
        for group in g.holders():
            if len(group) < 2:
                continue
            first = g.parts[group[0]]
            total = first.to(torch.float32)
            for p in group[1:]:
                total = total + g.parts[p].to(first.device, torch.float32)
            first.copy_(total)
            for p in group[1:]:
                g.parts[p].copy_(first)
    return grads


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


def _schedule(step: torch.Tensor, cfg: TrainConfig):
    """(lr, 1 / (1 - b1^t), 1 / (1 - b2^t)) at ``step``, float32."""
    t = step.to(torch.float32)
    return (lr_schedule(step, cfg), 1.0 / (1 - torch.pow(cfg.beta1, t)),
            1.0 / (1 - torch.pow(cfg.beta2, t)))


def _adamw_tensor(p, g, m, v, cfg: TrainConfig, lr, mhat_scale, vhat_scale,
                  grad_scale):
    """One tensor's AdamW step: ``g`` in float32 (times ``grad_scale`` when
    given) updates ``m`` and ``v`` IN PLACE; returns the new ``p`` (the
    bias-corrected update with weight decay) in ``p``'s type."""
    b1, b2 = cfg.beta1, cfg.beta2
    g32 = g.to(torch.float32)
    if grad_scale is not None:
        g32 = g32 * grad_scale
    m.mul_(b1).add_((1 - b1) * g32)
    v.mul_(b2).add_((1 - b2) * g32 * g32)
    p32 = p.to(torch.float32)
    u = (m * mhat_scale) / (torch.sqrt(v * vhat_scale) + cfg.eps)
    u = u + cfg.weight_decay * p32
    return (p32 - lr * u).to(p.dtype)


@torch.no_grad()
def adamw_update(params: Any, grads: Any, state: Dict[str, Any],
                 cfg: TrainConfig, *, grad_scale: Optional[torch.Tensor] = None
                 ) -> Tuple[Any, Dict[str, Any], Dict[str, torch.Tensor]]:
    """One AdamW step, IN PLACE on ``params`` and on ``state``'s ``m`` and
    ``v``, one leaf at a time (``_adamw_tensor``): each gradient in float32
    (times ``grad_scale``, the clip factor, when given), then the moments,
    the bias-corrected update with weight decay, and the parameter in its
    own type. Returns (params, {"m", "v", "step": step + 1}, {"lr"}). Trees
    of ``Sharded`` leaves take the ZeRO-1 update (``_zero1_update``)."""
    if is_sharded(params):
        return _zero1_update(params, grads, state, cfg, grad_scale)
    step = state["step"] + 1
    lr, mh, vh = _schedule(step, cfg)
    for p, g, m, v in zip(leaves(params), leaves(grads), leaves(state["m"]),
                          leaves(state["v"])):
        p.copy_(_adamw_tensor(p, g, m, v, cfg, lr, mh, vh, grad_scale))
    return params, {"m": state["m"], "v": state["v"], "step": step}, {"lr": lr}


def _within(inner, outer) -> Tuple[slice, ...]:
    """``inner``'s block (slices of the global shape) as slices of
    ``outer``'s, which must contain it."""
    out = []
    for a, b in zip(inner, outer):
        if a.start < b.start or a.stop > b.stop:
            raise ValueError("a moment's block lies outside its parameter's "
                             "block on the same position")
        out.append(slice(a.start - b.start, a.stop - b.start))
    return tuple(out)


def _zero1_update(params, grads, state, cfg: TrainConfig, grad_scale):
    """``adamw_update`` on a mesh. Position ``pos`` updates the slice of its
    parameter block that its moments hold (``m.region(pos)``, the data axes
    splitting what the parameter's spec leaves whole), from the reduced
    gradient's slice; then each holder of a parameter block copies in the
    new slices of the block, one from each distinct moment block in mesh
    order: the all-gather over the data axes."""
    mesh = leaves(params)[0].mesh
    step = state["step"].parts[0] + 1
    lr, mh, vh = _schedule(step, cfg)
    scalars: Dict[torch.device, tuple] = {}

    def on(dev):
        if dev not in scalars:
            scalars[dev] = tuple(None if x is None else x.to(dev)
                                 for x in (lr, mh, vh, grad_scale))
        return scalars[dev]

    for p, g, m, v in zip(leaves(params), leaves(grads), leaves(state["m"]),
                          leaves(state["v"])):
        new = []
        for pos in range(mesh.size):
            sub = _within(m.region(pos), p.region(pos))
            new.append(_adamw_tensor(p.parts[pos][sub], g.parts[pos][sub],
                                     m.parts[pos], v.parts[pos], cfg,
                                     *on(p.parts[pos].device)))
        for group in p.holders():
            firsts = {}
            for r in group:
                firsts.setdefault(tuple((s.start, s.stop)
                                        for s in m.region(r)), r)
            for pos in group:
                for r in firsts.values():
                    sub = _within(m.region(r), p.region(r))
                    p.parts[pos][sub].copy_(new[r])
    steps = Sharded(mesh, state["step"].spec, (), [
        step.to(d, copy=True) for d in mesh.devices])
    return params, {"m": state["m"], "v": state["v"], "step": steps}, \
        {"lr": lr}
