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
one leaf at a time. Each of these exchanges between positions records its
bytes (``launch.collectives``) and makes each position's tensors under
``launch.memory.at``, as the dry run counts them.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.config import TrainConfig
from repro_torch.launch import collectives
from repro_torch.launch.memory import at
from repro_torch.launch.sharding import Sharded, is_sharded
from repro_torch.tree import leaves, map_tree


def init_opt_state(params: Any) -> Dict[str, Any]:
    zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32,  # noqa: E731
                                  device=p.device)
    dev = leaves(params)[0].device
    return {"m": map_tree(zeros, params), "v": map_tree(zeros, params),
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


def clone_tree(tree: Any) -> Any:
    """A copy of a tree of tensors (or of ``Sharded``, part by part),
    detached: what a caller keeps before the in-place update."""
    def one(t):
        if isinstance(t, Sharded):
            return Sharded(t.mesh, t.spec, t.shape,
                           [p.detach().clone() for p in t.parts])
        return t.detach().clone()
    return map_tree(one, tree)


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
        with at(0):
            total = s.to(dev) if total is None else total + s.to(dev)
    collectives.record("all-reduce", total, range(x.mesh.size))
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
            collectives.record("all-reduce", first, group)
            with at(group[0]):
                total = first.to(torch.float32)
                for p in group[1:]:
                    total = total + g.parts[p].to(first.device,
                                                  torch.float32)
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


def _adamw_parts(ps, gs, ms, vs, cfg: TrainConfig, scalars_on):
    """The AdamW step of a list of tensors (one leaf, or the mesh positions'
    slices of one leaf), each operation one ``torch._foreach_*`` call over
    the tensors on one device, so that a leaf costs a few launches whatever
    the number of positions: ``g`` in float32 (times ``grad_scale`` when
    given) updates ``m`` and ``v`` IN PLACE, then the bias-corrected update
    with weight decay. ``scalars_on(dev)`` gives (lr, mhat scale, vhat
    scale, grad_scale or None) on ``dev``. Returns the new ``p``s in their
    own types."""
    b1, b2 = cfg.beta1, cfg.beta2
    out = [None] * len(ps)
    by_dev: Dict[torch.device, list] = {}
    for i, p in enumerate(ps):
        by_dev.setdefault(p.device, []).append(i)
    for dev, idx in by_dev.items():
        lr, mh, vh, grad_scale = scalars_on(dev)
        g32 = [gs[i].to(torch.float32) for i in idx]
        if grad_scale is not None:
            g32 = torch._foreach_mul(g32, grad_scale)
        m = [ms[i] for i in idx]
        v = [vs[i] for i in idx]
        torch._foreach_mul_(m, b1)
        torch._foreach_add_(m, torch._foreach_mul(g32, 1 - b1))
        torch._foreach_mul_(v, b2)
        torch._foreach_add_(v, torch._foreach_mul(
            torch._foreach_mul(g32, 1 - b2), g32))
        p32 = [ps[i].to(torch.float32) for i in idx]
        u = torch._foreach_div(torch._foreach_mul(m, mh), torch._foreach_add(
            torch._foreach_sqrt(torch._foreach_mul(v, vh)), cfg.eps))
        u = torch._foreach_add(u, torch._foreach_mul(p32, cfg.weight_decay))
        new = torch._foreach_sub(p32, torch._foreach_mul(u, lr))
        for i, t in zip(idx, new):
            out[i] = t.to(ps[i].dtype)
    return out


@torch.no_grad()
def adamw_update(params: Any, grads: Any, state: Dict[str, Any],
                 cfg: TrainConfig, *, grad_scale: Optional[torch.Tensor] = None
                 ) -> Tuple[Any, Dict[str, Any], Dict[str, torch.Tensor]]:
    """One AdamW step, IN PLACE on ``params`` and on ``state``'s ``m`` and
    ``v``, one leaf at a time (``_adamw_parts``): each gradient in float32
    (times ``grad_scale``, the clip factor, when given), then the moments,
    the bias-corrected update with weight decay, and the parameter in its
    own type. Returns (params, {"m", "v", "step": step + 1}, {"lr"}). Trees
    of ``Sharded`` leaves take the ZeRO-1 update (``_zero1_update``)."""
    if is_sharded(params):
        return _zero1_update(params, grads, state, cfg, grad_scale)
    step = state["step"] + 1
    lr, mh, vh = _schedule(step, cfg)
    scalars = (lr, mh, vh, grad_scale)
    for p, g, m, v in zip(leaves(params), leaves(grads), leaves(state["m"]),
                          leaves(state["v"])):
        p.copy_(_adamw_parts([p], [g], [m], [v], cfg, lambda _: scalars)[0])
    return params, {"m": state["m"], "v": state["v"], "step": step}, {"lr": lr}


def within(inner, outer) -> Tuple[slice, ...]:
    """``inner``'s block (slices of the global shape) as slices of
    ``outer``'s, which must contain it."""
    out = []
    for a, b in zip(inner, outer):
        if a.start < b.start or a.stop > b.stop:
            raise ValueError("a moment's block lies outside its parameter's "
                             "block on the same position")
        out.append(slice(a.start - b.start, a.stop - b.start))
    return tuple(out)


def _cut(t: torch.Tensor, sub: Tuple[slice, ...]) -> torch.Tensor:
    """``t[sub]``, or ``t`` itself where ``sub`` covers all of it."""
    if all(s.start == 0 and s.stop == n for s, n in zip(sub, t.shape)):
        return t
    return t[sub]


def _zero1_update(params, grads, state, cfg: TrainConfig, grad_scale):
    """``adamw_update`` on a mesh. Position ``pos`` updates the slice of its
    parameter block that its moments hold (``m.region(pos)``, the data axes
    splitting what the parameter's spec leaves whole), from the reduced
    gradient's slice (a gradient laid out as the parameter, or as the
    moments, as compression leaves it); then each holder of a parameter
    block copies in the new slices of the block, one from each distinct
    moment block in mesh order: the all-gather over the data axes. The
    positions' updates of one leaf run together (``_adamw_parts``)."""
    mesh = leaves(params)[0].mesh
    step = state["step"].parts[0] + 1
    lr, mh, vh = _schedule(step, cfg)
    scalars: Dict[torch.device, tuple] = {}
    others = range(1, mesh.size)
    for x in (lr, mh, vh, grad_scale):     # the first position's, sent on
        if x is not None:
            collectives.record("collective-permute", x, others)

    def on(dev):
        if dev not in scalars:
            with at(0):
                scalars[dev] = tuple(None if x is None else x.to(dev)
                                     for x in (lr, mh, vh, grad_scale))
        return scalars[dev]

    pos_range = range(mesh.size)
    for p, g, m, v in zip(leaves(params), leaves(grads), leaves(state["m"]),
                          leaves(state["v"])):
        new = _adamw_parts(
            [_cut(p.parts[pos], within(m.region(pos), p.region(pos)))
             for pos in pos_range],
            [_cut(g.parts[pos], within(m.region(pos), g.region(pos)))
             for pos in pos_range], m.parts, v.parts, cfg, on)
        for group in p.holders():
            firsts = {}
            for r in group:
                firsts.setdefault(tuple((s.start, s.stop)
                                        for s in m.region(r)), r)
            if len(firsts) > 1:         # each holder gathers the slices
                collectives.record("all-gather", p.parts[group[0]], group)
            else:                       # the one updater's block, sent on
                r = next(iter(firsts.values()))
                collectives.record("collective-permute", p.parts[r],
                                   [q for q in group if q != r])
            for pos in group:
                for r in firsts.values():
                    _cut(p.parts[pos], within(m.region(r),
                                              p.region(r))).copy_(new[r])
    collectives.record("collective-permute", step, others)
    copies = []
    for pos, d in enumerate(mesh.devices):
        with at(pos):
            copies.append(step.to(d, copy=True))
    steps = Sharded(mesh, state["step"].spec, (), copies)
    return params, {"m": state["m"], "v": state["v"], "step": steps}, \
        {"lr": lr}
