"""Lockstep SPMD over a mesh in one process: ``shard_map`` and the
collectives.

The JAX package runs a body per device under ``shard_map``, and its
collectives (``psum``, ``pmean``, ``all_gather``, ``axis_index``) meet
across the devices. The port has one process and no ``torch.distributed``:
a sharded value is a list with one tensor per mesh position (on that
position's device), a body is written over such lists, and each step of it
runs for every position before the next step starts, so a collective finds
every position's value ready. A collective copies the group's tensors to
the group's first device, sums them there in fixed mesh order, and copies
the result back to each member: the bits are the same whether the mesh
repeats one card or spans four. ``psum`` and ``all_gather`` are autograd
functions whose backward is the same fixed-order sum (``all_gather``'s
then sliced: a reduce-scatter).
"""
from __future__ import annotations

from typing import Any, Callable, List, Sequence, Tuple

import torch

from repro_torch.launch.mesh import Mesh
from repro_torch.launch.sharding import (P, Sharded, _clean_spec, axes_of,
                                         place)
from repro_torch.tree import leaves, unflatten


def _axes(mesh: Mesh, axes) -> Tuple[str, ...]:
    axes = (axes,) if isinstance(axes, str) else tuple(axes)
    return tuple(a for a in axes if a in mesh.axis_names)


def _sum_to(xs: Sequence[torch.Tensor], devs) -> Tuple[torch.Tensor, ...]:
    """The sum of ``xs`` on the first one's device, in order, then a copy on
    each device of ``devs`` (the first gets the sum itself)."""
    total = xs[0]
    for x in xs[1:]:
        total = total + x.to(total.device)
    return (total,) + tuple(total.to(d, copy=True) for d in devs[1:])


class _PSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, *xs):
        ctx.devs = [x.device for x in xs]
        return _sum_to(xs, ctx.devs)

    @staticmethod
    def backward(ctx, *gs):
        return _sum_to(gs, ctx.devs)


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, dim, *xs):
        ctx.dim, ctx.devs = dim, [x.device for x in xs]
        ctx.sizes = [x.shape[dim] for x in xs]
        whole = torch.cat([x.to(xs[0].device) for x in xs], dim)
        return (whole,) + tuple(whole.to(d, copy=True) for d in ctx.devs[1:])

    @staticmethod
    def backward(ctx, *gs):
        total = _sum_to(gs, ctx.devs[:1])[0]
        parts = torch.split(total, ctx.sizes, ctx.dim)
        return (None,) + tuple(p.to(d, copy=True)
                               for p, d in zip(parts, ctx.devs))


def psum(xs: List[torch.Tensor], mesh: Mesh, axes) -> List[torch.Tensor]:
    """Each position's tensor replaced by the sum over its group along
    ``axes`` (axes the mesh lacks are dropped; a group of one is left as
    it is)."""
    axes = _axes(mesh, axes)
    out = list(xs)
    if not axes:
        return out
    for group in mesh.groups(axes):
        if len(group) > 1:
            for pos, y in zip(group, _PSum.apply(*(xs[p] for p in group))):
                out[pos] = y
    return out


def pmean(xs: List[torch.Tensor], mesh: Mesh, axes) -> List[torch.Tensor]:
    n = mesh.axis_size(_axes(mesh, axes))
    return [x / n for x in psum(xs, mesh, axes)] if n > 1 else list(xs)


def pmax(xs: List[torch.Tensor], mesh: Mesh, axes) -> List[torch.Tensor]:
    """The elementwise max over each group, detached (it only shifts a
    log-sum-exp, whose gradient does not depend on the shift)."""
    axes = _axes(mesh, axes)
    out = [x.detach() for x in xs]
    for group in (mesh.groups(axes) if axes else []):
        top = out[group[0]]
        for p in group[1:]:
            top = torch.maximum(top, out[p].to(top.device))
        for p in group:
            out[p] = top.to(mesh.devices[p], copy=True)
    return out


def all_gather(xs: List[torch.Tensor], mesh: Mesh, axes,
               dim: int) -> List[torch.Tensor]:
    """Each position's tensor replaced by its group's along ``axes``
    concatenated on ``dim`` in group order (``tiled=True``)."""
    axes = _axes(mesh, axes)
    out = list(xs)
    if not axes:
        return out
    for group in mesh.groups(axes):
        if len(group) > 1:
            ys = _AllGather.apply(dim, *(xs[p] for p in group))
            for pos, y in zip(group, ys):
                out[pos] = y
    return out


class _Remat(torch.autograd.Function):
    """One autograd node for a whole lockstep body: the forward runs it
    without keeping activations; the backward runs it again with them, its
    collectives included, and differentiates that run. One node, so one
    thread recomputes it, however many devices its backward spans."""

    @staticmethod
    def forward(ctx, run, *tensors):
        ctx.run = run
        ctx.save_for_backward(*tensors)
        with torch.no_grad():
            return tuple(run(list(tensors)))

    @staticmethod
    def backward(ctx, *gs):
        inputs = [t.detach().requires_grad_(t.requires_grad)
                  for t in ctx.saved_tensors]
        with torch.enable_grad():
            outs = ctx.run(inputs)
        pairs = [(o, g) for o, g in zip(outs, gs) if o.requires_grad]
        want = [i for i in inputs if i.requires_grad]
        got = iter(torch.autograd.grad([o for o, _ in pairs], want,
                                       [g for _, g in pairs],
                                       allow_unused=True)
                   if pairs and want else ())
        return (None,) + tuple(next(got) if i.requires_grad else None
                               for i in inputs)


def remat(run: Callable[[List[torch.Tensor]], List[torch.Tensor]],
          tensors: List[torch.Tensor]) -> List[torch.Tensor]:
    """``run(tensors)``, a lockstep body from a flat list of tensors to a
    flat list of tensors, with its activations recomputed in the backward
    pass (the reference's ``jax.checkpoint`` around a body with
    collectives). ``torch.utils.checkpoint`` is not used here: its
    recompute starts from whichever device's autograd thread first needs a
    saved tensor, and two such threads could both start it."""
    return list(_Remat.apply(run, *tensors))


def axis_index(mesh: Mesh, pos: int, axis: str) -> int:
    """Position ``pos``'s index along ``axis`` (0 for an absent axis)."""
    return mesh.coord(pos, axis)


def each(fn: Callable, *lists) -> List[Any]:
    """``fn`` at every position, over the positions' entries of ``lists``:
    one step of a lockstep body."""
    return [fn(*args) for args in zip(*lists)]


def whole(x: Sharded) -> List[torch.Tensor]:
    """Every position's copy of all of ``x``: its blocks all-gathered over
    each axis its spec shards, last dim first."""
    parts = list(x.parts)
    for dim in reversed(range(len(x.spec))):
        axes = axes_of(x.spec[dim])
        if axes:
            parts = all_gather(parts, x.mesh, axes, dim)
    return parts


def global_shape(local_shape, spec, mesh: Mesh) -> Tuple[int, ...]:
    return tuple(n * (mesh.axis_size(axes_of(spec[i])) if i < len(spec)
                      else 1) for i, n in enumerate(local_shape))


def shard_map(fn: Callable, mesh: Mesh, in_specs, out_specs) -> Callable:
    """The lockstep counterpart of ``shard_map``: the returned function
    places each argument by its ``in_specs`` entry (a tree of whole tensors
    and one ``P`` for every leaf; an argument that is already a tree of
    ``Sharded`` is passed as it is), calls ``fn`` once with them, and wraps
    each per-position list that ``fn`` returns as a ``Sharded`` by its
    ``out_specs`` entry. ``fn`` is written over per-position lists (``each``
    and the collectives), so every step of it runs at every position before
    the next."""
    def run(*args):
        placed = []
        for a, spec in zip(args, in_specs):
            ls = leaves(a)
            if ls and all(isinstance(x, Sharded) for x in ls):
                placed.append(a)
            else:
                placed.append(unflatten(a, [place(x, mesh, spec)
                                            for x in ls]))
        outs = fn(*placed)
        single = not isinstance(out_specs, (list, tuple)) or isinstance(
            out_specs, P)
        if single:
            outs, specs = (outs,), (out_specs,)
        else:
            specs = out_specs
        wrapped = []
        for parts, spec in zip(outs, specs):
            spec = _clean_spec(tuple(spec), mesh.axis_names)
            wrapped.append(Sharded(mesh, spec, global_shape(
                parts[0].shape, spec, mesh), parts))
        return wrapped[0] if single else tuple(wrapped)

    return run
