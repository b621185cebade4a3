"""Name-based sharding rules for the model mesh, and trees placed on it.

Counterpart of the JAX package's ``launch/sharding.py``, with its rules:
``param_pspec`` maps a parameter's name to a partition spec, ``param_shardings``
drops the mesh axes a leaf's dims do not divide and can replicate ``wk`` and
``wv`` when the KV heads do not divide the model width, ``zero1_pspec`` adds
the data axes to the largest free dim of an AdamW moment, and
``data_sharding`` splits a batch over the data axes unless they do not divide
it, and ``cache_shardings`` lays out every family's decode cache. Mesh axes: ("pod", "data", "model") or ("data", "model"); ``pod`` and
``data`` are the data-parallel axes, ``model`` the tensor- and
expert-parallel one.

The port's parameter trees hold one dict per layer where the reference
stacks the layers along a leading dim, so a port leaf has one dim fewer than
the reference's and takes its spec without the leading ``None`` (the ZeRO-1
rule never puts the data axes on the stacked dim of any configuration the
repo names).

Where JAX places an array by a ``NamedSharding``, the port holds a
``Sharded``: the global shape, the spec, and one local tensor per mesh
position on that position's device (``place``, ``place_tree``); ``gather``
and ``gather_tree`` give whole tensors back. The reference's ``constrain``
has no counterpart: the port's sharded layers (``models/layers.py``) are
written per shard and produce the layouts its constraints name.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, List, Optional, Tuple

import torch

from repro_torch.launch.mesh import Mesh
from repro_torch.tree import leaves, leaves_with_paths, path_str, unflatten

DATA_AXES: Tuple[str, ...] = ("pod", "data")
MODEL_AXIS = "model"


class P(tuple):
    """A partition spec: one entry per leading dim, each None (replicated),
    an axis name, or a tuple of axis names (sharded over their product, the
    first major). Trailing dims past the entries are replicated."""

    def __new__(cls, *entries):
        return tuple.__new__(cls, entries)

    def __repr__(self) -> str:
        return "P(" + ", ".join(repr(e) for e in self) + ")"


def axes_of(entry) -> Tuple[str, ...]:
    """The mesh axes of one spec entry, as a tuple."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


@dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh, as ``jax.sharding.NamedSharding``."""
    mesh: Mesh
    spec: P


def _clean_spec(spec, names) -> P:
    out = []
    for s in spec:
        if s is None:
            out.append(None)
        elif isinstance(s, str):
            out.append(s if s in names else None)
        else:
            t = tuple(a for a in s if a in names)
            out.append(t if t else None)
    return P(*out)


def batch_spec(*rest) -> Tuple:
    """Leading batch dim sharded over all data axes."""
    return (DATA_AXES,) + rest


# ---------------------------------------------------------------------------
# parameter sharding rules (name-based; first match wins), the reference's
# ---------------------------------------------------------------------------
def _trail(nd: int, *spec) -> P:
    """A spec with ``spec`` on the trailing len(spec) dims."""
    pad = (None,) * (nd - len(spec))
    return P(*(pad + spec))


def param_pspec(path: str, leaf: Any, *, moe_fsdp: bool = True) -> P:
    """wq/wk/wv (D, H*Dh) and the MLP's w_gate/w_up/wi (D, F): output dim
    over ``model``; wo and w_down/wd: input dim over ``model``; embed (V, D)
    and unembed (D, V): the vocab over ``model``; the MoE's experts (E, D, F)
    and (E, F, D): E over ``model`` and, with ``moe_fsdp``, the second dim
    over the data axes; rwkv6's and mamba2's projections likewise; anything
    else, and every leaf of at most one dim, replicated."""
    nd = leaf.ndim if hasattr(leaf, "ndim") else 0
    name = path.split("/")[-1]
    if nd <= 1:
        return P()
    if name == "embed":
        return _trail(nd, MODEL_AXIS, None)
    if name == "unembed":
        return _trail(nd, None, MODEL_AXIS)
    if name in ("wq", "wk", "wv", "w_kv_cross_k", "w_kv_cross_v"):
        return _trail(nd, None, MODEL_AXIS)
    if name == "wo":
        return _trail(nd, MODEL_AXIS, None)
    if name in ("we_gate", "we_up", "we_down"):
        return _trail(nd, MODEL_AXIS, DATA_AXES if moe_fsdp else None, None)
    if name == "router":
        return P()
    if name in ("w_gate", "w_up", "wi"):
        return _trail(nd, None, MODEL_AXIS)
    if name in ("w_down", "wd"):
        return _trail(nd, MODEL_AXIS, None)
    if name in ("wr", "wk_t", "wv_t", "wg", "w_cm_k"):
        return _trail(nd, None, MODEL_AXIS)
    if name in ("wo_t", "w_cm_v"):
        return _trail(nd, MODEL_AXIS, None)
    if name == "w_in":
        return _trail(nd, None, MODEL_AXIS)
    if name == "w_out":
        return _trail(nd, MODEL_AXIS, None)
    return P()


def _drop_indivisible(spec: P, leaf, mesh: Mesh) -> P:
    """Remove mesh axes from dims they do not divide evenly (a 51865 vocab
    cannot shard 16 ways: that dim is replicated instead)."""
    if not hasattr(leaf, "shape"):
        return spec
    out = []
    for i, s in enumerate(tuple(spec)):
        if s is None:
            out.append(None)
            continue
        width = mesh.axis_size(axes_of(s))
        out.append(s if leaf.shape[i] % width == 0 else None)
    return P(*out)


def _map_with_path(fn, tree):
    return unflatten(tree, [fn(path_str(p), leaf)
                            for p, leaf in leaves_with_paths(tree)])


def param_shardings(mesh: Mesh, params_tree: Any, *, moe_fsdp: bool = True,
                    kv_heads: int = 0) -> Any:
    """A tree of ``NamedSharding``s matching ``params_tree`` (tensors, or
    ``meta`` tensors for shapes only). ``kv_heads``: when > 0 and the model
    width does not divide it, ``wk`` and ``wv`` are replicated instead of
    column-sharded."""
    tp = mesh.shape.get(MODEL_AXIS, 1)
    kv_replicate = kv_heads > 0 and kv_heads % tp != 0

    def one(path, leaf):
        name = path.split("/")[-1]
        if kv_replicate and name in ("wk", "wv"):
            return NamedSharding(mesh, P())
        spec = param_pspec(path, leaf, moe_fsdp=moe_fsdp)
        spec = _clean_spec(tuple(spec), mesh.axis_names)
        return NamedSharding(mesh, _drop_indivisible(spec, leaf, mesh))

    return _map_with_path(one, params_tree)


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def data_sharding(mesh: Mesh, ndim: int,
                  batch_size: Optional[int] = None) -> NamedSharding:
    """The leading dim over the mesh's data axes; replicated when
    ``batch_size`` is given and their width does not divide it."""
    axes = tuple(a for a in DATA_AXES if a in mesh.axis_names)
    if batch_size is not None and axes:
        if batch_size % mesh.axis_size(axes) != 0:
            axes = ()
    return NamedSharding(mesh, P(axes if axes else None,
                                 *([None] * (ndim - 1))))


def zero1_pspec(path: str, leaf: Any, dp_size: int = 0) -> P:
    """An AdamW moment's spec (ZeRO-1): the parameter's spec (with the
    experts' FSDP dim) plus the data axes on the LARGEST free dim that the
    data width divides; the parameter's spec where no dim qualifies."""
    base = tuple(param_pspec(path, leaf))
    nd = leaf.ndim if hasattr(leaf, "ndim") else 0
    base = base + (None,) * (nd - len(base))
    out = list(base)
    if any(s == DATA_AXES for s in out):
        return P(*out)
    if hasattr(leaf, "shape") and dp_size > 0:
        best, best_size = -1, 0
        for i, s in enumerate(out):
            if (s is None and leaf.shape[i] % dp_size == 0
                    and leaf.shape[i] > best_size):
                best, best_size = i, leaf.shape[i]
        if best >= 0:
            out[best] = DATA_AXES
    return P(*out)


def zero1_shardings(mesh: Mesh, params_tree: Any) -> Any:
    dp = mesh.axis_size(DATA_AXES)

    def one(path, leaf):
        spec = zero1_pspec(path, leaf, dp_size=dp)
        spec = _clean_spec(tuple(spec), mesh.axis_names)
        return NamedSharding(mesh, _drop_indivisible(spec, leaf, mesh))

    return _map_with_path(one, params_tree)


KV_LEAVES = ("k", "v", "kv_k", "kv_v", "self_k", "self_v", "cross_k",
             "cross_v")


def cache_shardings(cfg, mesh: Mesh, specs: Any) -> Any:
    """A tree of ``NamedSharding``s matching the cache tree ``specs``
    (tensors or ``meta`` stand-ins) of a model config ``cfg``: the
    reference's name-based rule for every cache leaf of every family.

    - ``KV_LEAVES`` (L, B, S, Hkv, Dh): the batch over the data axes; the KV
      heads over ``model`` when the model width divides ``num_kv_heads``,
      else the sequence over ``model`` (split-KV decode), so the cache never
      replicates;
    - ``wkv`` (L, B, H, K, V) and ``ssd`` (L, B, H, P, N): the heads over
      ``model`` where the width divides them; ``conv``, ``shift_t``,
      ``shift_c``: the batch only; ``lengths`` (B,): the data axes;

    each then dropping the mesh axes a dim does not divide."""
    names = mesh.axis_names
    data = tuple(a for a in DATA_AXES if a in names) or None

    def model_ok(n: int) -> Optional[str]:
        ok = MODEL_AXIS in names and n % mesh.shape[MODEL_AXIS] == 0
        return MODEL_AXIS if ok else None

    def rule(path: str) -> P:
        name = path.split("/")[-1]
        if name in KV_LEAVES:
            h_ax = model_ok(cfg.num_kv_heads)
            s_ax = MODEL_AXIS if h_ax is None and MODEL_AXIS in names else None
            return P(None, data, s_ax, h_ax, None)
        if name == "wkv":
            return P(None, data,
                     model_ok(cfg.d_model // max(cfg.rwkv_head_size, 1)))
        if name == "ssd":
            return P(None, data,
                     model_ok(cfg.d_inner // max(cfg.ssm_head_dim, 1)))
        if name in ("conv", "shift_t", "shift_c"):
            return P(None, data)
        if name == "lengths":
            return P(data)
        return P()

    return _map_with_path(lambda path, leaf: NamedSharding(
        mesh, _drop_indivisible(rule(path), leaf, mesh)), specs)


# ---------------------------------------------------------------------------
# trees placed on a mesh
# ---------------------------------------------------------------------------
def spec_axes(spec) -> Tuple[str, ...]:
    """Every mesh axis ``spec`` shards some dim over."""
    return tuple(a for e in spec for a in axes_of(e))


def shard_region(shape, spec, mesh: Mesh, pos: int) -> Tuple[slice, ...]:
    """The block of a global ``shape`` that position ``pos`` holds under
    ``spec``: one slice per dim."""
    out = []
    for i, n in enumerate(shape):
        axes = axes_of(spec[i]) if i < len(spec) else ()
        k = mesh.axis_size(axes)
        if n % k:
            raise ValueError(f"dim {i} of {tuple(shape)} does not divide "
                             f"over {axes} ({k} shards)")
        size = n // k
        idx = mesh.index_over(pos, axes)
        out.append(slice(idx * size, (idx + 1) * size))
    return tuple(out)


class Sharded:
    """A tensor of global ``shape`` laid out on ``mesh`` by ``spec``:
    ``parts[pos]`` is position ``pos``'s block (``region(pos)``), on
    ``mesh.devices[pos]``. The positions that hold one block
    (``holders()``) each hold their own tensor, as the devices of a JAX
    mesh each hold their own buffer."""

    __slots__ = ("mesh", "spec", "shape", "parts")

    def __init__(self, mesh: Mesh, spec, shape, parts):
        self.mesh, self.spec = mesh, P(*spec)
        self.shape = tuple(shape)
        self.parts = list(parts)
        if len(self.parts) != mesh.size:
            raise ValueError(f"{len(self.parts)} parts for a mesh of "
                             f"{mesh.size} positions")

    @property
    def dtype(self) -> torch.dtype:
        return self.parts[0].dtype

    def region(self, pos: int) -> Tuple[slice, ...]:
        return shard_region(self.shape, self.spec, self.mesh, pos)

    def holders(self) -> List[List[int]]:
        """The positions grouped by the block they hold, in mesh order."""
        used = spec_axes(self.spec)
        return self.mesh.groups([a for a in self.mesh.axis_names
                                 if a not in used])

    def __repr__(self) -> str:
        return (f"Sharded(shape={self.shape}, spec={self.spec}, "
                f"dtype={self.dtype}, mesh={self.mesh.shape})")


def place(x: torch.Tensor, mesh: Mesh, spec) -> Sharded:
    """``x`` laid out on ``mesh`` by ``spec`` (a ``P`` or a
    ``NamedSharding``): each position's block copied to its device as a
    contiguous tensor of ``x``'s type."""
    if isinstance(spec, NamedSharding):
        spec = spec.spec
    spec = _clean_spec(tuple(spec), mesh.axis_names)
    parts = []
    for pos, dev in enumerate(mesh.devices):
        block = x[shard_region(x.shape, spec, mesh, pos)]
        parts.append(torch.empty(block.shape, dtype=x.dtype,
                                 device=dev).copy_(block))
    return Sharded(mesh, spec, x.shape, parts)


def place_tree(tree: Any, mesh: Mesh, specs: Any) -> Any:
    """Every leaf of ``tree`` placed by the matching leaf of ``specs`` (a
    tree of the same structure whose leaves are ``P``s or
    ``NamedSharding``s)."""
    return unflatten(tree, [place(x, mesh, s)
                            for x, s in zip(leaves(tree), _spec_leaves(specs))])


def _spec_leaves(specs) -> List[Any]:
    """The leaves of a tree of specs: a ``P`` is a tuple, so it is one leaf,
    not a subtree."""
    if isinstance(specs, (P, NamedSharding)):
        return [specs]
    if isinstance(specs, dict):
        return [s for k in sorted(specs) for s in _spec_leaves(specs[k])]
    if isinstance(specs, (list, tuple)):
        return [s for v in specs for s in _spec_leaves(v)]
    return [specs]


def gather(x: Sharded, device=None) -> torch.Tensor:
    """The whole tensor on ``device`` (the first position's by default),
    each block read from its first holder."""
    dev = x.parts[0].device if device is None else torch.device(device)
    out = torch.empty(x.shape, dtype=x.dtype, device=dev)
    for group in x.holders():
        out[x.region(group[0])].copy_(x.parts[group[0]].detach())
    return out


def gather_tree(tree: Any, device=None) -> Any:
    """``gather`` of every ``Sharded`` leaf; other leaves as they are."""
    return unflatten(tree, [gather(x, device) if isinstance(x, Sharded)
                            else x for x in leaves(tree)])


def is_sharded(tree: Any) -> bool:
    """Whether any leaf of ``tree`` is ``Sharded``."""
    return any(isinstance(x, Sharded) for x in leaves(tree))
