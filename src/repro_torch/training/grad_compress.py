"""Gradient compression with error feedback.

Counterpart of the JAX package's ``training/grad_compress.py``:

  * topk  - per-tensor magnitude top-k with error feedback: the threshold is
            the k-th largest |g| (k = max(int(n * ratio), 1)) and every entry
            with |g| >= it is kept, so ties keep more; what is dropped
            carries to the next step.
  * int8  - per-tensor symmetric quantization, scale max|g| / 127 + 1e-12,
            round half to even, clipped to [-127, 127].

A "tensor" is a leaf of the reference's tree, where the layers are stacked
along a leading axis: one weight across all layers. The port keeps a list of
per-layer tensors, so it groups them back (``layers/0/attn/wq``,
``layers/1/attn/wq``, ... are one tensor) before taking the threshold or the
scale. The ``compress_ratio`` metric takes the reference's values: 1 (none),
ratio x 8 / 2 (topk: 4-byte indices and values against 2-byte dense), 0.5
(int8).
On one card there is no all-reduce to shrink; the arithmetic, and so the
training it gives, is the reference's.

On a model mesh (trees of ``launch.sharding.Sharded``) the compression runs
in the ZeRO-1 blocks: each position takes the slice of its reduced gradient
block that its error block holds (``err`` is laid out by
``zero1_shardings``, the gradients as the parameters), so ``g + err`` and
``g - comp`` pair the same elements, and the compressed gradients and the
new error state come back in the error state's layout. The threshold and
the scale are the whole group's, exactly, with no whole copy of a leaf on
any device: each block is read from its first holder only
(``Sharded.holders()``), so a replicated block counts once. The scale is
the max of the blocks' maxima. The threshold is a radix select on the bit
patterns, which order non-negative float32 values as the values: one pass
counts each group's |g| by their top 15 bits, which gives the bin of the
k-th largest and how many of the bin it needs; a second counts that bin's
elements by their low 16 bits, which gives the rest of the pattern, bit for
bit ``torch.topk``'s k-th value. The counts are exact int64 sums
(``index_add_``), and a device bins its elements in runs of ``_CHUNK``
keys: beside the blocks, the select holds three int32 tensors of a run
(192 MiB) and two histograms of 256 KiB and 512 KiB a group on a device,
whatever the model's size.
"""
from __future__ import annotations

import math
from typing import Any, Dict, List, Tuple

import torch

from repro_torch.launch.sharding import Sharded, is_sharded
from repro_torch.training.optimizer import within
from repro_torch.tree import leaves, leaves_with_paths, map_tree, unflatten

_ABS = 0x7FFFFFFF          # a float32's bits with the sign cleared: |x|'s
_HI = 1 << 15              # the first pass's bins: a pattern's top 15 bits
_LO = 1 << 16              # the second's: its low 16 bits
_CHUNK = 1 << 24           # keys a device bins at once


def init_error_state(params: Any) -> Any:
    return map_tree(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params)


def stacked_groups(tree: Any) -> List[List[int]]:
    """Indices of ``tree``'s leaves (flattening order), grouped by the
    reference's stacked leaf: the path without its list indices."""
    groups: Dict[Tuple, List[int]] = {}
    for i, (path, _) in enumerate(leaves_with_paths(tree)):
        key = tuple(p for p in path if not isinstance(p, int))
        groups.setdefault(key, []).append(i)
    return list(groups.values())


def _topk_group(gs: List[torch.Tensor], ratio: float) -> List[torch.Tensor]:
    flat = torch.cat([g.reshape(-1) for g in gs])
    k = max(int(flat.shape[0] * ratio), 1)
    thresh = torch.topk(torch.abs(flat), k).values[-1]
    return [g * (torch.abs(g) >= thresh) for g in gs]


def _int8_group(gs: List[torch.Tensor]) -> List[torch.Tensor]:
    top = torch.max(torch.stack([torch.max(torch.abs(g)) for g in gs]))
    scale = top / 127.0 + 1e-12
    return [torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
            .to(torch.float32) * scale for g in gs]


def _owned(x: Sharded) -> List[int]:
    """The positions that read ``x``'s blocks: each block's first holder."""
    return [group[0] for group in x.holders()]


def _batches(pieces: list) -> list:
    """``pieces`` ((group, int32 tensor) pairs of at most ``_CHUNK``
    elements each) as runs of consecutive pieces of at most ``_CHUNK``
    elements in all: (first index, last index + 1) pairs."""
    runs, start, n = [], 0, 0
    for i, (_, x) in enumerate(pieces):
        if i > start and n + x.numel() > _CHUNK:
            runs.append((start, i))
            start, n = i, 0
        n += x.numel()
    return runs + [(start, len(pieces))]


def _bins(blocks: List[Sharded], groups: List[List[int]], width: int,
          shift: int, low=None) -> torch.Tensor:
    """(G, width) int64 on the mesh's first device: each group's count of
    its elements' keys, each element once (from its block's first holder).
    The key is |x|'s bit pattern shifted right by ``shift``; with ``low``
    ((G,) int32, a group's lowest counted key), key - low + 1 clamped to
    [0, width - 1], so that columns 0 and width - 1 take what lies below
    and above. A device's pieces go in runs of at most ``_CHUNK``
    elements, each run one ``cat`` into int32 keys, offset by their
    group's ``g * width`` and counted by ``index_add_``: a few launches a
    run, whatever the number of blocks."""
    mesh = blocks[0].mesh
    G = len(groups)
    if G * width >= 1 << 31:
        raise ValueError(f"{G} groups overflow the int32 keys")
    todo: Dict[torch.device, list] = {}
    for g, idx in enumerate(groups):
        for i in idx:
            for pos in _owned(blocks[i]):
                flat = blocks[i].parts[pos].reshape(-1).view(torch.int32)
                for s in range(0, flat.numel(), _CHUNK):
                    todo.setdefault(flat.device, []).append(
                        (g, flat[s:s + _CHUNK]))
    total = torch.zeros(G * width, dtype=torch.int64, device=mesh.devices[0])
    for dev, pieces in todo.items():
        hist = torch.zeros(G * width, dtype=torch.int64, device=dev)
        one = torch.ones((), dtype=torch.int64, device=dev)
        at = None if low is None else (low - 1).to(dev)
        # each piece's group and length, one copy to the device
        meta = torch.tensor([[g, x.numel()] for g, x in pieces],
                            dtype=torch.int32).to(dev)
        for a, b in _batches(pieces):
            key = torch.cat([x for _, x in pieces[a:b]])
            gid = torch.repeat_interleave(meta[a:b, 0], meta[a:b, 1],
                                          output_size=key.numel())
            key.bitwise_and_(_ABS)
            if shift:
                key.bitwise_right_shift_(shift)
            if at is not None:
                key.sub_(at[gid]).clamp_(0, width - 1)
            key.add_(gid * width)
            hist.index_add_(0, key, one.expand(key.numel()))
        total += hist.to(total.device)
    return total.view(G, width)


def _select(hist: torch.Tensor, need: torch.Tensor):
    """Per group (a row of ``hist``, (G, bins) counts), the highest bin b
    whose count from b up reaches ``need``, and ``need`` less the count
    above b: (b, what b must still give), int64 (G,) each."""
    above = torch.flip(torch.cumsum(torch.flip(hist, (1,)), 1), (1,))
    b = torch.sum(above >= need[:, None], 1) - 1
    over = torch.cat([above, torch.zeros_like(above[:, :1])], 1)
    return b, need - torch.gather(over, 1, (b + 1)[:, None])[:, 0]


def _thresholds(blocks: List[Sharded], groups: List[List[int]],
                ratio: float) -> torch.Tensor:
    """Each group's k-th largest |g| (float32 (G,), on the mesh's first
    device), each element of ``blocks`` counted once, by the radix select of
    the module's docstring."""
    kth = torch.tensor([max(int(sum(math.prod(blocks[i].shape)
                                     for i in idx) * ratio), 1)
                         for idx in groups], dtype=torch.int64,
                       device=blocks[0].mesh.devices[0])
    hi, need = _select(_bins(blocks, groups, _HI, 16), kth)
    top = (hi << 16).to(torch.int32)
    lo, _ = _select(_bins(blocks, groups, _LO + 2, 0, top)[:, 1:-1], need)
    return (top + lo.to(torch.int32)).view(torch.float32)


def _scales(blocks: List[Sharded], groups: List[List[int]]) -> torch.Tensor:
    """Each group's int8 scale, max|g| / 127 + 1e-12 (float32 (G,), on the
    mesh's first device), each block read from its first holder."""
    dev0 = blocks[0].mesh.devices[0]
    tops = [torch.max(torch.stack([
        torch.linalg.vector_norm(blocks[i].parts[pos], math.inf).to(dev0)
        for i in idx for pos in _owned(blocks[i])])) for idx in groups]
    return torch.stack(tops) / 127.0 + 1e-12


def _compress_sharded(grads, err, method: str, ratio: float):
    """``compress`` on a mesh, in the ZeRO-1 blocks (the module's
    docstring)."""
    gs, es = leaves(grads), leaves(err)
    blocks = [Sharded(e.mesh, e.spec, e.shape, [
        g.parts[pos][within(e.region(pos), g.region(pos))].to(torch.float32)
        + e.parts[pos] for pos in range(e.mesh.size)])
        for g, e in zip(gs, es)]
    groups = stacked_groups(grads)
    if method == "topk":
        cut = _thresholds(blocks, groups, ratio)
    else:
        cut = _scales(blocks, groups)
    comp: List[Sharded] = [None] * len(blocks)
    for g, idx in enumerate(groups):
        on = {}
        for i in idx:
            parts = []
            for b in blocks[i].parts:
                c = on.setdefault(b.device, cut[g].to(b.device))
                if method == "topk":
                    parts.append(b * (torch.abs(b) >= c))
                else:
                    parts.append(torch.clamp(torch.round(b / c), -127, 127)
                                 .to(torch.int8).to(torch.float32) * c)
            comp[i] = Sharded(blocks[i].mesh, blocks[i].spec,
                              blocks[i].shape, parts)
    new_err = [Sharded(b.mesh, b.spec, b.shape, [
        x - c for x, c in zip(b.parts, cb.parts)])
        for b, cb in zip(blocks, comp)]
    return unflatten(grads, comp), unflatten(err, new_err)


@torch.no_grad()
def compress(grads: Any, err: Any, *, method: str, ratio: float = 0.125
             ) -> Tuple[Any, Any, Dict[str, torch.Tensor]]:
    """(compressed gradients in float32, new error state, metrics), one
    tensor at a time; on a mesh in the error state's layout."""
    first = leaves(grads)[0]
    dev = (first.mesh.devices[0] if isinstance(first, Sharded)
           else first.device)
    if method == "none":
        return grads, err, {"compress_ratio": torch.full((), 1.0, device=dev)}
    if method == "topk":
        one, wire = (lambda gs: _topk_group(gs, ratio)), ratio * (4 + 4) / 2.0
    elif method == "int8":
        one, wire = _int8_group, 0.5
    else:
        raise ValueError(method)
    metrics = {"compress_ratio": torch.full((), wire, device=dev)}
    if is_sharded(grads):
        return _compress_sharded(grads, err, method, ratio) + (metrics,)
    g32 = [g.to(torch.float32) + e for g, e in zip(leaves(grads),
                                                     leaves(err))]
    comp: List[torch.Tensor] = [None] * len(g32)
    for idx in stacked_groups(grads):
        for i, c in zip(idx, one([g32[i] for i in idx])):
            comp[i] = c
    new_err = [g - c for g, c in zip(g32, comp)]
    return unflatten(grads, comp), unflatten(err, new_err), metrics
