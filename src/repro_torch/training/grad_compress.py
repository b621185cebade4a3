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
"""
from __future__ import annotations

from typing import Any, Dict, List, Tuple

import torch

from repro_torch.tree import leaves, leaves_with_paths, map_tree, unflatten


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


@torch.no_grad()
def compress(grads: Any, err: Any, *, method: str, ratio: float = 0.125
             ) -> Tuple[Any, Any, Dict[str, torch.Tensor]]:
    """(compressed gradients in float32, new error state, metrics), one
    tensor at a time."""
    dev = leaves(grads)[0].device
    if method == "none":
        return grads, err, {"compress_ratio": torch.full((), 1.0, device=dev)}
    if method == "topk":
        one, wire = (lambda gs: _topk_group(gs, ratio)), ratio * (4 + 4) / 2.0
    elif method == "int8":
        one, wire = _int8_group, 0.5
    else:
        raise ValueError(method)
    g32 = [g.to(torch.float32) + e for g, e in zip(leaves(grads),
                                                     leaves(err))]
    comp: List[torch.Tensor] = [None] * len(g32)
    for idx in stacked_groups(grads):
        for i, c in zip(idx, one([g32[i] for i in idx])):
            comp[i] = c
    new_err = [g - c for g, c in zip(g32, comp)]
    return (unflatten(grads, comp), unflatten(err, new_err),
            {"compress_ratio": torch.full((), wire, device=dev)})
