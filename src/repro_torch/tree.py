"""The port's trees: nested dicts and lists of tensors (or arrays).

Dict keys are walked in sorted order and list entries in index order, the
order ``jax.tree_util`` flattens a dict tree in, so a leaf's position and its
path (``layers/0/attn/wq``) are the same in both packages for the same tree.
"""
from __future__ import annotations

from typing import Any, Callable, List, Tuple


def leaves_with_paths(tree: Any, prefix: Tuple = ()) -> List[Tuple[Tuple,
                                                                   Any]]:
    """[(path, leaf)] in flattening order; a path is a tuple of dict keys
    and list indices."""
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out += leaves_with_paths(tree[k], prefix + (k,))
        return out
    if isinstance(tree, (list, tuple)):
        out = []
        for i, v in enumerate(tree):
            out += leaves_with_paths(v, prefix + (i,))
        return out
    return [(prefix, tree)]


def path_str(path: Tuple) -> str:
    return "/".join(str(p) for p in path)


def leaves(tree: Any) -> List[Any]:
    return [leaf for _, leaf in leaves_with_paths(tree)]


def unflatten(like: Any, new_leaves) -> Any:
    """A tree of ``like``'s structure holding ``new_leaves`` in flattening
    order."""
    it = iter(new_leaves)

    def build(t):
        if isinstance(t, dict):
            return {k: build(t[k]) for k in sorted(t)}
        if isinstance(t, (list, tuple)):
            return type(t)(build(v) for v in t)
        return next(it)

    out = build(like)
    if next(it, None) is not None:
        raise ValueError("unflatten: more leaves than the tree has")
    return out


def map_tree(fn: Callable, tree: Any, *rest: Any) -> Any:
    """``fn`` over the leaves of ``tree`` (and the matching leaves of
    ``rest``, trees of the same structure)."""
    others = [leaves(r) for r in rest]
    return unflatten(tree, [fn(x, *(o[i] for o in others))
                            for i, x in enumerate(leaves(tree))])
