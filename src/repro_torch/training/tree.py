"""Nested containers of tensors: the port's small stand-in for
``jax.tree``.

A tree is a dict, list, tuple or NamedTuple of trees, ``None`` (a node with
no leaves, as in JAX) or a leaf. Dicts keep their insertion order; the
order is this package's own and stays the same for trees built alike.
"""
from __future__ import annotations

from typing import Any, Callable, List


def _children(tree):
    if isinstance(tree, dict):
        return list(tree.values())
    if isinstance(tree, (list, tuple)):
        return list(tree)
    return None


def _rebuild(tree, children):
    if isinstance(tree, dict):
        return dict(zip(tree.keys(), children))
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):     # NamedTuple
        return type(tree)(*children)
    return type(tree)(children)


def leaves(tree) -> List[Any]:
    """The leaves, depth first."""
    if tree is None:
        return []
    kids = _children(tree)
    if kids is None:
        return [tree]
    return [leaf for kid in kids for leaf in leaves(kid)]


def paths(tree, prefix: str = "") -> List[str]:
    """Each leaf's path (``"params/stages/0/b0/attn/wq"``), in ``leaves``
    order."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        keys = list(tree.keys())
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        keys = list(tree._fields)
    elif isinstance(tree, (list, tuple)):
        keys = [str(i) for i in range(len(tree))]
    else:
        return [prefix]
    return [p for k, kid in zip(keys, _children(tree)) for p in paths(kid, f"{prefix}/{k}")]


def unflatten(like, flat: List[Any]):
    """A tree shaped as ``like`` holding ``flat`` (``leaves`` order)."""
    it = iter(flat)

    def build(t):
        if t is None:
            return None
        kids = _children(t)
        if kids is None:
            return next(it)
        return _rebuild(t, [build(k) for k in kids])

    out = build(like)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree holds")
    return out


def map(fn: Callable, tree, *rest):
    """``fn(leaf, *leaves_of_rest)`` over trees of ``tree``'s structure."""
    flat = [leaves(t) for t in (tree,) + rest]
    if any(len(f) != len(flat[0]) for f in flat):
        raise ValueError("trees differ in their number of leaves")
    return unflatten(tree, [fn(*ls) for ls in zip(*flat)])
