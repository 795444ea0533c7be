"""Nested-dict parameter trees: leaves in the reference's order.

``jax.tree_util`` flattens a dict in sorted key order and spells a
leaf's path as its keys joined by "/"; the optimizer, the checkpoint and
the trainers walk the port's trees the same way, so leaf i of a port tree
is leaf i of the reference's.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Tuple


def tree_flatten_with_paths(tree: Any, prefix: str = ""
                            ) -> List[Tuple[str, Any]]:
    """[(path, leaf)] in sorted key order; a non-dict is a leaf."""
    if not isinstance(tree, dict):
        return [(prefix, tree)]
    out: List[Tuple[str, Any]] = []
    for k in sorted(tree):
        out += tree_flatten_with_paths(tree[k],
                                       f"{prefix}/{k}" if prefix else str(k))
    return out


def tree_leaves(tree: Any) -> List[Any]:
    return [leaf for _, leaf in tree_flatten_with_paths(tree)]


def tree_unflatten_like(like: Any, leaves: List[Any]) -> Any:
    """A tree shaped as ``like`` whose leaves are ``leaves`` (in
    :func:`tree_leaves` order)."""
    it = iter(leaves)

    def build(t):
        if not isinstance(t, dict):
            return next(it)
        out = {k: None for k in t}       # keep the caller's key order
        for k in sorted(t):
            out[k] = build(t[k])
        return out
    tree = build(like)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree holds")
    return tree


def tree_map(fn: Callable, tree: Any) -> Any:
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def tree_set(tree: Dict[str, Any], path: str, value: Any) -> None:
    """Insert ``value`` at the "/"-joined ``path``, making the groups."""
    *groups, leaf = path.split("/")
    for g in groups:
        tree = tree.setdefault(g, {})
    tree[leaf] = value
