"""Nested-dict trees of tensors: the port's stand-in for JAX pytrees.

The train state is ``{"params": {...}, "opt": {"m", "v", "count"},
"step"}``, nested dicts whose leaves are tensors.  Leaves are visited in
sorted key order at every level, as ``jax.tree`` visits a dict, and a
leaf's path is its keys joined by ``/`` (``"opt/m/blocks/attn_wq"``), as
the reference's checkpointer names it.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Tuple

Tree = Any
SEP = "/"


def flatten(tree: Tree, prefix: str = "") -> List[Tuple[str, Any]]:
    """``[(path, leaf), ...]`` in sorted key order."""
    if not isinstance(tree, dict):
        return [(prefix, tree)]
    out: List[Tuple[str, Any]] = []
    for key in sorted(tree):
        path = f"{prefix}{SEP}{key}" if prefix else str(key)
        out += flatten(tree[key], path)
    return out


def leaves(tree: Tree) -> List[Any]:
    return [leaf for _, leaf in flatten(tree)]


def unflatten(pairs) -> Dict[str, Any]:
    """The nested dict of ``(path, leaf)`` pairs."""
    out: Dict[str, Any] = {}
    for path, leaf in pairs:
        node = out
        *parents, last = path.split(SEP)
        for key in parents:
            node = node.setdefault(key, {})
        node[last] = leaf
    return out


def tree_map(fn: Callable, tree: Tree, *rest: Tree) -> Tree:
    """``fn`` over the leaves of trees of one structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)
