"""Nested dicts of tensors: the port's parameter, optimizer-state and
gradient trees.

JAX flattens a dict in sorted-key order, so every walk here visits keys
sorted too: leaves line up one to one with ``jax.tree.leaves`` of the
same tree, which is what lets a checkpoint written by either package
load in the other. A leaf is anything that is not a dict.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Tuple


def leaves(tree) -> List[Any]:
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in leaves(tree[k])]
    return [tree]


def paths(tree, prefix: str = "") -> List[str]:
    """"/"-joined key path of every leaf, in ``leaves`` order."""
    if isinstance(tree, dict):
        return [p for k in sorted(tree)
                for p in paths(tree[k], f"{prefix}{k}/")]
    return [prefix[:-1]]


def map(fn: Callable, tree, *rest):
    """``fn`` over corresponding leaves; the result has ``tree``'s
    structure (``rest`` must have it too)."""
    if isinstance(tree, dict):
        return {k: map(fn, tree[k], *(r[k] for r in rest))
                for k in tree}
    return fn(tree, *rest)


def unflatten(items: Dict[str, Any]) -> Dict[str, Any]:
    """{"a/b/c": leaf} -> {"a": {"b": {"c": leaf}}}."""
    out: Dict[str, Any] = {}
    for key, val in items.items():
        node = out
        *parents, leaf = key.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = val
    return out


def flatten(tree) -> Tuple[List[str], List[Any]]:
    return paths(tree), leaves(tree)


def like(tree, values) -> Dict[str, Any]:
    """A tree with ``tree``'s structure holding ``values``, given in
    ``leaves`` order."""
    return unflatten(dict(zip(paths(tree), values)))
