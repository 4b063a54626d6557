"""Nested parameter trees (dicts, lists and tuples of tensors), the
port's stand-in for the parts of ``jax.tree`` the Impulse path uses.

Dict leaves are visited in sorted key order, as ``jax.tree.flatten``
visits them.  ``None`` is a leaf here (``QuantizedParams.scales`` marks
the leaves it did not quantize with ``None``).
"""
from __future__ import annotations

from typing import Any, Callable, List


def as_tree(obj: Any) -> Any:
    """A ``ParamTree``'s nested dict of leaves; any other tree as it is."""
    return obj.tree() if hasattr(obj, "tree") else obj


def leaves(tree: Any) -> List[Any]:
    """The leaves of ``tree``, depth first, dict keys sorted."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for sub in tree for x in leaves(sub)]
    return [tree]


def map_tree(fn: Callable, tree: Any, *rest: Any) -> Any:
    """``fn`` applied leaf by leaf to ``tree`` and the trees of the same
    structure in ``rest``; the result has ``tree``'s structure."""
    if isinstance(tree, dict):
        return {k: map_tree(fn, tree[k], *(r[k] for r in rest))
                for k in tree}
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_tree(fn, *subs) for subs in zip(tree, *rest))
    return fn(tree, *rest)


def unflatten(tree: Any, flat: List[Any]) -> Any:
    """A tree of ``tree``'s structure whose leaves are ``flat``, taken in
    the order of ``leaves(tree)``."""
    it = iter(flat)

    def build(t):
        if isinstance(t, dict):
            return {k: build(t[k]) for k in sorted(t)}
        if isinstance(t, (list, tuple)):
            return type(t)(build(x) for x in t)
        return next(it)
    return build(tree)
