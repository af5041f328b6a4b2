"""Trees of tensors: nested dicts, lists, tuples and NamedTuples, the shape
of the port's parameter, optimizer-state and layout trees (what the
reference takes from ``jax.tree_util``).  ``None`` is an empty subtree, as
in jax: it has no leaves and maps to ``None``.

Dicts are walked in insertion order (jax sorts their keys); trees built
from one another (a state from its parameters, gradients from their
parameters) therefore line up leaf for leaf.
"""
from __future__ import annotations

from typing import Any, Callable, List, Tuple


def _is_namedtuple(tree) -> bool:
    return isinstance(tree, tuple) and hasattr(tree, "_fields")


def map_with_path(tree: Any, fn: Callable, path: Tuple[str, ...] = ()) -> Any:
    """``fn(path_parts, leaf)`` over every leaf; a part is a dict key, a
    NamedTuple field name or a list index, as a string."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {key: map_with_path(value, fn, path + (str(key),)) for key, value in tree.items()}
    if _is_namedtuple(tree):
        return type(tree)(*(map_with_path(value, fn, path + (name,))
                            for name, value in zip(tree._fields, tree)))
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_with_path(value, fn, path + (str(i),))
                          for i, value in enumerate(tree))
    return fn(list(path), tree)


def leaves(tree: Any) -> List[Any]:
    """The leaves in walk order."""
    out: List[Any] = []
    map_with_path(tree, lambda parts, leaf: out.append(leaf))
    return out


def map_leaves(fn: Callable, tree: Any, *rest: Any) -> Any:
    """``fn(leaf, *others)`` over the leaves of ``tree``; each tree of
    ``rest`` has ``tree``'s structure down to its leaves, and whatever it
    holds there (a tensor, a layout tuple) is passed whole."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {key: map_leaves(fn, value, *(r[key] for r in rest)) for key, value in tree.items()}
    if _is_namedtuple(tree):
        return type(tree)(*(map_leaves(fn, value, *(r[i] for r in rest))
                            for i, value in enumerate(tree)))
    if isinstance(tree, (list, tuple)):
        if any(len(r) != len(tree) for r in rest):
            raise ValueError("trees of different structure")
        return type(tree)(map_leaves(fn, value, *(r[i] for r in rest))
                          for i, value in enumerate(tree))
    return fn(tree, *rest)
