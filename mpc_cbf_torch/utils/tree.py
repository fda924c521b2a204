"""Flatten and rebuild nested containers of tensors (the part of
``jax.tree`` that the checkpoint and the multi-process helpers use).

Nodes, in the order of ``jax.tree.flatten``: a dict by its sorted keys,
tuples, lists, NamedTuples and dataclasses (``State``) by position, and
``None`` as a node with no leaf. Everything else is a leaf: a tensor, a
numpy array, a Python scalar.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, List, Tuple


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _children(x) -> Tuple[str, list, Callable[[list], Any]] | None:
    """(kind, children, rebuild) of a node; None for a leaf."""
    if x is None:
        return "None", [], lambda _: None
    if isinstance(x, dict):
        keys = sorted(x)
        return (f"dict{keys!r}", [x[k] for k in keys],
                lambda cs: dict(zip(keys, cs)))
    if _is_namedtuple(x):
        return type(x).__name__ + repr(tuple(x._fields)), list(x), lambda cs: type(x)(*cs)
    if isinstance(x, (tuple, list)):
        kind = type(x)
        return kind.__name__, list(x), lambda cs: kind(cs)
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        names = [f.name for f in dataclasses.fields(x)]
        return (type(x).__name__ + repr(tuple(names)), [getattr(x, n) for n in names],
                lambda cs: type(x)(**dict(zip(names, cs))))
    return None


def tree_flatten(tree) -> Tuple[List[Any], str]:
    """(leaves in jax.tree.flatten's order, structure string). The string
    names every node and its arity; two trees with the same string rebuild
    into each other's shape."""
    leaves: List[Any] = []

    def walk(x) -> str:
        node = _children(x)
        if node is None:
            leaves.append(x)
            return "*"
        kind, cs, _ = node
        return f"{kind}({', '.join(walk(c) for c in cs)})"

    return leaves, walk(tree)


def tree_unflatten(like, leaves: List[Any]):
    """``like``'s structure filled with ``leaves`` in flatten order."""
    it = iter(leaves)

    def build(x):
        node = _children(x)
        if node is None:
            leaf = next(it, it)
            if leaf is it:
                raise ValueError("tree_unflatten: fewer leaves than the structure holds")
            return leaf
        _, cs, rebuild = node
        return rebuild([build(c) for c in cs])

    out = build(like)
    if next(it, it) is not it:
        raise ValueError("tree_unflatten: more leaves than the structure holds")
    return out


def tree_map(fn: Callable[[Any], Any], tree):
    """``tree`` with every leaf replaced by fn(leaf)."""
    leaves, _ = tree_flatten(tree)
    return tree_unflatten(tree, [fn(x) for x in leaves])
