"""Pytree helpers with ``jax.tree_util``'s leaf order.

The port keeps parameters, gradients and optimizer states in the same
containers as the JAX package: nested dicts, tuples, lists and
NamedTuples of tensors. JAX flattens a dict in SORTED key order, which
fixes the column order of a packed wire row and the leaf order of every
state conversion; ``torch.utils._pytree`` keeps insertion order instead.
These few functions reproduce JAX's order so that a port wire row agrees
with the reference row column for column.

``None`` is an empty subtree (no leaves), as in JAX.
"""
from __future__ import annotations

from typing import Any, Callable, List, Tuple

PyTree = Any


def _is_namedtuple(x: Any) -> bool:
    return isinstance(x, tuple) and getattr(type(x), "_fields", None) is not None


def _flatten(x: Any, leaves: list):
    if x is None:
        return ("none",)
    if isinstance(x, dict):
        keys = tuple(sorted(x))
        return ("dict", keys, tuple(_flatten(x[k], leaves) for k in keys))
    if _is_namedtuple(x):
        return ("namedtuple", type(x), tuple(_flatten(v, leaves) for v in x))
    if isinstance(x, (tuple, list)):
        return (type(x), None, tuple(_flatten(v, leaves) for v in x))
    leaves.append(x)
    return ("leaf",)


def _unflatten(node, it):
    kind = node[0]
    if kind == "none":
        return None
    if kind == "leaf":
        return next(it)
    if kind == "dict":
        return {k: _unflatten(c, it) for k, c in zip(node[1], node[2], strict=True)}
    if kind == "namedtuple":
        return node[1](*[_unflatten(c, it) for c in node[2]])
    return kind(_unflatten(c, it) for c in node[2])


def tree_flatten(tree: PyTree) -> Tuple[List[Any], Any]:
    """(leaves in JAX order, structure) — the structure is hashable."""
    leaves: list = []
    treedef = _flatten(tree, leaves)
    return leaves, treedef


def tree_unflatten(treedef: Any, leaves) -> PyTree:
    """Inverse of :func:`tree_flatten`."""
    it = iter(leaves)
    out = _unflatten(treedef, it)
    if next(it, None) is not None:
        raise ValueError("too many leaves for the tree structure")
    return out


def tree_leaves(tree: PyTree) -> List[Any]:
    return tree_flatten(tree)[0]


def tree_map(fn: Callable, tree: PyTree, *rest: PyTree) -> PyTree:
    """``fn`` over corresponding leaves of trees with one structure."""
    leaves, treedef = tree_flatten(tree)
    others = [tree_flatten(r) for r in rest]
    for other_leaves, other_def in others:
        if other_def != treedef:
            raise ValueError("tree_map over trees of different structure")
    return tree_unflatten(
        treedef,
        [fn(*xs) for xs in zip(leaves, *[o[0] for o in others], strict=True)],
    )
