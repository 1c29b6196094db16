"""Nested dicts of tensors as the JAX package's pytrees.

``jax.tree_util`` flattens a dict in the order of its sorted keys, depth
first; :func:`flatten_with_paths` gives the same order and joins each
leaf's keys with ``/``, the names a checkpoint stores.
"""
from __future__ import annotations

from typing import Any, Callable

Pytree = Any


def flatten_with_paths(tree: Pytree, prefix: str = "") -> list[tuple[str, Any]]:
    if not isinstance(tree, dict):
        return [(prefix, tree)]
    out = []
    for key in sorted(tree):
        out.extend(flatten_with_paths(tree[key], f"{prefix}/{key}" if prefix else str(key)))
    return out


def tree_leaves(tree: Pytree) -> list:
    return [leaf for _, leaf in flatten_with_paths(tree)]


def tree_map(fn: Callable, tree: Pytree, *rest: Pytree) -> Pytree:
    """``fn`` over the leaves of ``tree`` and of the trees of its structure
    in ``rest``, leaf by leaf."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    return fn(tree, *rest)


def tree_unflatten(like: Pytree, leaves: list) -> Pytree:
    """The tree of ``like``'s structure whose leaves, in
    :func:`flatten_with_paths` order, are ``leaves``."""
    it = iter(leaves)

    def build(node):
        if isinstance(node, dict):
            return {k: build(node[k]) for k in sorted(node)}
        return next(it)

    out = build(like)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree holds")
    return out
