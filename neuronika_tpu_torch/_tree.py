"""Params trees: nested dicts of tensors, the port's stand-in for JAX
pytrees. Leaves are visited in dict insertion order."""

from __future__ import annotations


def tree_map(fn, *trees):
    """fn over the leaves of one or more trees of the same structure."""
    if isinstance(trees[0], dict):
        return {k: tree_map(fn, *(t[k] for t in trees)) for k in trees[0]}
    return fn(*trees)


def tree_leaves(tree) -> list:
    if isinstance(tree, dict):
        return [leaf for k in tree for leaf in tree_leaves(tree[k])]
    return [tree]


def tree_unflatten(like, leaves):
    """A tree shaped like `like` holding `leaves` in `tree_leaves` order."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), like)
