"""Nested dicts and lists of tensors (the JAX package's parameter trees)."""

from __future__ import annotations

__all__ = ["tree_map", "tree_leaves"]


def tree_map(fn, tree):
    """``fn`` applied to every leaf; dicts and lists keep their structure."""
    if isinstance(tree, list):
        return [tree_map(fn, t) for t in tree]
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def tree_leaves(tree) -> list:
    """The leaves in a fixed order: list order, and dict keys sorted (the
    order ``jax.tree_util.tree_leaves`` gives the same tree)."""
    if isinstance(tree, list):
        return [leaf for t in tree for leaf in tree_leaves(t)]
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    return [tree]
