"""Params as nested dicts and lists of tensors: map and flatten them.

The reference's pytrees, without JAX.  Dict leaves come in sorted key
order, as ``jax.tree_util.tree_leaves`` gives them, so a reduction over
the leaves (``optim.global_norm``) sums in the reference's order.
"""
from __future__ import annotations

__all__ = ["tree_map", "tree_leaves", "tree_unflatten"]


def tree_map(fn, tree, *rest):
    """``fn`` applied leafwise over trees of one structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return fn(tree, *rest)


def tree_leaves(tree) -> list:
    """The leaves in the reference's order (dict keys sorted)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def tree_unflatten(template, leaves):
    """A tree shaped like ``template`` holding ``leaves`` (in
    ``tree_leaves`` order)."""
    return _fill(template, iter(leaves))


def _fill(node, it):
    # a module-level recursion: a nested recursive closure is a reference
    # cycle, and its iterator kept ``leaves`` (a step's gradients) alive
    # until the next garbage collection
    if isinstance(node, dict):
        return {k: _fill(node[k], it) for k in sorted(node)}
    if isinstance(node, (list, tuple)):
        return type(node)(_fill(v, it) for v in node)
    return next(it)
