"""Trees of tensors as the LM holds them: nested dicts (params, grads,
moments, L-stacked layer states) with tensors at the leaves. ``leaves``
walks them in sorted key order, the JAX package's leaf order."""
from __future__ import annotations


def leaves(tree) -> list:
    """The leaves of a nested dict, in sorted key order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in leaves(tree[k])]
    return [tree]


def tree_map(fn, *trees):
    """``fn`` applied leaf-wise over nested dicts of one structure."""
    if isinstance(trees[0], dict):
        return {k: tree_map(fn, *(t[k] for t in trees)) for k in trees[0]}
    return fn(*trees)


def unzip(tree, n: int) -> tuple:
    """A tree of n-tuples as n trees."""
    return tuple(tree_map(lambda t, i=i: t[i], tree) for i in range(n))
