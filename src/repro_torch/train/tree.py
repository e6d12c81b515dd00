"""Parameter trees as the port keeps them: nested dicts and lists with
tensors (or other values, tuples included) at the leaves. The reference
walks its trees with `jax.tree_util`; these functions are all the training
code needs."""
from __future__ import annotations

from typing import Any, Callable, List


def tree_map(fn: Callable, tree, *rest):
    """`fn` applied leaf by leaf to `tree` and the trees in `rest`; the
    result has `tree`'s structure. A tree of `rest` is walked only as deep as
    `tree`: below a leaf of `tree` it passes whole (Adafactor's per-parameter
    statistics)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_map(fn, v, *(r[i] for r in rest)) for i, v in enumerate(tree)]
    return fn(tree, *rest)


def tree_leaves(tree) -> List[Any]:
    """The leaves in the order `tree_map` and `tree_unflatten` walk them."""
    if isinstance(tree, dict):
        return [leaf for v in tree.values() for leaf in tree_leaves(v)]
    if isinstance(tree, list):
        return [leaf for v in tree for leaf in tree_leaves(v)]
    return [tree]


def tree_unflatten(tree, leaves):
    """`tree`'s structure with `leaves` (in `tree_leaves` order) at its leaves."""
    it = iter(leaves)
    out = tree_map(lambda _: next(it), tree)
    if next(it, it) is not it:
        raise ValueError("more leaves than the tree holds")
    return out


def tree_unzip(tree, n: int) -> tuple:
    """A tree whose leaves are n-tuples (what `tree_map` of a function that
    returns a tuple gives) -> n trees of the same structure."""
    leaves = tree_leaves(tree)
    return tuple(tree_unflatten(tree, [leaf[i] for leaf in leaves]) for i in range(n))
