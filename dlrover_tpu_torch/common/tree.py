"""Nested-dict parameter trees: the port's stand-in for ``jax.tree``.

Parameters and optimizer moments are plain nested dicts of tensors with
the JAX package's keys, so the two packages' trees compare leaf by leaf.
Leaves are visited in sorted-key order at every level, as ``jax.tree``
flattens dicts.
"""

from __future__ import annotations

from typing import Any, Callable, List, Tuple


def tree_flatten(tree: Any) -> Tuple[List[Any], Any]:
    """(leaves, structure) of a nested dict; non-dicts are leaves."""
    if isinstance(tree, dict):
        leaves: List[Any] = []
        struct = {}
        for key in sorted(tree):
            sub_leaves, sub_struct = tree_flatten(tree[key])
            leaves.extend(sub_leaves)
            struct[key] = (len(sub_leaves), sub_struct)
        return leaves, struct
    return [tree], None


def tree_unflatten(struct: Any, leaves: List[Any]) -> Any:
    if struct is None:
        (leaf,) = leaves
        return leaf
    out, i = {}, 0
    for key in sorted(struct):
        n, sub = struct[key]
        out[key] = tree_unflatten(sub, leaves[i : i + n])
        i += n
    return out


def tree_leaves(tree: Any) -> List[Any]:
    return tree_flatten(tree)[0]


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """``fn`` over corresponding leaves of trees of one structure."""
    leaves, struct = tree_flatten(tree)
    others = [tree_flatten(r)[0] for r in rest]
    return tree_unflatten(
        struct, [fn(*args) for args in zip(leaves, *others)]
    )
