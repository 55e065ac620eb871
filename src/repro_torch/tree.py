"""Trees of tensors: nested dicts with tensor leaves (the model's
parameters, gradients, optimizer moments), walked in JAX's flatten order
(dict keys sorted), so that leaf lists line up with the reference's."""

from __future__ import annotations

from typing import Any, Callable, Iterable, List


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """``fn`` over the leaves of nested dicts of one structure."""
    if isinstance(tree, dict):
        return {key: tree_map(fn, tree[key], *(r[key] for r in rest))
                for key in tree}
    return fn(tree, *rest)


def tree_leaves(tree: Any) -> List[Any]:
    """The leaves in JAX's order (dict keys sorted)."""
    if isinstance(tree, dict):
        return [leaf for key in sorted(tree)
                for leaf in tree_leaves(tree[key])]
    return [tree]


def tree_unflatten(like: Any, leaves: Iterable[Any]) -> Any:
    """``like``'s structure with ``leaves`` (in `tree_leaves` order)."""
    it = iter(leaves)

    def fill(node):
        if isinstance(node, dict):
            return {key: fill(node[key]) for key in sorted(node)}
        return next(it)

    return fill(like)
