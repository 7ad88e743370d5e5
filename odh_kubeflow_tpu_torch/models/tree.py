"""Nested-dict tree helpers: the params, gradients and optimizer state are
dicts of tensors, and these walk them as jax.tree_util walks the
reference's pytrees."""
from __future__ import annotations

from typing import Any, Callable, List

import torch


def tree_leaves(tree: Any) -> List[torch.Tensor]:
    """The tensors of a nested dict, in insertion order."""
    if isinstance(tree, dict):
        return [leaf for child in tree.values() for leaf in tree_leaves(child)]
    return [tree]


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """fn over the leaves of `tree` and the matching leaves of `rest`."""
    if isinstance(tree, dict):
        return {name: tree_map(fn, child, *(r[name] for r in rest))
                for name, child in tree.items()}
    return fn(tree, *rest)


def tree_unflatten(like: Any, leaves: List[torch.Tensor]) -> Any:
    """`leaves` (in tree_leaves order) in the structure of `like`."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), like)
