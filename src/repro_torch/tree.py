"""Parameter trees: nested dicts and lists of tensors, as the reference's
pytrees are laid out. Dict keys are walked in sorted order, as
``jax.tree.leaves`` walks them, so sums over leaves run in the same order.
"""
from __future__ import annotations

from typing import Any, Callable, List

import torch

Tree = Any


def tree_map(fn: Callable[..., Any], tree: Tree, *rest: Tree) -> Tree:
    """Apply ``fn`` leafwise across trees of one structure."""
    if isinstance(tree, dict):
        return {key: tree_map(fn, tree[key], *(r[key] for r in rest))
                for key in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return [tree_map(fn, *leaves) for leaves in zip(tree, *rest)]
    return fn(tree, *rest)


def tree_leaves(tree: Tree) -> List[torch.Tensor]:
    """The leaves in the order :func:`tree_map` visits them."""
    if isinstance(tree, dict):
        return [leaf for key in sorted(tree) for leaf in tree_leaves(tree[key])]
    if isinstance(tree, (list, tuple)):
        return [leaf for sub in tree for leaf in tree_leaves(sub)]
    return [tree]
