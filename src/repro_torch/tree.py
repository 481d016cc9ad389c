"""Parameter trees: nested dicts and lists of tensors, as the reference's
pytrees are laid out. Dict keys are walked in sorted order, as
``jax.tree.leaves`` walks them, so sums over leaves run in the same order.
"""
from __future__ import annotations

from typing import Any, Callable, List, Tuple

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


def value_and_grad(fn: Callable[[Tree], torch.Tensor], tree: Tree
                   ) -> Tuple[torch.Tensor, Tree]:
    """``fn(tree)`` (detached) and its gradient tree. The gradient is
    taken with respect to detached aliases of the leaves, so ``tree``
    stays as it is (leaves that are views of one stacked tensor too)."""
    with torch.enable_grad():
        live = tree_map(lambda x: x.detach().requires_grad_(), tree)
        value = fn(live)
        grads = iter(torch.autograd.grad(value, tree_leaves(live)))
    return value.detach(), tree_map(lambda _: next(grads), live)
