"""AdamW with decoupled weight decay and global-norm clipping, as the
reference package's ``repro.optim.adamw`` computes it.

State is ``(step, mu, nu)`` with ``mu``/``nu`` mirroring the parameter
tree. A *stacked* state (``adamw_init(params, stacked=True)``) treats axis
0 of every leaf as k independent parameter trees, as the reference's
``jax.vmap(adamw_init)`` does for the k partition models: ``step`` is
``[k]`` and each partition's gradients are clipped by that partition's own
global norm, never by the norm of the whole stack.
"""
from __future__ import annotations

from typing import Any, NamedTuple, Optional, Tuple

import torch

from repro_torch.tree import tree_leaves, tree_map

Tree = Any


class OptState(NamedTuple):
    step: torch.Tensor       # int32: [] or [k] for a stacked tree
    mu: Tree                 # first moment
    nu: Tree                 # second moment


def adamw_init(params: Tree, stacked: bool = False) -> OptState:
    leaf = tree_leaves(params)[0]
    shape = (leaf.shape[0],) if stacked else ()
    zeros = tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32),
                     params)
    return OptState(step=torch.zeros(shape, dtype=torch.int32,
                                     device=leaf.device),
                    mu=zeros, nu=tree_map(torch.zeros_like, zeros))


def _per_row(x: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """Broadcast a scalar or a ``[k]`` per-partition value over ``like``."""
    return x.reshape(x.shape + (1,) * (like.dim() - x.dim()))


@torch.no_grad()
def adamw_update(grads: Tree, state: OptState, params: Tree, lr: float, *,
                 b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
                 weight_decay: float = 0.0,
                 clip_norm: Optional[float] = 1.0) -> Tuple[Tree, OptState]:
    """One AdamW step. Returns ``(new_params, new_state)``; the inputs are
    not modified."""
    step = state.step + 1
    if clip_norm is not None:
        dims = 1 if step.dim() else 0        # stacked: reduce all but axis 0
        sq = sum(g.float().square().flatten(dims).sum(-1)
                 for g in tree_leaves(grads))
        scale = torch.clamp(clip_norm / (sq.sqrt() + 1e-9), max=1.0)
        grads = tree_map(lambda g: g * _per_row(scale, g), grads)
    mu = tree_map(lambda m, g: b1 * m + (1 - b1) * g.float(), state.mu, grads)
    nu = tree_map(lambda v, g: b2 * v + (1 - b2) * g.float().square(),
                  state.nu, grads)
    t = step.float()
    # the Python scalar base rounds to b1's f32 as a 0-d tensor would, and
    # needs no host-to-device copy (a captured step cannot take one)
    bc1 = 1.0 - torch.pow(b1, t)
    bc2 = 1.0 - torch.pow(b2, t)

    def upd(p, m, v):
        mhat = m / _per_row(bc1, m)
        vhat = v / _per_row(bc2, v)
        delta = mhat / (vhat.sqrt() + eps)
        if weight_decay:
            delta = delta + weight_decay * p.float()
        return (p.float() - lr * delta).to(p.dtype)

    return tree_map(upd, params, mu, nu), OptState(step=step, mu=mu, nu=nu)
