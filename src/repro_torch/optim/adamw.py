"""AdamW with decoupled weight decay and global-norm clipping, as the
reference package's ``repro.optim.adamw`` computes it.

State is ``(step, mu, nu)`` with ``mu``/``nu`` mirroring the parameter
tree. A *stacked* state (``adamw_init(params, stacked=True)``) treats axis
0 of every leaf as k independent parameter trees, as the reference's
``jax.vmap(adamw_init)`` does for the k partition models: ``step`` is
``[k]`` and each partition's gradients are clipped by that partition's own
global norm, never by the norm of the whole stack. Each partition's norm
is reduced alone, as an unstacked tree's is: a row reduction over a
``[k, M]`` stack takes its summation order from k on the card, and a
partition must train alike in a stack of any size (one process per
partition holds a stack of one).

:func:`adamw_update_` writes into the given trees (the LM's train step,
whose state would not fit twice on the card); :func:`adamw_update`
applies it to copies and returns them (the GCN steps donate theirs).
"""
from __future__ import annotations

from typing import Any, NamedTuple, Optional, Tuple, Union

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


def _square_norm(leaves) -> torch.Tensor:
    """The squared global norm of one tree's gradient leaves (f32)."""
    return sum(g.float().square().flatten(0).sum(-1) for g in leaves)


@torch.no_grad()
def adamw_update(grads: Tree, state: OptState, params: Tree,
                 lr: Union[float, torch.Tensor],
                 **kw) -> Tuple[Tree, OptState]:
    """One AdamW step. Returns ``(new_params, new_state)``: copies of the
    inputs, updated by :func:`adamw_update_`; the inputs are not
    modified."""
    params = tree_map(torch.clone, params)
    state = OptState(*tree_map(torch.clone, list(state)))
    return params, adamw_update_(grads, state, params, lr, **kw)


@torch.no_grad()
def adamw_update_(grads: Tree, state: OptState, params: Tree,
                  lr: Union[float, torch.Tensor], *, b1: float = 0.9,
                  b2: float = 0.999, eps: float = 1e-8,
                  weight_decay: float = 0.0,
                  clip_norm: Optional[float] = 1.0) -> OptState:
    """One AdamW step in place: ``params``, ``state.mu``, ``state.nu``
    and ``state.step`` take their new values; returns ``state``. It works
    leaf by leaf, so that no second tree of parameters or moments is ever
    alive (an f32 tree is 4 bytes a parameter: at 4 B parameters,
    17.6 GB). The clip scale multiplies each gradient's f32 value, as the
    reference's promotion does. ``lr`` may be a 0-d tensor (a schedule's
    output)."""
    state.step.add_(1)
    step = state.step
    g_leaves = tree_leaves(grads)
    if clip_norm is not None:
        if step.dim():                       # stacked: each partition alone
            sq = torch.stack([_square_norm([g[i] for g in g_leaves])
                              for i in range(step.shape[0])])
        else:
            sq = _square_norm(g_leaves)
        scale = torch.clamp(clip_norm / (sq.sqrt() + 1e-9), max=1.0)
    t = step.float()
    # the Python scalar base rounds to b1's f32 as a 0-d tensor would, and
    # needs no host-to-device copy (a captured step cannot take one)
    bc1 = 1.0 - torch.pow(b1, t)
    bc2 = 1.0 - torch.pow(b2, t)
    for p, g, m, v in zip(tree_leaves(params), g_leaves,
                          tree_leaves(state.mu), tree_leaves(state.nu)):
        g = g.float()
        if clip_norm is not None:
            g = g * _per_row(scale, g)
        m.mul_(b1).add_((1 - b1) * g)
        v.mul_(b2).add_(g.square().mul_(1 - b2))
        del g
        delta = m / _per_row(bc1, m)
        delta.div_((v / _per_row(bc2, v)).sqrt_().add_(eps))
        if weight_decay:
            delta.add_(p.float() * weight_decay)
        delta.mul_(lr)
        if p.dtype == torch.float32:
            p.sub_(delta)
        else:
            p.copy_(p.float() - delta)
    return state
