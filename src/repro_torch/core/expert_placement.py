"""Leiden-Fusion for MoE expert placement, the port's own copy of the
reference's ``repro.core.expert_placement``.

The paper partitions a *data* graph to minimize training communication.
The same algorithm places the experts of an expert-parallel MoE layer:
build the **expert co-activation graph** (nodes are experts, an edge's
weight counts the tokens that the router sends to both ends among their
top-k), partition it with Leiden-Fusion into one community per shard, and
put co-activated experts on the same shard. A token whose top-k experts
all live on one shard needs no all-to-all hop for dispatch and combine.

``placement_cost`` scores a placement by how many distinct shards a
token's top-k set touches, against the default contiguous split.

The trace comes from the port's router (:func:`router_top_k`, on
:func:`repro_torch.models.moe._route`); :func:`apply_placement_to_params`
permutes an MoE layer's expert axis, of tensors or numpy arrays, so that
each shard's experts sit together. On one card placement moves no byte:
what runs there is the algorithm and its metrics.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..models.config import ModelConfig
from ..models.moe import _route
from .fusion import fuse
from .graph import Graph
from .leiden import leiden


def coactivation_graph(expert_idx: np.ndarray, num_experts: int,
                       weights: Optional[np.ndarray] = None) -> Graph:
    """The expert co-activation graph of ``expert_idx [T, K]``, the top-k
    expert ids per token: edge ``(a, b)`` adds 1 (or the token's weight)
    for every token that routes to both ``a`` and ``b``."""
    t, k = expert_idx.shape
    srcs, dsts, ws = [], [], []
    for i in range(k):
        for j in range(i + 1, k):
            srcs.append(expert_idx[:, i])
            dsts.append(expert_idx[:, j])
            ws.append(weights if weights is not None else np.ones(t))
    return Graph.from_edges(num_experts, np.concatenate(srcs),
                            np.concatenate(dsts), np.concatenate(ws))


def lf_expert_placement(expert_idx: np.ndarray, num_experts: int,
                        num_shards: int, alpha: float = 0.0,
                        seed: int = 0) -> np.ndarray:
    """The shard of each expert, by Leiden-Fusion on the co-activation
    graph; exactly ``num_experts / num_shards`` experts a shard (every
    shard holds the same number of expert weight slots), so
    ``num_experts`` must divide by ``num_shards``."""
    g = coactivation_graph(expert_idx, num_experts)
    per = num_experts // num_shards
    assert per * num_shards == num_experts, (num_experts, num_shards)
    labels = leiden(g, max_community_size=per, seed=seed)
    shard = fuse(g, labels, num_shards, max_part_size=per + 0.5)
    return _rebalance(g, shard, num_shards, per)


def _rebalance(g: Graph, shard: np.ndarray, num_shards: int, per: int
               ) -> np.ndarray:
    """Move the least-attached experts out of overfull shards until every
    shard holds exactly ``per``."""
    shard = shard.copy()
    sizes = np.bincount(shard, minlength=num_shards)
    while (sizes > per).any():
        over = int(np.argmax(sizes))
        under = int(np.argmin(sizes))
        members = np.where(shard == over)[0]
        # each member's attachment to its own shard
        att = np.zeros(members.shape[0])
        for m, e in enumerate(members):
            nbrs = g.neighbors(int(e))
            wts = g.neighbor_weights(int(e))
            att[m] = wts[shard[nbrs] == over].sum()
        mv = int(members[np.argmin(att)])
        shard[mv] = under
        sizes[over] -= 1
        sizes[under] += 1
    return shard


def placement_cost(expert_idx: np.ndarray, placement: np.ndarray
                   ) -> Dict[str, float]:
    """How many distinct shards each token's top-k set touches (fewer
    shards: fewer all-to-all partners, less traffic): the mean, the 90th
    percentile and the share of tokens that stay on one shard."""
    t = expert_idx.shape[0]
    shards_per_token = np.array(
        [len(set(placement[expert_idx[i]])) for i in range(t)])
    return {
        "mean_shards_per_token": float(shards_per_token.mean()),
        "p90_shards_per_token": float(np.percentile(shards_per_token, 90)),
        "single_shard_frac": float((shards_per_token == 1).mean()),
    }


def contiguous_placement(num_experts: int, num_shards: int) -> np.ndarray:
    """The default placement, expert id // experts a shard: what naive
    expert-parallel sharding of an ``[E, ...]`` weight stack gives."""
    per = num_experts // num_shards
    return np.arange(num_experts) // per


def _take(x, perm: np.ndarray, axis: int):
    """``x`` (a tensor or a numpy array) indexed by ``perm`` along
    ``axis``."""
    if isinstance(x, torch.Tensor):
        return x.index_select(axis, torch.as_tensor(perm, device=x.device))
    return np.take(x, perm, axis=axis)


def apply_placement_to_params(params_moe: dict, placement: np.ndarray
                              ) -> Tuple[dict, np.ndarray]:
    """An MoE layer's params with the expert axis reordered so that shard
    ``s`` holds the experts with ``placement == s`` contiguously: axis 0
    of ``w_gate``/``w_up``/``w_out`` (axis 1 of a stacked ``[L, E, ...]``
    leaf) and the router's last axis, tensors or numpy arrays. Returns
    ``(params, perm)``, ``perm`` mapping a new position to its old expert
    id. The router's columns move with the experts, so the layer computes
    the same function."""
    perm = np.argsort(placement, kind="stable")
    out = dict(params_moe)
    for name in ("w_gate", "w_up", "w_out"):
        if name in out:
            out[name] = _take(out[name], perm, 1 if out[name].ndim == 4
                              else 0)
    if "router" in out:
        out["router"] = _take(out["router"], perm, out["router"].ndim - 1)
    return out, perm


def router_top_k(params_moe: dict, cfg: ModelConfig,
                 h: torch.Tensor) -> np.ndarray:
    """The top-k expert ids ``[T, K]`` (int64, on the host) that the
    port's router picks for each hidden state of ``h [..., d]``, the input
    of one MoE layer's FFN: the trace placement takes."""
    with torch.no_grad():
        _, _, idx = _route(params_moe, cfg, h)
    return idx.reshape(-1, cfg.top_k).cpu().numpy().astype(np.int64)
