"""Community Fusion — Algorithms 1 and 2 of the paper (numpy).

Greedy merge loop: repeatedly take the smallest community and merge it
into its largest-edge-cut neighbour that stays under ``max_part_size``
(Algorithm 2 falls back to the smallest neighbour when every merge would
overflow), until exactly ``k`` communities remain. The cuts live in
:class:`~repro_torch.core.engine.CommunityState`, merged incrementally.
"""
from __future__ import annotations

import heapq
from typing import Optional

import numpy as np

from .engine import CommunityState
from .graph import Graph
from .leiden import leiden


def _pop_live(heap, state: CommunityState, skip: int = -1) -> int:
    """Pop the smallest live community (lazy invalidation); ``skip`` is
    excluded. Popped valid entries are consumed: the caller merges the
    result away or re-pushes it."""
    size = state.size
    alive = state.alive
    while True:
        s, c = heapq.heappop(heap)
        if c != skip and alive[c] and s == size[c]:
            return c


def fuse(g: Graph, labels: np.ndarray, k: int, max_part_size: float,
         sizes: Optional[np.ndarray] = None) -> np.ndarray:
    """Algorithm 1 lines 5-10: merge until |C| == k. Returns new labels."""
    labels = np.asarray(labels, dtype=np.int64).copy()
    num = int(labels.max()) + 1
    if num <= k:
        return labels
    state = CommunityState(g, labels, sizes=sizes)
    size = state.size
    heap = [(size[c], c) for c in range(num)]
    heapq.heapify(heap)

    remaining = num
    while remaining > k:
        c_min = _pop_live(heap, state)
        nbrs, cut_w = state.neighbors(c_min)
        if nbrs.size:
            # Algorithm 2: LargestEdgeCutNeighbor
            fits = size[nbrs] + size[c_min] < max_part_size
            if fits.any():
                fid, fw = nbrs[fits], cut_w[fits]
                # arg max cut; ties to the smaller size, then smaller id
                target = int(fid[np.lexsort((fid, size[fid], -fw))[0]])
            else:
                target = int(nbrs[np.lexsort((nbrs, size[nbrs]))[0]])
        else:
            # disconnected community: merge with the smallest other one
            target = _pop_live(heap, state, skip=c_min)
        state.merge(c_min, into=target)
        heapq.heappush(heap, (size[target], target))
        remaining -= 1

    return state.compact_labels()


def leiden_fusion(g: Graph, k: int, alpha: float = 0.05, beta: float = 0.5,
                  seed: int = 0, gamma: float = 1.0) -> np.ndarray:
    """Algorithm 1 — the full Leiden-Fusion partitioner.

    max_part_size = (n/k)(1+alpha); Leiden cap = beta * max_part_size. For a
    connected input every output partition is one connected component.
    """
    max_part_size = (g.n / k) * (1.0 + alpha)
    labels = leiden(g, max_community_size=beta * max_part_size, seed=seed,
                    gamma=gamma)
    return fuse(g, labels, k, max_part_size)
