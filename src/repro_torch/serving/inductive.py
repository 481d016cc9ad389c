"""Inductive fallback: answer nodes the embedding table never saw.

A query for an unknown node id arrives with the ids of its known
neighbours. The serving layer

1. routes it to the partition owning the majority of those neighbours
   (ties to the smallest pid);
2. averages the neighbours' stored embeddings through the aggregation
   kernel (kernel A on the card) on a synthetic star graph — the first B
   rows are the queries, then the B*M neighbour rows, one arc per real
   neighbour with weight 1;
3. runs the owning partition's head on the aggregate.

Shapes are fixed per flush bucket (``[B * (1 + M)]`` rows), and each
bucket resolves its own kernel config
(:meth:`InductiveEngine.kernel_config`, the reference's per-bucket
config): the fallback unless the autotuner's cache holds an entry for the
star graph's shape bucket. A query with no known neighbour gets the zero
aggregate, the bias of shard 0's head, and is flagged ``degraded`` —
never a crash.

The device work of a flush (the heads' gather, the star graph's
aggregation, the head) is :attr:`InductiveEngine.program`, a
:class:`repro_torch.graphs.CapturedStep`: one CUDA graph per bucket on
the card (the reference's jit per bucket). Routing, the variable-length
store lookup and scatter, the pid upload and the ``degraded`` flags are
host work done before it, and their results are copied into the bucket's
static inputs.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.graphs import CapturedStep
from repro_torch.kernels import ops
from repro_torch.kernels.autotune import KernelConfig, get_config

__all__ = ["InductiveEngine", "route_neighbors", "aggregate_and_head",
           "star_graph"]


def route_neighbors(partition_of: np.ndarray,
                    neighbors: Optional[Sequence[int]]
                    ) -> Tuple[int, np.ndarray]:
    """(owning pid, known-neighbour ids) for an unseen node; neighbours
    outside ``[0, n)`` are dropped, and with none left the pid is -1."""
    n = partition_of.shape[0]
    nb = np.asarray(neighbors if neighbors is not None else [],
                    dtype=np.int64).reshape(-1)
    nb = nb[(nb >= 0) & (nb < n)]
    if nb.size == 0:
        return -1, nb
    counts = np.bincount(partition_of[nb])
    return int(counts.argmax()), nb


def star_graph(b: int, m: int, device: torch.device
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(src, dst, row_ptr) of the bucket's star graph: arc ``i*m + j``
    points neighbour row ``b + i*m + j`` at query row ``i``; dst is sorted
    by construction."""
    src = b + torch.arange(b * m, dtype=torch.int32, device=device)
    dst = torch.arange(b, dtype=torch.int32, device=device) \
        .repeat_interleave(m)
    row_ptr = torch.cat([
        torch.arange(b + 1, dtype=torch.int32, device=device) * m,
        torch.full((b * m,), b * m, dtype=torch.int32, device=device)])
    return src, dst, row_ptr


def aggregate_and_head(nb_emb: torch.Tensor, nb_mask: torch.Tensor,
                       head_w: torch.Tensor, head_b: torch.Tensor,
                       star: Optional[Tuple[torch.Tensor, ...]] = None,
                       config: Optional[KernelConfig] = None
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Batched star-graph mean aggregation + per-query head.

    nb_emb [B, M, E] (zero where masked), nb_mask [B, M], head_w [B, E, C],
    head_b [B, C]; ``config`` is the bucket's kernel config (None: the
    device's fallback). Returns (aggregate [B, E], logits [B, C]).
    """
    b, m, e = nb_emb.shape
    device = nb_emb.device
    src, dst, row_ptr = star if star is not None else \
        star_graph(b, m, device)
    h = torch.cat([torch.zeros((b, e), dtype=torch.float32, device=device),
                   nb_emb.reshape(b * m, e)])
    csr = ops.Csr(src=src, dst=dst,
                  weight=nb_mask.reshape(-1).float().contiguous(),
                  row_ptr=row_ptr, num_nodes=b * (1 + m))
    in_degree = torch.cat([nb_mask.sum(dim=1),
                           torch.ones(b * m, device=device)])
    agg = ops.csr_aggregate(h, csr, ops.inv_degree(in_degree),
                            config=config)[:b]
    logits = torch.bmm(agg[:, None, :], head_w)[:, 0, :] + head_b
    return agg, logits


class InductiveEngine:
    """Batched on-the-fly aggregation for unseen nodes."""

    def __init__(self, store, max_neighbors: int = 32,
                 capture: bool = True, pool=None):
        self.store = store
        self.max_neighbors = int(max_neighbors)
        self._stars: Dict[int, Tuple[torch.Tensor, ...]] = {}
        self.program = CapturedStep(self._program, store.device, pool=pool,
                                    name="inductive") if capture \
            else self._program

    def route(self, neighbors) -> Tuple[int, np.ndarray]:
        return route_neighbors(self.store.partition_of, neighbors)

    def kernel_config(self, b_pad: int) -> KernelConfig:
        """The bucket's kernel config: its star graph's shape ([B·(1+M)]
        rows, [B·M] arcs, ``embed_dim`` wide) on the store's device."""
        m = self.max_neighbors
        return get_config(b_pad * (1 + m), b_pad * m, self.store.embed_dim,
                          self.store.device)

    def star(self, b_pad: int) -> Tuple[torch.Tensor, ...]:
        """The bucket's star graph, built once per bucket size."""
        if b_pad not in self._stars:
            self._stars[b_pad] = star_graph(b_pad, self.max_neighbors,
                                            self.store.device)
        return self._stars[b_pad]

    def prepare(self, neighbor_lists: List[np.ndarray], b_pad: int
                ) -> Tuple[torch.Tensor, torch.Tensor, np.ndarray]:
        """Gather into the fixed ``[b_pad, M, E]`` layout on the device.

        Returns (nb_emb, nb_mask, pids). Lists longer than ``M`` are
        truncated by position."""
        return self._prepare(neighbor_lists, b_pad)[:3]

    def _prepare(self, neighbor_lists: List[np.ndarray], b_pad: int
                 ) -> Tuple[torch.Tensor, torch.Tensor, np.ndarray,
                            np.ndarray]:
        """:meth:`prepare`'s three, and the mask on the host."""
        m, e = self.max_neighbors, self.store.embed_dim
        mask = np.zeros((b_pad, m), dtype=np.float32)
        pids = np.zeros(b_pad, dtype=np.int64)
        slots, ids = [], []
        for i, nbs in enumerate(neighbor_lists):
            pid, known = self.route(nbs)
            known = known[:m]
            pids[i] = max(pid, 0)      # degraded queries compute on shard 0
            mask[i, :known.size] = 1.0
            slots.append(i * m + np.arange(known.size))
            ids.append(known)
        device = self.store.device
        nb_emb = torch.zeros((b_pad * m, e), dtype=torch.float32,
                             device=device)
        flat_ids = np.concatenate(ids) if ids else np.zeros(0, np.int64)
        if flat_ids.size:
            nb_emb[torch.as_tensor(np.concatenate(slots)).to(device)] = \
                self.store.lookup(flat_ids)
        return (nb_emb.view(b_pad, m, e), torch.as_tensor(mask).to(device),
                pids, mask)

    def _program(self, nb_emb: torch.Tensor, nb_mask: torch.Tensor,
                 pid_t: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """A flush's device work at its bucket, ``nb_emb.shape[0]``: the
        owning heads, and the aggregation under the bucket's
        :meth:`kernel_config`."""
        b_pad = nb_emb.shape[0]
        return aggregate_and_head(
            nb_emb, nb_mask, self.store.head_w[pid_t],
            self.store.head_b[pid_t], star=self.star(b_pad),
            config=self.kernel_config(b_pad))

    def infer(self, neighbor_lists: List[np.ndarray], b_pad: int,
              compiles=None
              ) -> Tuple[torch.Tensor, torch.Tensor, np.ndarray, np.ndarray]:
        """(aggregates [b_pad, E], logits [b_pad, C], degraded [b_pad],
        owning pids [b_pad]); only the first ``len(neighbor_lists)`` rows
        are real queries. The outputs of a captured :attr:`program` are
        its static outputs: read them before the bucket's next call.
        ``compiles`` (a :class:`repro_torch.graphs.CompileLog`) counts the
        program's compiles as ``"inductive"``."""
        nb_emb, nb_mask, pids, mask = self._prepare(neighbor_lists, b_pad)
        pid_t = torch.as_tensor(pids).to(self.store.device)
        if compiles is None:
            agg, logits = self.program(nb_emb, nb_mask, pid_t)
        else:
            agg, logits = compiles.call("inductive", self.program, nb_emb,
                                        nb_mask, pid_t)
        return agg, logits, mask.sum(axis=1) == 0, pids
