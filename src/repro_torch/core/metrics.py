"""Partition quality metrics: paper §5.1, equations (5)-(7).

Vectorized over :mod:`repro_torch.core.engine`: per-partition node and edge
counts by ``bincount``, per-partition components by the engine's array
union-find, halo pairs by ``np.unique`` over ``(part, node)`` keys. The
numbers equal the reference package's for the same graph and labels.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List

import numpy as np

from .engine import connected_components
from .graph import Graph

__all__ = ["PartitionReport", "evaluate_partition"]


@dataclasses.dataclass(frozen=True)
class PartitionReport:
    k: int
    edge_cut_pct: float          # eq. (5), in percent of all edges
    components_per_part: List[int]
    isolated_per_part: List[int]
    node_balance: float          # eq. (6)
    edge_balance: float
    replication_factor: float    # eq. (7), with 1-hop halos (Repli scheme)

    @property
    def total_components(self) -> int:
        return int(sum(self.components_per_part))

    @property
    def total_isolated(self) -> int:
        return int(sum(self.isolated_per_part))

    @property
    def max_components(self) -> int:
        return int(max(self.components_per_part))

    def as_dict(self) -> Dict[str, float]:
        return {
            "k": self.k,
            "edge_cut_pct": self.edge_cut_pct,
            "total_components": self.total_components,
            "max_components": self.max_components,
            "total_isolated": self.total_isolated,
            "node_balance": self.node_balance,
            "edge_balance": self.edge_balance,
            "replication_factor": self.replication_factor,
        }


def evaluate_partition(g: Graph, labels: np.ndarray) -> PartitionReport:
    labels = np.asarray(labels, dtype=np.int64)
    k = int(labels.max()) + 1
    src, dst, _ = g.arcs()
    once = src < dst                      # count each undirected edge once
    s, d = src[once], dst[once]
    m = s.shape[0]
    cut_mask = labels[s] != labels[d]
    edge_cut_pct = 100.0 * cut_mask.sum() / max(m, 1)

    # per-partition structure, from bincounts over the intra-partition edges
    same = ~cut_mask
    si, di = s[same], d[same]
    nodes = np.bincount(labels, minlength=k)
    edges = np.bincount(labels[si], minlength=k)
    deg = np.bincount(si, minlength=g.n) + np.bincount(di, minlength=g.n)
    isolated = np.bincount(labels[deg == 0], minlength=k)
    # the components of the intra-partition subgraph are the per-partition
    # components: count them per partition by each one's representative
    comp = connected_components(g.n, si, di)
    _, rep = np.unique(comp, return_index=True)
    comps = np.bincount(labels[rep], minlength=k)

    node_balance = nodes.max() / (g.n / k)
    edge_balance = edges.max() / (max(int(edges.sum()), 1) / k)

    # replication with 1-hop halos: each partition stores its own nodes and
    # their neighbours in other partitions, deduped (part, node) keys
    cs, cd = s[cut_mask], d[cut_mask]
    halo_keys = np.unique(np.concatenate([labels[cs] * g.n + cd,
                                          labels[cd] * g.n + cs]))
    rf = (g.n + halo_keys.size) / g.n

    return PartitionReport(k=k, edge_cut_pct=float(edge_cut_pct),
                           components_per_part=[int(c) for c in comps],
                           isolated_per_part=[int(i) for i in isolated],
                           node_balance=float(node_balance),
                           edge_balance=float(edge_balance),
                           replication_factor=float(rf))
