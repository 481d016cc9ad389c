"""Graph data structures for the Leiden-Fusion partition stage (numpy).

The port's own copy of the reference package's in-RAM CSR graph and its
synthetic datasets. Partitioning runs on the host, as in the paper (§5
Setup); the device side consumes the padded arc lists built by
:mod:`repro_torch.core.assemble`.

The dataset generators draw from ``np.random.Generator`` in exactly the
reference's call order, so the same seed gives byte-identical graphs,
features, labels and masks in both packages.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np

from . import engine


@dataclasses.dataclass(frozen=True)
class Graph:
    """An undirected graph in CSR form.

    Edges are stored twice (both directions); ``indptr``/``indices`` follow
    scipy.sparse.csr conventions. ``edge_weight`` is per *directed* arc.
    """

    n: int
    indptr: np.ndarray          # (n+1,) int64
    indices: np.ndarray         # (2m,)  int32, neighbor ids
    edge_weight: np.ndarray     # (2m,)  float64
    node_weight: np.ndarray     # (n,)   float64 (used by aggregated graphs)
    # Self-loop weight per node (intra-edge weight folded into the node by
    # aggregation). A self-loop of weight w contributes 2w to the degree.
    self_weight: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(0))

    @staticmethod
    def from_edges(n: int, src: np.ndarray, dst: np.ndarray,
                   weight: Optional[np.ndarray] = None,
                   node_weight: Optional[np.ndarray] = None,
                   self_weight: Optional[np.ndarray] = None,
                   dedup: bool = True) -> "Graph":
        """Build an undirected graph from a directed edge list.

        Self-loops are dropped; reciprocal arcs are added; duplicates merged
        by summing weights when ``dedup``.
        """
        src = np.asarray(src, dtype=np.int64)
        dst = np.asarray(dst, dtype=np.int64)
        if weight is None:
            weight = np.ones(src.shape[0], dtype=np.float64)
        weight = np.asarray(weight, dtype=np.float64)
        keep = src != dst
        src, dst, weight = src[keep], dst[keep], weight[keep]
        s = np.concatenate([src, dst])
        d = np.concatenate([dst, src])
        w = np.concatenate([weight, weight])
        if dedup and s.size:
            key = s * n + d
            order = np.argsort(key, kind="stable")
            key, s, d, w = key[order], s[order], d[order], w[order]
            _, start = np.unique(key, return_index=True)
            w = np.add.reduceat(w, start)
            s = s[start]
            d = d[start]
        counts = np.bincount(s, minlength=n)
        indptr = np.zeros(n + 1, dtype=np.int64)
        np.cumsum(counts, out=indptr[1:])
        order = np.argsort(s, kind="stable")
        indices = d[order].astype(np.int32)
        ew = w[order]
        if node_weight is None:
            node_weight = np.ones(n, dtype=np.float64)
        if self_weight is None:
            self_weight = np.zeros(n, dtype=np.float64)
        return Graph(n=n, indptr=indptr, indices=indices, edge_weight=ew,
                     node_weight=np.asarray(node_weight, dtype=np.float64),
                     self_weight=np.asarray(self_weight, dtype=np.float64))

    @property
    def num_arcs(self) -> int:
        return int(self.indices.shape[0])

    @property
    def m(self) -> float:
        """Total undirected edge weight (self-loops included)."""
        return float(self.edge_weight.sum() / 2.0 + self.self_weight.sum())

    def neighbors(self, v: int) -> np.ndarray:
        return self.indices[self.indptr[v]:self.indptr[v + 1]]

    def degrees(self) -> np.ndarray:
        """Weighted degree per node (a self-loop of weight w counts 2w)."""
        out = 2.0 * self.self_weight.copy() if self.self_weight.shape[0] \
            else np.zeros(self.n)
        out += np.bincount(self._arc_src(), weights=self.edge_weight,
                           minlength=self.n)
        return out

    def _arc_src(self) -> np.ndarray:
        return np.repeat(np.arange(self.n, dtype=np.int64),
                         np.diff(self.indptr))

    def arcs(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(src, dst, weight) for every directed arc."""
        return self._arc_src(), self.indices.astype(np.int64), self.edge_weight

    def gather_arcs(self, nodes: np.ndarray
                    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(asrc, adst, aw): the CSR slices of all given nodes concatenated,
        in the given node order, without a Python loop."""
        counts = self.indptr[nodes + 1] - self.indptr[nodes]
        total = int(counts.sum())
        stops = np.cumsum(counts)
        flat = (np.arange(total, dtype=np.int64)
                - np.repeat(stops - counts, counts)
                + np.repeat(self.indptr[nodes], counts))
        asrc = np.repeat(nodes, counts)
        return asrc, self.indices[flat].astype(np.int64), \
            self.edge_weight[flat]

    def connected_components(self, mask: Optional[np.ndarray] = None
                             ) -> np.ndarray:
        """Component id per node (restricted to ``mask``; -1 outside)."""
        src, dst, _ = self.arcs()
        return engine.connected_components(self.n, src, dst, mask=mask)

    def aggregate(self, labels: np.ndarray) -> "Graph":
        """Quotient graph: one node per label, edge weights summed, member
        node weights summed, intra-community weight as the self-loop."""
        q = engine.quotient_edges(self, labels)
        return Graph(n=q.k, indptr=q.indptr(),
                     indices=q.dst.astype(np.int32), edge_weight=q.weight,
                     node_weight=q.node_weight, self_weight=q.intra)


# Zachary's karate club (34 nodes, 78 edges), as distributed with networkx.
_KARATE_EDGES = [
    (0, 1), (0, 2), (0, 3), (0, 4), (0, 5), (0, 6), (0, 7), (0, 8), (0, 10),
    (0, 11), (0, 12), (0, 13), (0, 17), (0, 19), (0, 21), (0, 31), (1, 2),
    (1, 3), (1, 7), (1, 13), (1, 17), (1, 19), (1, 21), (1, 30), (2, 3),
    (2, 7), (2, 8), (2, 9), (2, 13), (2, 27), (2, 28), (2, 32), (3, 7),
    (3, 12), (3, 13), (4, 6), (4, 10), (5, 6), (5, 10), (5, 16), (6, 16),
    (8, 30), (8, 32), (8, 33), (9, 33), (13, 33), (14, 32), (14, 33),
    (15, 32), (15, 33), (18, 32), (18, 33), (19, 33), (20, 32), (20, 33),
    (22, 32), (22, 33), (23, 25), (23, 27), (23, 29), (23, 32), (23, 33),
    (24, 25), (24, 27), (24, 31), (25, 31), (26, 29), (26, 33), (27, 33),
    (28, 31), (28, 33), (29, 32), (29, 33), (30, 32), (30, 33), (31, 32),
    (31, 33), (32, 33),
]


def karate_club() -> Graph:
    e = np.array(_KARATE_EDGES, dtype=np.int64)
    return Graph.from_edges(34, e[:, 0], e[:, 1])


@dataclasses.dataclass(frozen=True)
class NodeDataset:
    graph: Graph
    features: np.ndarray       # (n, f) float32
    labels: np.ndarray         # (n,) int64, or (n, tasks) float32 (multilabel)
    num_classes: int
    train_mask: np.ndarray
    val_mask: np.ndarray
    test_mask: np.ndarray
    multilabel: bool = False
    name: str = "synthetic"


def _sbm_edges(rng: np.random.Generator, block_of: np.ndarray,
               avg_deg_in: float, avg_deg_out: float
               ) -> Tuple[np.ndarray, np.ndarray]:
    """Sample SBM edges via per-node degree targets (O(m))."""
    n = block_of.shape[0]
    num_blocks = int(block_of.max()) + 1
    srcs, dsts = [], []
    for b in range(num_blocks):
        members = np.where(block_of == b)[0]
        nb = members.shape[0]
        if nb < 2:
            continue
        m_in = int(avg_deg_in * nb / 2)
        srcs.append(members[rng.integers(0, nb, m_in)])
        dsts.append(members[rng.integers(0, nb, m_in)])
    m_out = int(avg_deg_out * n / 2)
    srcs.append(rng.integers(0, n, m_out))
    dsts.append(rng.integers(0, n, m_out))
    return np.concatenate(srcs), np.concatenate(dsts)


def _ensure_connected(g: Graph, rng: np.random.Generator) -> Graph:
    comp = g.connected_components()
    k = int(comp.max()) + 1
    if k <= 1:
        return g
    # chain a random representative of each extra component to component 0
    reps = [np.where(comp == c)[0] for c in range(k)]
    extra_src = np.array([rng.choice(reps[c]) for c in range(1, k)])
    extra_dst = rng.choice(reps[0], size=k - 1)
    src, dst, w = g.arcs()
    keep = src < dst
    return Graph.from_edges(
        g.n, np.concatenate([src[keep], extra_src]),
        np.concatenate([dst[keep], extra_dst]),
        np.concatenate([w[keep], np.ones(k - 1)]),
        node_weight=g.node_weight, dedup=True)


def make_arxiv_like(n: int = 40_000, num_classes: int = 40,
                    feature_dim: int = 128, avg_deg: float = 13.8,
                    noise: float = 4.0, seed: int = 0,
                    scale: float = 1.0) -> NodeDataset:
    """A citation-network stand-in: sparse SBM with 40 classes (the paper's
    ogbn-arxiv: 169k nodes, 1.17M edges, average degree ~13.8).

    ``scale`` multiplies the node count: ``scale=169343/40000`` gives the
    ogbn-arxiv node count.
    """
    n = max(int(n * scale), 1)
    rng = np.random.default_rng(seed)
    num_blocks = num_classes * 4
    sizes = rng.pareto(1.5, num_blocks) + 1.0
    sizes = np.maximum((sizes / sizes.sum() * n).astype(np.int64), 8)
    block_of = np.repeat(np.arange(num_blocks), sizes)[:n]
    if block_of.shape[0] < n:
        block_of = np.concatenate(
            [block_of, rng.integers(0, num_blocks, n - block_of.shape[0])])
    rng.shuffle(block_of)
    src, dst = _sbm_edges(rng, block_of, avg_deg_in=avg_deg * 0.8,
                          avg_deg_out=avg_deg * 0.2)
    g = _ensure_connected(Graph.from_edges(n, src, dst), rng)
    labels = (block_of % num_classes).astype(np.int64)
    # community-correlated gaussian features: weakly informative alone,
    # informative after neighbour averaging
    centers = rng.normal(0, 1, (num_blocks, feature_dim))
    feats = (centers[block_of] + rng.normal(0, noise, (n, feature_dim))
             ).astype(np.float32)
    perm = rng.permutation(n)
    tr, va = int(0.6 * n), int(0.8 * n)
    train_mask = np.zeros(n, bool); train_mask[perm[:tr]] = True
    val_mask = np.zeros(n, bool); val_mask[perm[tr:va]] = True
    test_mask = np.zeros(n, bool); test_mask[perm[va:]] = True
    return NodeDataset(g, feats, labels, num_classes, train_mask, val_mask,
                       test_mask, multilabel=False, name="arxiv_like")


def make_proteins_like(n: int = 6_000, num_tasks: int = 112,
                       feature_dim: int = 8, avg_deg: float = 80.0,
                       seed: int = 1, scale: float = 1.0) -> NodeDataset:
    """A dense PPI stand-in: high average degree, multilabel binary tasks
    (the paper's ogbn-proteins: 132k nodes, 39.5M edges, average degree
    597, 112 tasks).

    ``scale`` multiplies the node count, as in :func:`make_arxiv_like`.
    """
    n = max(int(n * scale), 1)
    rng = np.random.default_rng(seed)
    num_blocks = 24
    block_of = rng.integers(0, num_blocks, n)
    src, dst = _sbm_edges(rng, block_of, avg_deg_in=avg_deg * 0.7,
                          avg_deg_out=avg_deg * 0.3)
    g = _ensure_connected(Graph.from_edges(n, src, dst), rng)
    proto = rng.random((num_blocks, num_tasks)) < 0.3
    flip = rng.random((n, num_tasks)) < 0.15
    labels = (proto[block_of] ^ flip).astype(np.float32)
    feats = rng.normal(0, 1, (n, feature_dim)).astype(np.float32)
    feats[:, 0] = np.log1p(g.degrees()).astype(np.float32)
    perm = rng.permutation(n)
    tr, va = int(0.6 * n), int(0.8 * n)
    train_mask = np.zeros(n, bool); train_mask[perm[:tr]] = True
    val_mask = np.zeros(n, bool); val_mask[perm[tr:va]] = True
    test_mask = np.zeros(n, bool); test_mask[perm[va:]] = True
    return NodeDataset(g, feats, labels, num_tasks, train_mask, val_mask,
                       test_mask, multilabel=True, name="proteins_like")
