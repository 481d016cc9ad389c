"""Partitioning methods: Leiden-Fusion and the paper's baselines (numpy).

- ``random_partition``  — uniform node assignment (paper §3.1).
- ``lpa_partition``     — label propagation seeded with k labels, as Spark
  Local [Duong et al. 2021] uses it.
- ``metis_partition``   — a multilevel k-way partitioner in the METIS
  family: heavy-edge-matching coarsening, recursive BFS bisection, boundary
  refinement. Low cut and balanced sizes, but no connectivity guarantee:
  the property the paper contrasts against.
- ``with_fusion``       — the "+F" operator of paper §5.4: split every
  partition into its connected components, then fuse down to k.
- ``leiden_fusion``     — from :mod:`repro_torch.core.fusion`.

Every method draws from ``np.random.default_rng`` in the reference
package's order and breaks ties as it does, so the same graph, k and seed
give byte-identical labels in both packages. Each is registered with a
frozen config (:mod:`repro_torch.core.registry`) and selectable by spec
string (:mod:`repro_torch.core.spec`): ``"lpa(max_iter=30)"``,
``"metis+f(alpha=0.1)"``, ``"leiden_fusion(resolution=0.5)"``.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np

from .engine import split_components
from .fusion import fuse, leiden_fusion
from .graph import Graph
from .registry import Capabilities, register_partitioner

__all__ = ["random_partition", "single_partition", "lpa_partition",
           "metis_partition", "leiden_fusion", "with_fusion",
           "split_into_components", "SingleConfig", "RandomConfig",
           "LpaConfig", "MetisConfig", "LeidenFusionConfig"]


def random_partition(g: Graph, k: int, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return rng.integers(0, k, g.n).astype(np.int64)


def single_partition(g: Graph, k: int = 1, seed: int = 0) -> np.ndarray:
    """Everything in one partition, the centralized reference (k ignored)."""
    return np.zeros(g.n, dtype=np.int64)


def lpa_partition(g: Graph, k: int, seed: int = 0, max_iter: int = 50,
                  balance_cap: float = 1.10) -> np.ndarray:
    """Label propagation with k initial labels.

    Nodes start with a random label in [0, k); each sweep gives every node
    the weighted majority label of its neighbours, under a soft size cap
    (Spinner-style). Seed-sensitive by construction, the weakness the paper
    points out.
    """
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, k, g.n).astype(np.int64)
    cap = balance_cap * g.n / k
    counts = np.bincount(labels, minlength=k).astype(np.float64)
    indptr, indices, ew = g.indptr, g.indices, g.edge_weight
    for _ in range(max_iter):
        moved = 0
        order = rng.permutation(g.n)
        for v in order:
            v = int(v)
            nbrs = indices[indptr[v]:indptr[v + 1]]
            if nbrs.size == 0:
                continue
            w = ew[indptr[v]:indptr[v + 1]]
            score = np.zeros(k)
            np.add.at(score, labels[nbrs], w)
            # soft cap: forbid overfull targets
            cur = int(labels[v])
            score[(counts >= cap)] = -np.inf
            score[cur] = max(score[cur], 0.0) if counts[cur] < cap else score[cur]
            new = int(np.argmax(score))
            if score[new] == -np.inf:
                new = cur
            if new != cur and score[new] >= score[cur]:
                labels[v] = new
                counts[cur] -= 1
                counts[new] += 1
                moved += 1
        if moved == 0:
            break
    return labels


# -- METIS-like multilevel k-way partitioner ---------------------------------

def _heavy_edge_matching(g: Graph, rng: np.random.Generator) -> np.ndarray:
    """Greedy heavy-edge matching; returns the coarse node id per node."""
    match = np.full(g.n, -1, dtype=np.int64)
    order = rng.permutation(g.n)
    for v in order:
        v = int(v)
        if match[v] >= 0:
            continue
        nbrs = g.indices[g.indptr[v]:g.indptr[v + 1]]
        ws = g.edge_weight[g.indptr[v]:g.indptr[v + 1]]
        best, best_w = -1, -1.0
        for u, w in zip(nbrs, ws):
            u = int(u)
            if match[u] < 0 and u != v and w > best_w:
                best, best_w = u, w
        if best >= 0:
            match[v] = v
            match[best] = v
        else:
            match[v] = v
    _, coarse = np.unique(match, return_inverse=True)
    return coarse.astype(np.int64)


def _bfs_order(g: Graph, nodes: np.ndarray, rng: np.random.Generator
               ) -> np.ndarray:
    """BFS order of ``nodes`` within their induced subgraph (every
    component, restarting from a random unvisited node)."""
    inset = np.zeros(g.n, dtype=bool)
    inset[nodes] = True
    seen = np.zeros(g.n, dtype=bool)
    order: list[int] = []
    for seed in rng.permutation(nodes):
        seed = int(seed)
        if seen[seed]:
            continue
        seen[seed] = True
        queue = [seed]
        head = 0
        while head < len(queue):
            v = queue[head]
            head += 1
            order.append(v)
            for u in g.neighbors(v):
                u = int(u)
                if inset[u] and not seen[u]:
                    seen[u] = True
                    queue.append(u)
    return np.array(order, dtype=np.int64)


def _greedy_growth_partition(g: Graph, k: int, rng: np.random.Generator
                             ) -> np.ndarray:
    """Initial k-way partition by recursive BFS bisection, balanced by node
    weight (BFS prefixes keep the halves mostly contiguous)."""
    labels = np.zeros(g.n, dtype=np.int64)

    def split(nodes: np.ndarray, parts: int, base: int) -> None:
        if parts == 1:
            labels[nodes] = base
            return
        left_parts = parts // 2
        order = _bfs_order(g, nodes, rng)
        w = np.cumsum(g.node_weight[order])
        target = w[-1] * left_parts / parts
        cut = int(np.searchsorted(w, target)) + 1
        cut = min(max(cut, 1), order.shape[0] - 1)
        split(order[:cut], left_parts, base)
        split(order[cut:], parts - left_parts, base + left_parts)

    split(np.arange(g.n, dtype=np.int64), k, 0)
    return labels


def _fm_refine(g: Graph, labels: np.ndarray, k: int, passes: int = 4,
               balance_cap: float = 1.05) -> np.ndarray:
    """Boundary refinement: move boundary nodes to cut less, keep balance."""
    labels = labels.copy()
    total = g.node_weight.sum()
    cap = balance_cap * total / k
    sizes = np.zeros(k)
    np.add.at(sizes, labels, g.node_weight)
    indptr, indices, ew = g.indptr, g.indices, g.edge_weight
    for _ in range(passes):
        moved = 0
        for v in range(g.n):
            nbrs = indices[indptr[v]:indptr[v + 1]]
            if nbrs.size == 0:
                continue
            w = ew[indptr[v]:indptr[v + 1]]
            cur = int(labels[v])
            score = np.zeros(k)
            np.add.at(score, labels[nbrs], w)
            gain = score - score[cur]
            gain[cur] = 0.0
            gain[sizes + g.node_weight[v] > cap] = -np.inf
            best = int(np.argmax(gain))
            if gain[best] > 1e-12:
                labels[v] = best
                sizes[cur] -= g.node_weight[v]
                sizes[best] += g.node_weight[v]
                moved += 1
        if moved == 0:
            break
    return labels


def metis_partition(g: Graph, k: int, seed: int = 0,
                    coarsen_to: int = 400) -> np.ndarray:
    """Multilevel k-way partitioning (METIS family)."""
    rng = np.random.default_rng(seed)
    graphs = [g]
    mappings = []  # mappings[i]: nodes of graphs[i] -> nodes of graphs[i+1]
    while graphs[-1].n > max(coarsen_to, 4 * k):
        coarse = _heavy_edge_matching(graphs[-1], rng)
        if int(coarse.max()) + 1 >= graphs[-1].n:  # matching stalled
            break
        mappings.append(coarse)
        graphs.append(graphs[-1].aggregate(coarse))
    labels = _greedy_growth_partition(graphs[-1], k, rng)
    labels = _fm_refine(graphs[-1], labels, k)
    # uncoarsen, refining at each level
    for level in range(len(mappings) - 1, -1, -1):
        labels = labels[mappings[level]]
        labels = _fm_refine(graphs[level], labels, k)
    return labels.astype(np.int64)


# -- "+F": fusion over any base partitioning (paper §5.4) --------------------

def split_into_components(g: Graph, labels: np.ndarray) -> np.ndarray:
    """Relabel so every connected component of every partition is its own
    community (the extra step that makes +F slower for METIS and LPA)."""
    return split_components(g, labels)


def with_fusion(base: Callable[..., np.ndarray], g: Graph, k: int,
                alpha: float = 0.05, seed: int = 0,
                base_k: Optional[int] = None) -> np.ndarray:
    """Run ``base`` (with base_k or k as its target), split into
    components, fuse to k: the functional form of the ``+f`` combinator,
    for bases that are not registered."""
    labels = base(g, base_k or k, seed=seed)
    comms = split_into_components(g, labels)
    max_part_size = (g.n / k) * (1.0 + alpha)
    return fuse(g, comms, k, max_part_size)


# -- typed configs and registry entries --------------------------------------

@dataclasses.dataclass(frozen=True)
class SingleConfig:
    """The centralized reference has no hyperparameters."""


@dataclasses.dataclass(frozen=True)
class RandomConfig:
    """Uniform random assignment has no hyperparameters."""


@dataclasses.dataclass(frozen=True)
class LpaConfig:
    max_iter: int = dataclasses.field(
        default=50, metadata={"help": "propagation sweeps before giving up"})
    balance_cap: float = dataclasses.field(
        default=1.10, metadata={"help": "soft size cap as a multiple of n/k"})

    def __post_init__(self):
        if self.max_iter < 1:
            raise ValueError(f"max_iter must be >= 1, got {self.max_iter}")
        if self.balance_cap < 1.0:
            raise ValueError(f"balance_cap must be >= 1.0, "
                             f"got {self.balance_cap}")


@dataclasses.dataclass(frozen=True)
class MetisConfig:
    coarsen_to: int = dataclasses.field(
        default=400, metadata={"help": "stop coarsening below this many "
                                       "nodes"})

    def __post_init__(self):
        if self.coarsen_to < 1:
            raise ValueError(f"coarsen_to must be >= 1, "
                             f"got {self.coarsen_to}")


@dataclasses.dataclass(frozen=True)
class LeidenFusionConfig:
    alpha: float = dataclasses.field(
        default=0.05, metadata={"help": "balance slack: max part size is "
                                        "(n/k)*(1+alpha)"})
    beta: float = dataclasses.field(
        default=0.5, metadata={"help": "Leiden community size cap as a "
                                       "fraction of max part size"})
    resolution: float = dataclasses.field(
        default=1.0, metadata={"help": "Leiden modularity resolution gamma"})

    def __post_init__(self):
        if not (self.alpha >= 0.0):
            raise ValueError(f"alpha must be >= 0, got {self.alpha}")
        if not (0.0 < self.beta <= 1.0):
            raise ValueError(f"beta must be in (0, 1], got {self.beta}")
        if not (self.resolution > 0.0):
            raise ValueError(f"resolution must be > 0, "
                             f"got {self.resolution}")


@register_partitioner(
    "single", config=SingleConfig,
    capabilities=Capabilities(connectivity_guaranteed=True, balanced=False),
    doc="everything in one partition — the centralized reference")
def _single(g: Graph, k: int, seed: int, cfg: SingleConfig) -> np.ndarray:
    return single_partition(g, k, seed=seed)


@register_partitioner(
    "random", config=RandomConfig,
    capabilities=Capabilities(connectivity_guaranteed=False, balanced=False),
    doc="uniform random node assignment (paper §3.1 baseline)")
def _random(g: Graph, k: int, seed: int, cfg: RandomConfig) -> np.ndarray:
    return random_partition(g, k, seed=seed)


@register_partitioner(
    "lpa", config=LpaConfig,
    capabilities=Capabilities(connectivity_guaranteed=False, balanced=True),
    doc="label propagation with k initial labels (Spark Local baseline)")
def _lpa(g: Graph, k: int, seed: int, cfg: LpaConfig) -> np.ndarray:
    return lpa_partition(g, k, seed=seed, max_iter=cfg.max_iter,
                         balance_cap=cfg.balance_cap)


@register_partitioner(
    "metis", config=MetisConfig,
    capabilities=Capabilities(connectivity_guaranteed=False, balanced=True),
    doc="multilevel k-way partitioning (METIS family)")
def _metis(g: Graph, k: int, seed: int, cfg: MetisConfig) -> np.ndarray:
    return metis_partition(g, k, seed=seed, coarsen_to=cfg.coarsen_to)


@register_partitioner(
    "leiden_fusion", config=LeidenFusionConfig,
    capabilities=Capabilities(connectivity_guaranteed=True, balanced=True),
    doc="the paper's method: size-capped Leiden + community Fusion")
def _leiden_fusion(g: Graph, k: int, seed: int,
                   cfg: LeidenFusionConfig) -> np.ndarray:
    return leiden_fusion(g, k, alpha=cfg.alpha, beta=cfg.beta, seed=seed,
                         gamma=cfg.resolution)
