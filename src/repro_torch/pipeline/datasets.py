"""Dataset registry and the graph fingerprint.

Names are normalized (``-`` == ``_``). :func:`graph_fingerprint` hashes
the CSR buffers exactly as the reference package does, so serving bundles
of either package name the same graph with the same digest.
"""
from __future__ import annotations

import hashlib
from typing import Callable, Dict

import numpy as np

from repro_torch.core import (Graph, NodeDataset, karate_club,
                              make_arxiv_like, make_proteins_like)

__all__ = ["DATASETS", "get_dataset", "make_karate_dataset",
           "graph_fingerprint"]

# Zachary (1977) ground-truth factions: 0 = Mr. Hi, 1 = Officer.
_KARATE_OFFICER = frozenset(
    {9, 14, 15, 18, 20, 22, 23, 24, 25, 26, 27, 28, 29, 30, 31, 32, 33})


def make_karate_dataset(seed: int = 0) -> NodeDataset:
    """Zachary's karate club as a 2-class task with one-hot features."""
    g = karate_club()
    labels = np.array([1 if v in _KARATE_OFFICER else 0 for v in range(g.n)],
                      dtype=np.int64)
    features = np.eye(g.n, dtype=np.float32)
    rng = np.random.default_rng(seed)
    perm = rng.permutation(g.n)
    tr, va = int(0.6 * g.n), int(0.8 * g.n)
    train_mask = np.zeros(g.n, bool); train_mask[perm[:tr]] = True
    val_mask = np.zeros(g.n, bool); val_mask[perm[tr:va]] = True
    test_mask = np.zeros(g.n, bool); test_mask[perm[va:]] = True
    return NodeDataset(g, features, labels, 2, train_mask, val_mask,
                       test_mask, multilabel=False, name="karate")


DATASETS: Dict[str, Callable[..., NodeDataset]] = {
    "karate": make_karate_dataset,
    "arxiv_like": make_arxiv_like,
    "proteins_like": make_proteins_like,
    # short aliases
    "arxiv": make_arxiv_like,
    "proteins": make_proteins_like,
}


def get_dataset(name: str, **kwargs) -> NodeDataset:
    """Resolve ``name`` (hyphens/underscores interchangeable) and build it."""
    key = name.replace("-", "_")
    try:
        factory = DATASETS[key]
    except KeyError:
        raise KeyError(f"unknown dataset {name!r}; "
                       f"available: {sorted(DATASETS)}") from None
    return factory(**kwargs)


def graph_fingerprint(g: Graph) -> str:
    """Content hash of the graph topology (hex sha256 of the CSR buffers
    and node/self weights; features and labels are excluded)."""
    h = hashlib.sha256()
    h.update(np.int64(g.n).tobytes())
    # the two spellings of "no self-loops" (zeros(0), zeros(n)) hash alike
    sw = np.asarray(g.self_weight, dtype=np.float64)
    if not sw.any():
        sw = np.zeros(0)
    for arr in (g.indptr, g.indices, g.edge_weight, g.node_weight, sw):
        a = np.ascontiguousarray(arr)
        h.update(a.dtype.str.encode())
        h.update(a.tobytes())
    return h.hexdigest()
