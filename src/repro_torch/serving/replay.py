"""Synthetic query replay and its serving metrics.

A Zipf-shaped workload over the store's nodes (the reference package's
generator, same draws for the same seed), mixed with a fraction of unseen
node ids carrying neighbour lists — always including one with no neighbour,
so the degraded path runs every time. Known-node answers are held to the
bundle's offline answer key exactly; ``verify=True`` fails on any mismatch.
"""
from __future__ import annotations

import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from .batcher import Answer, ContinuousBatcher

__all__ = ["make_zipf_workload", "run_replay"]

Workload = List[Tuple[int, Optional[np.ndarray]]]


def make_zipf_workload(n: int, num_queries: int = 10_000,
                       alpha: float = 1.1, unseen_frac: float = 0.02,
                       max_neighbors: int = 32, seed: int = 0) -> Workload:
    """(node_id, neighbors) pairs; neighbors only for unseen ids >= n.

    Known queries draw node ranks from Zipf(alpha) through a seeded
    permutation. Unseen queries get ids ``n, n+1, ...`` and 1..max_neighbors
    known neighbours from the same hot set; the first has none."""
    rng = np.random.default_rng(seed)
    perm = rng.permutation(n)
    ranks = rng.zipf(alpha, size=num_queries * 2)
    ranks = ranks[ranks <= n][:num_queries] - 1
    while ranks.shape[0] < num_queries:    # top up the rejected tail
        extra = rng.zipf(alpha, size=num_queries)
        extra = extra[extra <= n] - 1
        ranks = np.concatenate([ranks, extra])[:num_queries]
    nodes = perm[ranks]

    workload: Workload = [(int(v), None) for v in nodes]
    n_unseen = int(round(num_queries * unseen_frac))
    if n_unseen:
        slots = rng.choice(num_queries, size=n_unseen, replace=False)
        for j, slot in enumerate(np.sort(slots)):
            if j == 0:
                nbs = np.zeros(0, dtype=np.int64)   # zero known neighbours
            else:
                d = int(rng.integers(1, max_neighbors + 1))
                nbs = perm[np.minimum(rng.zipf(alpha, size=d), n) - 1]
            workload[slot] = (n + j, nbs)
    return workload


def run_replay(batcher: ContinuousBatcher, workload: Workload,
               verify: bool = True) -> Dict[str, Any]:
    """Drive the batcher through the workload; returns the metrics row."""
    store = batcher.store
    warm_buckets = batcher.warmup()
    answers: List[Answer] = []
    t0 = time.perf_counter()
    for node_id, neighbors in workload:
        batcher.submit(node_id, neighbors=neighbors)
        answers.extend(batcher.pump())
    answers.extend(batcher.drain())
    wall = time.perf_counter() - t0

    if len(answers) != len(workload):
        raise AssertionError(f"{len(answers)} answers for "
                             f"{len(workload)} queries")
    lat = np.asarray([a.latency_ms for a in answers])
    by_source: Dict[str, int] = {}
    mismatches = []
    known = 0
    for a in answers:
        by_source[a.source] = by_source.get(a.source, 0) + 1
        if store.is_known(a.node_id):
            known += 1
            if a.label != int(store.predictions[a.node_id]):
                mismatches.append((a.qid, a.node_id, a.label,
                                   int(store.predictions[a.node_id])))
    if verify and mismatches:
        raise AssertionError(
            f"{len(mismatches)} served labels diverge from the offline "
            f"answer key (first: {mismatches[:3]})")

    stats = batcher.stats()
    return {
        "queries": len(workload),
        "known_queries": known,
        "wall_s": wall,
        "throughput_qps": len(workload) / max(wall, 1e-9),
        "p50_ms": float(np.percentile(lat, 50)),
        "p99_ms": float(np.percentile(lat, 99)),
        "mean_ms": float(lat.mean()),
        "cache_hit_rate": stats["cache"]["hit_rate"],
        "warm_buckets": warm_buckets,
        "flushes": stats["flushes"],
        "flush_reasons": stats["flush_reasons"],
        "served_by_source": by_source,
        "per_shard_served": stats["per_shard_served"],
        "label_mismatches": len(mismatches),
        "mismatched_nodes": [m[1] for m in mismatches[:20]],
        "inductive_buckets": stats["inductive_buckets"],
        "k": store.k,
        "n": store.n,
        "max_batch": batcher.max_batch,
        "max_wait_ms": batcher.max_wait_ms,
        "device": str(store.device),
        "partition_fingerprint": store.fingerprint,
    }
