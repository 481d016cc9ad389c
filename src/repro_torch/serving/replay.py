"""Synthetic query replay and its serving metrics.

A Zipf-shaped workload over the store's nodes (the reference package's
generator, same draws for the same seed), mixed with a fraction of unseen
node ids carrying neighbour lists — always including one with no neighbour,
so the degraded path runs every time. Known-node answers are held to the
bundle's offline answer key exactly; ``verify=True`` fails on any mismatch.

:func:`bench_row` reduces a replay to the reference's bench-row schema
(rounded as the reference rounds it) and :func:`append_bench_rows` appends
rows to a JSON trajectory file atomically. Unlike the reference, which
appends to ``benchmarks/artifacts/BENCH_serving.json`` by default, rows are
written only where the caller names a file (``DEFAULT_BENCH_JSON`` is None).
"""
from __future__ import annotations

import json
import os
import tempfile
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.device import card_info

from .batcher import Answer, ContinuousBatcher

__all__ = ["make_zipf_workload", "run_replay", "bench_row",
           "append_bench_rows", "DEFAULT_BENCH_JSON"]

#: No default trajectory file: a bench row is written only to a named path.
DEFAULT_BENCH_JSON: Optional[str] = None

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


def bench_row(row: Dict[str, Any]) -> Dict[str, Any]:
    """The bench row of one :func:`run_replay` result: the reference's
    keys and rounding, with ``warm_buckets`` in place of its two compile
    counts, plus the device, whether the inductive aggregation ran on the
    CUDA kernel, and the card's ``nvidia-smi`` name and power limit (None
    on the CPU)."""
    gpu_name, power_limit_w = card_info(row["device"])
    return {
        "queries": row["queries"],
        "wall_s": round(row["wall_s"], 3),
        "throughput_qps": round(row["throughput_qps"], 1),
        "p50_ms": round(row["p50_ms"], 3),
        "p99_ms": round(row["p99_ms"], 3),
        "mean_ms": round(row["mean_ms"], 3),
        "cache_hit_rate": row["cache_hit_rate"],
        "warm_buckets": row["warm_buckets"],
        "flushes": row["flushes"],
        "flush_reasons": row["flush_reasons"],
        "served_by_source": row["served_by_source"],
        "per_shard_served": row["per_shard_served"],
        "label_mismatches": row["label_mismatches"],
        "k": row["k"],
        "n": row["n"],
        "max_batch": row["max_batch"],
        "max_wait_ms": row["max_wait_ms"],
        "use_kernel": row["device"].startswith("cuda"),
        "partition_fingerprint": row["partition_fingerprint"],
        "device": row["device"],
        "gpu_name": gpu_name,
        "power_limit_w": power_limit_w,
    }


def append_bench_rows(rows: List[Dict[str, Any]], path: str) -> str:
    """Append ``rows``, stamped with one shared ``ts``, to the JSON list in
    ``path`` (created if missing; an unreadable file starts a new list).
    The rewrite goes through a temporary file and ``os.replace``, so an
    interrupted run cannot truncate the history. Returns ``path``."""
    directory = os.path.dirname(path) or "."
    os.makedirs(directory, exist_ok=True)
    history: List[Dict[str, Any]] = []
    if os.path.exists(path):
        try:
            with open(path) as f:
                history = json.load(f)
        except (OSError, ValueError):
            history = []
    stamp = time.time()
    history.extend({**r, "ts": stamp} for r in rows)
    fd, tmp = tempfile.mkstemp(dir=directory, suffix=".tmp")
    try:
        with os.fdopen(fd, "w") as f:
            json.dump(history, f, indent=2)
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise
    return path
