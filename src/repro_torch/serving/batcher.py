"""Continuous-batching query loop.

Queries accumulate in a queue and flush as one micro-batch when either
``max_batch`` queries wait or the oldest has waited ``max_wait_ms``. A
flush routes queries by partition: known nodes gather their embedding from
the owning shard (through the LRU hot-node cache) and run the classifier
(:func:`repro_torch.serving.store.classify`, the same row blocks as the
offline answer key); unknown nodes take the inductive fallback on the
shard owning most of their neighbours, padded to a power-of-two bucket.
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import obs

from .cache import LruNodeCache
from .inductive import InductiveEngine
from .store import classify

__all__ = ["Query", "Answer", "ContinuousBatcher", "bucket_sizes",
           "bucket_of"]


def bucket_sizes(max_batch: int) -> Tuple[int, ...]:
    """Power-of-two flush buckets: 1, 2, 4, ..., max_batch."""
    out = []
    b = 1
    while b < max_batch:
        out.append(b)
        b *= 2
    out.append(max_batch)
    return tuple(out)


def bucket_of(n: int, max_batch: int) -> int:
    """Smallest bucket holding ``n`` queries."""
    for b in bucket_sizes(max_batch):
        if n <= b:
            return b
    return max_batch


@dataclasses.dataclass
class Query:
    qid: int
    node_id: int
    neighbors: Optional[np.ndarray]     # only for unknown nodes
    t_submit: float


@dataclasses.dataclass
class Answer:
    qid: int
    node_id: int
    label: int
    shard: int
    source: str           # "cache" | "store" | "inductive" | "degraded"
    latency_ms: float
    logits: Optional[np.ndarray] = None
    embedding: Optional[np.ndarray] = None


class ContinuousBatcher:
    """max_batch/max_wait_ms flush loop over a sharded embedding store."""

    def __init__(self, store, cache: Optional[LruNodeCache] = None,
                 max_batch: int = 64, max_wait_ms: float = 2.0,
                 max_neighbors: int = 32,
                 now: Callable[[], float] = time.perf_counter):
        self.store = store
        self.cache = cache if cache is not None else LruNodeCache()
        self.max_batch = int(max_batch)
        self.max_wait_ms = float(max_wait_ms)
        self.now = now
        self.inductive = InductiveEngine(store, max_neighbors=max_neighbors)
        self._queue: deque[Query] = deque()
        self._next_qid = 0
        self.flushes = 0
        self.queries_served = 0
        self.per_shard_served: Dict[int, int] = {}
        self.flush_reasons: Dict[str, int] = {}
        self.inductive_buckets: Dict[int, int] = {}

    def submit(self, node_id: int, neighbors=None,
               now: Optional[float] = None) -> int:
        qid = self._next_qid
        self._next_qid += 1
        nb = None
        if neighbors is not None:
            nb = np.asarray(neighbors, dtype=np.int64).reshape(-1)
        self._queue.append(Query(qid=qid, node_id=int(node_id), neighbors=nb,
                                 t_submit=self.now() if now is None else now))
        return qid

    def pending(self) -> int:
        return len(self._queue)

    def due(self, now: Optional[float] = None) -> bool:
        if not self._queue:
            return False
        if len(self._queue) >= self.max_batch:
            return True
        now = self.now() if now is None else now
        return (now - self._queue[0].t_submit) * 1000.0 >= self.max_wait_ms

    def pump(self, now: Optional[float] = None) -> List[Answer]:
        """Flush as long as a flush is due; the serving loop's heartbeat."""
        out: List[Answer] = []
        while self.due(now):
            reason = ("max_batch" if len(self._queue) >= self.max_batch
                      else "max_wait_ms")
            out.extend(self.flush(reason))
        return out

    def drain(self) -> List[Answer]:
        """Flush everything regardless of the policy."""
        out: List[Answer] = []
        while self._queue:
            out.extend(self.flush("drain"))
        return out

    def warmup(self) -> int:
        """Run the classifier and every inductive bucket once (allocator,
        library handles, star graphs); returns the number of buckets."""
        e = self.store.embed_dim
        buckets = bucket_sizes(self.max_batch)
        for b in buckets:
            classify(self.store.classifier,
                     torch.zeros((b, e), device=self.store.device))
            self.inductive.infer([np.zeros(0, np.int64)] * b, b)
        if self.store.device.type == "cuda":
            torch.cuda.synchronize(self.store.device)
        return len(buckets)

    def flush(self, reason: str = "drain") -> List[Answer]:
        batch = [self._queue.popleft()
                 for _ in range(min(self.max_batch, len(self._queue)))]
        if not batch:
            return []
        self.flushes += 1
        self.flush_reasons[reason] = self.flush_reasons.get(reason, 0) + 1
        obs.counter(f"serving.flush.{reason}").inc()
        obs.histogram("serving.batch_size").record(len(batch))
        known = [q for q in batch if self.store.is_known(q.node_id)]
        unknown = [q for q in batch if not self.store.is_known(q.node_id)]
        with obs.span("serving.flush", reason=reason, batch=len(batch),
                      known=len(known), unknown=len(unknown)):
            answers = self._flush_known(known) \
                + self._flush_inductive(unknown)
        self.queries_served += len(answers)
        return answers

    def _answer(self, q: Query, label: int, shard: int, source: str,
                t_done: float, logits: np.ndarray,
                emb: np.ndarray) -> Answer:
        self.per_shard_served[shard] = self.per_shard_served.get(shard, 0) + 1
        return Answer(qid=q.qid, node_id=q.node_id, label=label, shard=shard,
                      source=source,
                      latency_ms=(t_done - q.t_submit) * 1000.0,
                      logits=logits, embedding=emb)

    def _flush_known(self, queries: List[Query]) -> List[Answer]:
        if not queries:
            return []
        obs.counter("serving.bucket.classify."
                    f"{bucket_of(len(queries), self.max_batch)}").inc()
        rows: List[Optional[torch.Tensor]] = []
        sources: List[str] = []
        miss_pos: List[int] = []
        for i, q in enumerate(queries):
            row = self.cache.get(q.node_id)
            rows.append(row)
            sources.append("store" if row is None else "cache")
            if row is None:
                miss_pos.append(i)
        if miss_pos:
            ids = [queries[i].node_id for i in miss_pos]
            fetched = self.store.lookup(np.asarray(ids))   # shard-routed
            for pos, nid, row in zip(miss_pos, ids, fetched):
                rows[pos] = row
                self.cache.put(nid, row)
        emb = torch.stack(rows)
        logits = classify(self.store.classifier, emb)
        logits_h, emb_h = logits.cpu().numpy(), emb.cpu().numpy()
        labels = logits_h.argmax(-1)
        t_done = self.now()
        return [self._answer(q, int(labels[i]),
                             int(self.store.partition_of[q.node_id]),
                             sources[i], t_done, logits_h[i], emb_h[i])
                for i, q in enumerate(queries)]

    def _flush_inductive(self, queries: List[Query]) -> List[Answer]:
        if not queries:
            return []
        b_pad = bucket_of(len(queries), self.max_batch)
        self.inductive_buckets[b_pad] = \
            self.inductive_buckets.get(b_pad, 0) + 1
        obs.counter(f"serving.bucket.inductive.{b_pad}").inc()
        nb_lists = [q.neighbors if q.neighbors is not None
                    else np.zeros(0, np.int64) for q in queries]
        emb, logits, degraded, pids = self.inductive.infer(nb_lists, b_pad)
        logits_h, emb_h = logits.cpu().numpy(), emb.cpu().numpy()
        labels = logits_h.argmax(-1)
        t_done = self.now()
        return [self._answer(q, int(labels[i]), int(pids[i]),
                             "degraded" if degraded[i] else "inductive",
                             t_done, logits_h[i], emb_h[i])
                for i, q in enumerate(queries)]

    def stats(self) -> Dict[str, Any]:
        return {
            "flushes": self.flushes,
            "flush_reasons": dict(sorted(self.flush_reasons.items())),
            "queries_served": self.queries_served,
            "max_batch": self.max_batch,
            "max_wait_ms": self.max_wait_ms,
            "buckets": list(bucket_sizes(self.max_batch)),
            "inductive_buckets": dict(sorted(self.inductive_buckets.items())),
            "per_shard_served": {str(k): v for k, v in
                                 sorted(self.per_shard_served.items())},
            "cache": self.cache.stats(),
        }
