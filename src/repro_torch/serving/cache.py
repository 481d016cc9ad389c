"""LRU hot-node cache in front of the embedding store.

A Zipf-shaped query stream concentrates on a small hot set; the cache keeps
those rows (views of device tensors) in front of the sharded lookup and
counts hits, misses and evictions, in its own fields and in the
``serving.cache.*`` counters of :mod:`repro_torch.obs`.
"""
from __future__ import annotations

from collections import OrderedDict
from typing import Optional

import torch

from repro_torch import obs

__all__ = ["LruNodeCache"]


class LruNodeCache:
    """Bounded node-id -> embedding-row LRU with hit/miss counters."""

    def __init__(self, capacity: int = 4096):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = int(capacity)
        self._d: "OrderedDict[int, torch.Tensor]" = OrderedDict()
        self.hits = 0
        self.misses = 0
        self.evictions = 0

    def __len__(self) -> int:
        return len(self._d)

    def __contains__(self, node_id: int) -> bool:
        return int(node_id) in self._d

    def get(self, node_id: int) -> Optional[torch.Tensor]:
        key = int(node_id)
        row = self._d.get(key)
        if row is None:
            self.misses += 1
            obs.counter("serving.cache.misses").inc()
            return None
        self._d.move_to_end(key)
        self.hits += 1
        obs.counter("serving.cache.hits").inc()
        return row

    def put(self, node_id: int, row: torch.Tensor) -> None:
        key = int(node_id)
        if key in self._d:
            self._d.move_to_end(key)
        self._d[key] = row
        if len(self._d) > self.capacity:
            self._d.popitem(last=False)
            self.evictions += 1
            obs.counter("serving.cache.evictions").inc()

    @property
    def hit_rate(self) -> float:
        total = self.hits + self.misses
        return self.hits / total if total else 0.0

    def stats(self) -> dict:
        return {"capacity": self.capacity, "size": len(self._d),
                "hits": self.hits, "misses": self.misses,
                "evictions": self.evictions,
                "hit_rate": round(self.hit_rate, 4)}
