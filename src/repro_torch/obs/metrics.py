"""Process-wide metrics registry: counters, gauges, pow2 histograms.

The port's copy of the reference's registry, with its metric kinds,
bucket rule and snapshot shape, so a snapshot of either package compares
with the other's name for name. Metrics are always live (spans are gated
behind :func:`repro_torch.obs.enabled`): a mutation is one locked update,
cheap enough that subsystems keep their counts here. Nothing here records
wall-clock state, so two processes running the same workload produce equal
counter snapshots; time lives in spans and gauges.

Histogram buckets are fixed powers of two: value ``v`` lands in the bucket
whose upper bound is the smallest ``2**i >= v`` (``v <= 1`` lands in the
``le=1`` bucket, everything past ``2**62`` in the overflow bucket), so
histograms merge across processes and compare across runs.
"""
from __future__ import annotations

import threading
from typing import Dict, List, Optional

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry",
           "pow2_bucket_index"]

_MAX_BUCKET_EXP = 62   # buckets le=2^0 .. le=2^62, plus one overflow slot


def pow2_bucket_index(value: float) -> int:
    """Index of the pow2 bucket ``value`` falls in (0 => le=1)."""
    if value <= 1:
        return 0
    v = int(value) if value == int(value) else int(value) + 1
    idx = (v - 1).bit_length()
    return min(idx, _MAX_BUCKET_EXP + 1)


class Counter:
    """Monotonic counter."""

    kind = "counter"

    def __init__(self, registry: "MetricsRegistry", name: str):
        self._registry = registry
        self.name = name
        self.value = 0

    def inc(self, n: int = 1) -> None:
        with self._registry._lock:
            self.value += n
            self._registry._ops += 1

    def snapshot(self):
        return self.value


class Gauge:
    """Last-write-wins value (may be float; gauges carry sampled state such
    as memory, so they are left out of deterministic comparisons)."""

    kind = "gauge"

    def __init__(self, registry: "MetricsRegistry", name: str):
        self._registry = registry
        self.name = name
        self.value: Optional[float] = None

    def set(self, v: float) -> None:
        with self._registry._lock:
            self.value = float(v)
            self._registry._ops += 1

    def snapshot(self):
        return self.value


class Histogram:
    """Fixed pow2-bucket histogram with count/sum/min/max."""

    kind = "histogram"

    def __init__(self, registry: "MetricsRegistry", name: str):
        self._registry = registry
        self.name = name
        self.counts: List[int] = [0] * (_MAX_BUCKET_EXP + 2)
        self.count = 0
        self.sum = 0.0
        self.min: Optional[float] = None
        self.max: Optional[float] = None

    def record(self, value: float) -> None:
        value = float(value)
        with self._registry._lock:
            self.counts[pow2_bucket_index(value)] += 1
            self.count += 1
            self.sum += value
            self.min = value if self.min is None else min(self.min, value)
            self.max = value if self.max is None else max(self.max, value)
            self._registry._ops += 1

    def snapshot(self):
        # sparse bucket map: {"le=2^i": count} for non-empty buckets only
        buckets = {}
        for i, c in enumerate(self.counts):
            if c:
                key = f"le=2^{i}" if i <= _MAX_BUCKET_EXP else "overflow"
                buckets[key] = c
        return {"count": self.count, "sum": self.sum, "min": self.min,
                "max": self.max, "buckets": buckets}


class MetricsRegistry:
    """Create-or-get registry of named metrics (thread-safe)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: Dict[str, object] = {}
        self._ops = 0     # total mutations: the overhead gate's event count

    def _get(self, name: str, cls):
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = cls(self, name)
                self._metrics[name] = m
            elif not isinstance(m, cls):
                raise TypeError(
                    f"metric {name!r} already registered as "
                    f"{type(m).__name__}, requested {cls.__name__}")
            return m

    def counter(self, name: str) -> Counter:
        return self._get(name, Counter)

    def gauge(self, name: str) -> Gauge:
        return self._get(name, Gauge)

    def histogram(self, name: str) -> Histogram:
        return self._get(name, Histogram)

    def total_ops(self) -> int:
        """Total metric mutations so far (the disabled-overhead gate
        multiplies this by the measured per-op cost)."""
        return self._ops

    def snapshot(self, kinds: Optional[tuple] = None) -> Dict[str, object]:
        """{name: {"kind", "value"}} for every registered metric, sorted by
        name; ``kinds`` keeps only those kinds (e.g. ``("counter",)``)."""
        with self._lock:
            items = sorted(self._metrics.items())
        out = {}
        for name, m in items:
            if kinds is not None and m.kind not in kinds:
                continue
            out[name] = {"kind": m.kind, "value": m.snapshot()}
        return out

    def reset(self) -> None:
        with self._lock:
            self._metrics.clear()
            self._ops = 0
