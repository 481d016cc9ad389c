"""repro_torch.obs: tracing and metrics for the port, under the reference
package's API, span names and metric names.

    from repro_torch import obs

    with obs.span("partition.local_move", level=lvl, arcs=int(n_arcs)):
        ...                                   # timed + attributed region

    obs.counter("partition.sweeps").inc()     # always-on metrics
    obs.gauge("train.loss").set(0.31)
    obs.histogram("serving.batch_size").record(24)

Tracing is off by default. ``obs.span(...)`` then returns one shared no-op
context manager (no allocation, no lock, no timestamp), so an instrumented
loop costs one function call and one attribute check; call sites that
would compute an attribute at a cost (``loss.item()``, which waits for the
card) test :func:`enabled` first. Metrics are always live: a counter
increment is one locked integer add, and snapshots are deterministic.

``obs.enable()`` turns span collection on; ``obs.export_trace(path)``
writes the Chrome trace-event JSON the reference writes (open it in
Perfetto; ``python -m repro_torch.obs summarize out.json`` aggregates it,
and so does ``python -m repro.obs``). The names differ from the
reference's in two gauges only: device memory is ``cuda.device.*`` where
the reference has ``jax.device.*``.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

from .metrics import Counter, Gauge, Histogram, MetricsRegistry
from .sampler import peak_rss_bytes, sample_memory, torch_profiler_session
from .trace import Span, Tracer

__all__ = [
    "SCHEMA_VERSION", "enabled", "enable", "disable", "span", "counter",
    "gauge", "histogram", "registry", "tracer", "export_trace",
    "trace_document", "sample_memory_now", "profiler_session", "reset",
    "Counter", "Gauge", "Histogram", "MetricsRegistry", "Span", "Tracer",
    "peak_rss_bytes",
]

# Bumped when the exported trace document's shape changes (the
# reference's value: both packages write the same document).
SCHEMA_VERSION = 1

_enabled = False
_tracer = Tracer()
_registry = MetricsRegistry()


class _NoopSpan:
    """Shared do-nothing span for the disabled fast path."""

    __slots__ = ()
    duration: Optional[float] = None

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        return False

    def set(self, **attrs: Any) -> None:
        pass


_NOOP_SPAN = _NoopSpan()


def enabled() -> bool:
    """Whether span collection is on (metrics are always on)."""
    return _enabled


def enable() -> None:
    global _enabled
    _enabled = True


def disable() -> None:
    global _enabled
    _enabled = False


def span(name: str, **attrs: Any):
    """Open a nested span; no-op (shared singleton) when disabled."""
    if not _enabled:
        return _NOOP_SPAN
    return _tracer.span(name, **attrs)


def counter(name: str) -> Counter:
    return _registry.counter(name)


def gauge(name: str) -> Gauge:
    return _registry.gauge(name)


def histogram(name: str) -> Histogram:
    return _registry.histogram(name)


def registry() -> MetricsRegistry:
    return _registry


def tracer() -> Tracer:
    return _tracer


def trace_document() -> Dict[str, Any]:
    """The Chrome trace-event JSON object for everything recorded so far."""
    return _tracer.to_chrome(metrics=_registry.snapshot(),
                             schema_version=SCHEMA_VERSION)


def export_trace(path: str) -> str:
    """Write the trace (+ metrics snapshot) to ``path``; returns ``path``."""
    return _tracer.export(path, metrics=_registry.snapshot(),
                          schema_version=SCHEMA_VERSION)


def sample_memory_now() -> None:
    """Sample peak RSS and CUDA memory into the registry gauges."""
    sample_memory(_registry)


def profiler_session(out_dir: Optional[str]) -> torch_profiler_session:
    """``torch.profiler`` over a block, written to ``out_dir`` (a no-op
    when it is None)."""
    return torch_profiler_session(out_dir, registry=_registry)


def reset() -> None:
    """Clear spans and metrics and disable tracing (test isolation)."""
    global _enabled
    _enabled = False
    _tracer.reset()
    _registry.reset()
