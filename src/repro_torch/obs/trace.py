"""Nestable spans with Chrome trace-event / Perfetto JSON export.

A span is a timed region: ``with tracer.span("partition.local_move",
level=0, arcs=n):``. Spans nest through a thread-local stack and record
host wall time (``time.perf_counter`` against the tracer's start), the
thread id and JSON-able attributes. They survive exceptions: the context
manager always closes the span and stamps an ``error`` attribute with the
exception type on the way out. A span times the host; work it queued on a
card is inside it only if the span ends in a synchronize.

The export is the Chrome trace-event "JSON Object Format": a top-level
object whose ``traceEvents`` list holds complete events (``ph: "X"``) with
microsecond ``ts``/``dur``, plus the schema marker and a metrics snapshot
as extra top-level keys. The document is the reference package's, so
either package's ``summarize``/``validate`` reads the other's traces; only
the process name differs (``repro_torch``).

Standard library only: ``repro_torch.core`` imports this at module level.
"""
from __future__ import annotations

import json
import os
import threading
import time
from typing import Any, Dict, List, Optional

__all__ = ["Span", "Tracer", "MAX_EVENTS"]

# Memory bound: a span record is ~200 bytes, so the cap holds the trace
# buffer under ~100MB even if a caller instruments a per-arc loop.
MAX_EVENTS = 500_000


class Span:
    """One open (then closed) timed region."""

    __slots__ = ("name", "attrs", "t0", "duration", "tid", "depth")

    def __init__(self, name: str, attrs: Dict[str, Any], t0: float,
                 tid: int, depth: int):
        self.name = name
        self.attrs = attrs
        self.t0 = t0
        self.duration: Optional[float] = None   # seconds, set on close
        self.tid = tid
        self.depth = depth

    def set(self, **attrs: Any) -> None:
        """Attach/overwrite attributes on an open span."""
        self.attrs.update(attrs)


class _SpanContext:
    """Context manager binding a Span to the tracer's thread-local stack."""

    __slots__ = ("_tracer", "span")

    def __init__(self, tracer: "Tracer", span: Span):
        self._tracer = tracer
        self.span = span

    def __enter__(self) -> Span:
        return self.span

    def __exit__(self, exc_type, exc, tb) -> bool:
        if exc_type is not None:
            self.span.attrs["error"] = exc_type.__name__
        self._tracer._close(self.span)
        return False   # never swallow the exception


class Tracer:
    """Collects spans process-wide; thread-safe, one stack per thread."""

    def __init__(self):
        self._lock = threading.Lock()
        self._events: List[Span] = []
        self._local = threading.local()
        self._epoch = time.perf_counter()
        self._dropped = 0

    # -- recording ---------------------------------------------------------

    def _stack(self) -> list:
        st = getattr(self._local, "stack", None)
        if st is None:
            st = self._local.stack = []
        return st

    def span(self, name: str, **attrs: Any) -> _SpanContext:
        stack = self._stack()
        sp = Span(name, attrs, time.perf_counter(),
                  threading.get_ident(), len(stack))
        stack.append(sp)
        return _SpanContext(self, sp)

    def _close(self, sp: Span) -> None:
        sp.duration = time.perf_counter() - sp.t0
        stack = self._stack()
        # Exception safety: unwind past any inner spans a non-local exit
        # (e.g. generator close) left open, closing them with this one.
        while stack:
            inner = stack.pop()
            if inner is sp:
                break
            if inner.duration is None:
                inner.duration = time.perf_counter() - inner.t0
                self._record(inner)
        self._record(sp)

    def _record(self, sp: Span) -> None:
        with self._lock:
            if len(self._events) >= MAX_EVENTS:
                self._dropped += 1
                return
            self._events.append(sp)

    # -- introspection -----------------------------------------------------

    def event_count(self) -> int:
        with self._lock:
            return len(self._events)

    def spans(self) -> List[Span]:
        with self._lock:
            return list(self._events)

    def reset(self) -> None:
        with self._lock:
            self._events.clear()
            self._dropped = 0
            self._epoch = time.perf_counter()

    # -- export ------------------------------------------------------------

    def to_chrome(self, metrics: Optional[Dict[str, Any]] = None,
                  schema_version: int = 1) -> Dict[str, Any]:
        """Build the Chrome trace-event JSON object."""
        pid = os.getpid()
        events: List[Dict[str, Any]] = [{
            "ph": "M", "name": "process_name", "pid": pid, "tid": 0,
            "args": {"name": "repro_torch"},
        }]
        with self._lock:
            spans = list(self._events)
            dropped = self._dropped
        for sp in spans:
            cat = sp.name.split(".", 1)[0]
            args = dict(sp.attrs)
            args["depth"] = sp.depth
            events.append({
                "ph": "X",
                "name": sp.name,
                "cat": cat,
                "pid": pid,
                "tid": sp.tid,
                "ts": round((sp.t0 - self._epoch) * 1e6, 3),
                "dur": round((sp.duration or 0.0) * 1e6, 3),
                "args": args,
            })
        out: Dict[str, Any] = {
            "schema": "repro-obs-trace",
            "version": schema_version,
            "displayTimeUnit": "ms",
            "traceEvents": events,
        }
        if dropped:
            out["droppedEvents"] = dropped
        if metrics is not None:
            out["metrics"] = metrics
        return out

    def export(self, path: str, metrics: Optional[Dict[str, Any]] = None,
               schema_version: int = 1) -> str:
        doc = self.to_chrome(metrics=metrics, schema_version=schema_version)
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(doc, f)
        os.replace(tmp, path)
        return path
