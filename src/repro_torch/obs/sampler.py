"""Memory samplers and the optional ``torch.profiler`` session.

Two memory sources feed gauges in the registry:

* host peak RSS: ``resource.getrusage(RUSAGE_SELF).ru_maxrss`` (kilobytes
  on Linux, bytes on macOS; normalized to bytes) into
  ``process.peak_rss_bytes``, the reference's gauge;
* CUDA memory: ``torch.cuda.memory_stats()``'s
  ``allocated_bytes.all.current`` and ``.peak`` into
  ``cuda.device.bytes_in_use`` and ``cuda.device.peak_bytes_in_use`` (the
  reference's ``jax.device.*``), once the process has initialized CUDA. A
  CPU-only process sets no device gauge.

``torch`` is imported inside the functions, so ``python -m
repro_torch.obs`` reads traces without loading it.
"""
from __future__ import annotations

import os
import sys
import time
from typing import Optional

__all__ = ["peak_rss_bytes", "sample_memory", "torch_profiler_session"]


def peak_rss_bytes() -> Optional[int]:
    """Process peak RSS in bytes, or None where unsupported."""
    try:
        import resource
    except ImportError:          # non-POSIX
        return None
    ru = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
    if sys.platform == "darwin":
        return int(ru)           # macOS reports bytes
    return int(ru) * 1024        # Linux reports kilobytes


def _device_memory() -> Optional[dict]:
    import torch
    if not torch.cuda.is_initialized():
        return None
    stats = torch.cuda.memory_stats()
    return {"bytes_in_use": stats.get("allocated_bytes.all.current", 0),
            "peak_bytes_in_use": stats.get("allocated_bytes.all.peak", 0)}


def sample_memory(registry) -> None:
    """Record current memory readings into ``registry`` gauges."""
    rss = peak_rss_bytes()
    if rss is not None:
        registry.gauge("process.peak_rss_bytes").set(rss)
    stats = _device_memory()
    if stats:
        for key, value in stats.items():
            registry.gauge(f"cuda.device.{key}").set(value)


class torch_profiler_session:
    """Context manager running ``torch.profiler`` over its body and writing
    a Chrome trace (``*.pt.trace.json``) into ``out_dir``.

    It records CPU ops, and CUDA kernels when a card is present. The
    pipeline wraps its training stage in one when given a profile directory
    (``--torch-profile DIR``). As in the reference, a profiler that cannot
    start or export is counted (``torch.profiler.failed``) and the body
    runs all the same; ``path`` is then None, so a caller that needs the
    file finds it missing."""

    def __init__(self, out_dir: Optional[str], registry=None):
        self.out_dir = out_dir
        self.path: Optional[str] = None
        self._registry = registry
        self._prof = None

    def _failed(self) -> None:
        if self._registry is not None:
            self._registry.counter("torch.profiler.failed").inc()

    def __enter__(self):
        if not self.out_dir:
            return self
        try:
            import torch
            from torch.profiler import ProfilerActivity, profile
            acts = [ProfilerActivity.CPU]
            if torch.cuda.is_available():
                acts.append(ProfilerActivity.CUDA)
            prof = profile(activities=acts)
            prof.__enter__()
            self._prof = prof
        except Exception:
            self._failed()
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        if self._prof is None:
            return False
        try:
            self._prof.__exit__(exc_type, exc, tb)
            os.makedirs(self.out_dir, exist_ok=True)
            path = os.path.join(
                self.out_dir,
                f"torch_profile.{os.getpid()}.{time.time_ns()}.pt.trace.json")
            self._prof.export_chrome_trace(path)
            self.path = path
        except Exception:
            self._failed()
        return False
