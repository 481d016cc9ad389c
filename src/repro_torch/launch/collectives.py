"""Counted collectives: the port's counterpart of the reference's
``launch.hlo_analysis.collective_bytes``.

The reference counts the collectives of a compiled step from its HLO: the
result-shape bytes of every communication op (an async pair once, by its
``-start`` op). The port issues its collectives itself, so it counts them
where it issues them: every collective goes through one of the wrappers
below, which records, on this rank, the op's name and its result bytes
under the phase it runs in. :func:`counted` returns the reference's keys:
every op of :data:`COLLECTIVE_OPS`, ``n_<op>`` and ``total``.

Phases (:data:`PHASES`): ``"training steps"`` (what a step moves: the
reference's report), ``"embedding gather"`` (the pooled table and the
embedding pass's exchanges) and ``"integration"`` (bringing the k models
together). A collective issued outside :func:`phase` raises, so nothing
goes uncounted. A trainer reads a step's count as the difference of two
:func:`counted` reads (:func:`delta`).

The wrappers also add the host seconds of each blocking call to the
phase (:func:`seconds`), and :func:`add_staging` adds the seconds a
caller spends copying a collective's buffers between the card and host
memory, timed apart.
"""
from __future__ import annotations

import contextlib
import time
import warnings
from typing import Dict, Iterator, Optional

import torch
import torch.distributed as dist

__all__ = ["COLLECTIVE_OPS", "PHASES", "phase", "counted", "delta",
           "seconds", "add_staging", "reset", "all_gather_into_tensor",
           "reduce_scatter_tensor", "all_reduce"]

#: The reference's ``launch.hlo_analysis.COLLECTIVE_OPS``.
COLLECTIVE_OPS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
                  "collective-permute")
PHASES = ("training steps", "embedding gather", "integration")

# torch 2.13 deprecates both in favour of ``*_single`` calls that older
# versions lack; the port calls the pair every version has
warnings.filterwarnings(
    "ignore", category=FutureWarning,
    message=r"`torch\.distributed\.(all_gather_into_tensor|"
            r"reduce_scatter_tensor)` is deprecated")

_bytes: Dict[str, Dict[str, int]] = {}
_counts: Dict[str, Dict[str, int]] = {}
_seconds: Dict[str, Dict[str, float]] = {}
_current: Optional[str] = None


def reset() -> None:
    """Zero every phase's counts and seconds."""
    for p in PHASES:
        _bytes[p] = dict.fromkeys(COLLECTIVE_OPS, 0)
        _counts[p] = dict.fromkeys(COLLECTIVE_OPS, 0)
        _seconds[p] = {"collective_s": 0.0, "staging_s": 0.0}


reset()


@contextlib.contextmanager
def phase(name: str) -> Iterator[None]:
    """Count the collectives issued in the block under ``name``."""
    global _current
    if name not in PHASES:
        raise ValueError(f"phase must be one of {PHASES}, got {name!r}")
    outer, _current = _current, name
    try:
        yield
    finally:
        _current = outer


def counted(phase_name: Optional[str] = None) -> Dict[str, int]:
    """Result bytes by op, ``n_<op>`` and ``total`` of one phase (None:
    all phases), since the last :func:`reset`."""
    names = PHASES if phase_name is None else (phase_name,)
    out = {op: sum(_bytes[p][op] for p in names) for op in COLLECTIVE_OPS}
    out["total"] = sum(out[op] for op in COLLECTIVE_OPS)
    out.update({f"n_{op}": sum(_counts[p][op] for p in names)
                for op in COLLECTIVE_OPS})
    return out


def delta(after: Dict[str, int], before: Dict[str, int]) -> Dict[str, int]:
    """``after - before``, key by key (one step's count)."""
    return {key: after[key] - before[key] for key in after}


def seconds(phase_name: str) -> Dict[str, float]:
    """Host seconds in the phase's collectives and in staging copies."""
    return dict(_seconds[phase_name])


def add_staging(s: float) -> None:
    """Add ``s`` seconds of staging copies to the current phase."""
    _seconds[_phase()]["staging_s"] += s


def _phase() -> str:
    if _current is None:
        raise RuntimeError("a collective outside a counted phase; wrap it "
                           "in repro_torch.launch.collectives.phase(...)")
    return _current


def _record(op: str, result: torch.Tensor, t0: float) -> None:
    p = _phase()
    _bytes[p][op] += result.numel() * result.element_size()
    _counts[p][op] += 1
    _seconds[p]["collective_s"] += time.perf_counter() - t0


def all_gather_into_tensor(out: torch.Tensor, inp: torch.Tensor,
                           group=None) -> torch.Tensor:
    """``out`` (the group's ``inp`` concatenated along dim 0), counted."""
    _phase()
    t0 = time.perf_counter()
    dist.all_gather_into_tensor(out, inp, group=group)
    _record("all-gather", out, t0)
    return out


def reduce_scatter_tensor(out: torch.Tensor, inp: torch.Tensor,
                          group=None) -> torch.Tensor:
    """``out``: this rank's block of the sum of ``inp`` over the group
    (``inp`` is the group size times ``out`` along dim 0), counted."""
    _phase()
    t0 = time.perf_counter()
    dist.reduce_scatter_tensor(out, inp, group=group)
    _record("reduce-scatter", out, t0)
    return out


def all_reduce(t: torch.Tensor, group=None) -> torch.Tensor:
    """``t`` summed over the group in place, counted."""
    _phase()
    t0 = time.perf_counter()
    dist.all_reduce(t, group=group)
    _record("all-reduce", t, t0)
    return t
