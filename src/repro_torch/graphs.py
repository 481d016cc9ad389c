"""Compiled steps: one CUDA graph per input signature, the port's
counterpart of the reference's ``jax.jit`` at fixed shapes.

:class:`CapturedStep` wraps a function of tensors. The signature of a call
is the structure of its arguments (dicts, lists, tuples, named tuples and
dataclasses), each tensor's shape, dtype and device, each generator's
device, and the value of every other leaf. On a CUDA device the first call
at a new signature

1. copies the tensor arguments into static buffers of its own (a
   *borrowed* argument's tensors are used where they are, by address);
2. runs the function eagerly on a side stream, as warm-up (libraries
   load, kernel D plans its shape and allocates its workspace, the
   autotuner's memo fills), outside any graph; a step that writes
   borrowed state in place (an optimizer step) names a ``warmup``
   function of the same arguments that leaves that state as it was, so
   the first call steps once;
3. captures the function on the static buffers into a
   ``torch.cuda.CUDAGraph``, in the step's memory pool;
4. replays the graph once.

Every later call at that signature copies its tensors into the static
buffers, replays the graph and returns the static outputs, which the next
replay overwrites: a caller copies out what it keeps. A capture counts
one compile. A capture that fails raises :class:`CaptureError` with the
error of the op that broke it; nothing falls back to eager on the card.

On the CPU the same plumbing runs the function eagerly on the static
buffers, and the first call at a signature counts the compile, as the
reference's ``CompileLog`` counts where it cannot read a jit cache. Both
devices thus report the reference's counts.

Three things pass through the plumbing besides tensors:

* a ``torch.Generator`` argument: the step keeps a generator of its own
  for it (registered with the graph on CUDA), sets its state from the
  caller's before the call and hands its state back after, so a replay
  draws the masks the eager call would draw and advances the caller's
  generator as the eager call would;
* ``donate``: positions of arguments whose new values the function
  returns at the same positions of its output tuple (parameters and
  optimizer state). The captured region ends by copying the new values
  into those arguments' static buffers and returns the buffers, so a
  caller that feeds them back in costs no copy;
* the counters of ``ops.COUNTERS`` (the kernels' launches and the halo
  exchange's calls): Python moves them only while it issues a launch, so
  the capture records their deltas, undoes what warm-up and capture
  added, and every replay adds the deltas again.

:class:`CompileLog` is the reference's serving ``CompileLog``
(``serving/batcher.py``), reading :attr:`CapturedStep.compiles` where the
reference reads a jit cache's size.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Sequence

import torch

from repro_torch import obs
from repro_torch.kernels.ops import COUNTERS

__all__ = ["CapturedStep", "CaptureError", "CompileLog", "new_pool"]


class CaptureError(RuntimeError):
    """A function could not be captured into a CUDA graph."""


def new_pool(device: torch.device):
    """A graph memory pool for steps that share memory (never replayed
    concurrently); None off the card."""
    if torch.device(device).type != "cuda":
        return None
    return torch.cuda.graph_pool_handle()


def _read(counters) -> List[int]:
    return [getattr(m, a) for m, a in counters]


def _write(counters, values) -> None:
    for (m, a), v in zip(counters, values):
        setattr(m, a, v)


# ---------------------------------------------------------------------------
# argument trees
# ---------------------------------------------------------------------------
_TENSOR, _GEN = "tensor", "generator"


def _flatten(tree: Any, leaves: List[Any]) -> Any:
    """The hashable structure of ``tree``; its tensors and generators are
    appended to ``leaves`` (dict values in sorted key order) and stand as
    placeholders in the structure, every other leaf stands as itself."""
    if isinstance(tree, torch.Tensor):
        leaves.append(tree)
        return _TENSOR
    if isinstance(tree, torch.Generator):
        leaves.append(tree)
        return _GEN
    if isinstance(tree, dict):          # sorted, as repro_torch.tree walks
        keys = tuple(sorted(tree))
        return (dict, keys, tuple(_flatten(tree[k], leaves) for k in keys))
    if isinstance(tree, (list, tuple)):
        return (type(tree), None, tuple(_flatten(v, leaves) for v in tree))
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        names = tuple(f.name for f in dataclasses.fields(tree))
        return (type(tree), names, tuple(_flatten(getattr(tree, n), leaves)
                                         for n in names))
    try:
        hash(tree)
    except TypeError:
        raise TypeError(f"a captured step's argument leaf must be a tensor, "
                        f"a generator or hashable, got {type(tree)}") from None
    return ("static", tree, ())


def _unflatten(spec: Any, leaves) -> Any:
    """The tree of ``spec`` with its placeholders taken from ``leaves`` (an
    iterator), in order."""
    if spec is _TENSOR or spec is _GEN:
        return next(leaves)
    kind, names, children = spec
    if kind == "static":
        return names
    values = [_unflatten(c, leaves) for c in children]
    if kind is dict:
        return dict(zip(names, values))
    if kind in (list, tuple):
        return kind(values)
    if names is None:                       # a named tuple
        return kind(*values)
    return kind(**dict(zip(names, values)))


def _meta(leaf: Any) -> tuple:
    if isinstance(leaf, torch.Tensor):
        return (tuple(leaf.shape), leaf.dtype, leaf.device)
    return ("generator", leaf.device)


def _same(x: torch.Tensor, static: torch.Tensor) -> bool:
    return x.data_ptr() == static.data_ptr() and x.stride() == static.stride()


# ---------------------------------------------------------------------------
# the step
# ---------------------------------------------------------------------------
class _Entry:
    """One signature's static buffers, and on CUDA its graph, outputs and
    counter deltas."""

    def __init__(self, spec, statics, kinds):
        self.spec = spec
        self.statics = statics          # per leaf: tensor / own generator
        self.kinds = kinds              # per leaf: "copy", "borrow", "gen"
        self.graph = None
        self.outs = None
        self.deltas = None


class CapturedStep:
    """``fn`` compiled per signature (see the module docstring).

    ``device``: where the step runs; a CUDA device captures graphs, any
    other runs the plumbing eagerly. ``pool``: a graph memory pool to
    share with other steps (:func:`new_pool`; None: the step's own, shared
    by all its signatures). ``donate``: argument positions whose new
    values ``fn`` returns at the same output positions. ``borrow``:
    argument positions whose tensors are bound by address (large inputs
    that stay put, or a cache written in place); on the card a later call
    at the signature must pass the same tensors. ``warmup``: run in place
    of ``fn`` for the warm-up before a capture (default ``fn``). ``name``
    labels errors."""

    def __init__(self, fn: Callable, device, pool=None,
                 donate: Sequence[int] = (), borrow: Sequence[int] = (),
                 name: Optional[str] = None,
                 warmup: Optional[Callable] = None):
        self.fn = fn
        self.warmup = warmup or fn
        self.device = torch.device(device)
        self.cuda = self.device.type == "cuda"
        self.pool = pool
        self.donate = tuple(donate)
        self.borrow = tuple(borrow)
        self.name = name or getattr(fn, "__name__", "step")
        self.compiles = 0
        self._entries: Dict[Any, _Entry] = {}
        self._counters = list(COUNTERS.values())

    def __call__(self, *args, **kwargs):
        leaves: List[Any] = []
        spec = _flatten((args, kwargs), leaves)
        sig = (spec, tuple(_meta(x) for x in leaves))
        entry = self._entries.get(sig)
        if entry is None:
            entry = self._new_entry(spec, args, leaves)
            if self.cuda:
                self._load(entry, leaves)
                self._capture(entry)
            self._entries[sig] = entry
            self.compiles += 1
        self._load(entry, leaves)
        if self.cuda:
            entry.graph.replay()
            _write(self._counters, [v + d for v, d in zip(
                _read(self._counters), entry.deltas)])
            outs = entry.outs
        else:
            outs = self._run(entry)
        for x, own, kind in zip(leaves, entry.statics, entry.kinds):
            if kind == "gen":
                x.set_state(own.get_state())
        return outs

    # -- signatures ---------------------------------------------------------
    def _new_entry(self, spec, args, leaves) -> _Entry:
        borrowed = set()
        for pos in self.borrow:
            sub: List[Any] = []
            _flatten(args[pos], sub)
            borrowed.update(id(x) for x in sub)
        statics, kinds = [], []
        for x in leaves:
            if isinstance(x, torch.Generator):
                statics.append(torch.Generator(device=x.device))
                kinds.append("gen")
            elif id(x) in borrowed:
                statics.append(x)
                kinds.append("borrow")
            else:
                statics.append(x.detach().clone())
                kinds.append("copy")
        return _Entry(spec, statics, kinds)

    def _load(self, entry: _Entry, leaves) -> None:
        """The call's arguments into the entry's static buffers."""
        with torch.no_grad():
            for i, (x, kind) in enumerate(zip(leaves, entry.kinds)):
                static = entry.statics[i]
                if kind == "copy":
                    if not _same(x, static):
                        static.copy_(x)
                elif kind == "gen":
                    static.set_state(x.get_state())
                elif _same(x, static):
                    pass
                elif self.cuda:
                    raise ValueError(
                        f"{self.name}: a borrowed argument was captured at "
                        f"another tensor; pass the tensor the step was "
                        f"first called with")
                else:               # no graph holds the address
                    entry.statics[i] = x

    def _run(self, entry: _Entry):
        """``fn`` on the static buffers, the donated outputs written into
        their arguments' buffers."""
        args, kwargs = _unflatten(entry.spec, iter(entry.statics))
        outs = self.fn(*args, **kwargs)
        if not self.donate:
            return outs
        outs = list(outs)
        with torch.no_grad():
            for pos in self.donate:
                new: List[Any] = []
                _flatten(outs[pos], new)
                old: List[Any] = []
                _flatten(args[pos], old)
                if len(new) != len(old):
                    raise ValueError(f"{self.name}: output {pos} does not "
                                     f"have argument {pos}'s structure")
                for o, n in zip(old, new):
                    if isinstance(o, torch.Tensor):
                        o.copy_(n)
                outs[pos] = args[pos]
        return tuple(outs)

    # -- capture ------------------------------------------------------------
    def _capture(self, entry: _Entry) -> None:
        """Warm up, capture and keep the graph, its outputs and the
        counter deltas of one call; the counters end where they began."""
        counters = self._counters
        before = _read(counters)
        current = torch.cuda.current_stream(self.device)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(current)
        args, kwargs = _unflatten(entry.spec, iter(entry.statics))
        try:
            with torch.cuda.stream(side):
                self.warmup(*args, **kwargs)        # warm-up, eager
            current.wait_stream(side)
            graph = torch.cuda.CUDAGraph()
            for own, kind in zip(entry.statics, entry.kinds):
                if kind == "gen":
                    graph.register_generator_state(own)
            if self.pool is None:
                self.pool = torch.cuda.graph_pool_handle()
            start = _read(counters)
            try:
                with torch.cuda.graph(graph, pool=self.pool, stream=side):
                    outs = self._run(entry)
            except Exception as err:
                first = err
                while first.__context__ is not None:
                    first = first.__context__
                raise CaptureError(
                    f"capturing {self.name} into a CUDA graph failed: "
                    f"{type(first).__name__}: {first}") from err
            entry.deltas = [b - a for a, b in zip(start, _read(counters))]
        finally:
            _write(counters, before)
        entry.graph, entry.outs = graph, outs


# ---------------------------------------------------------------------------
# CompileLog
# ---------------------------------------------------------------------------
class CompileLog:
    """Measured compile counts per captured step, split warmup/steady (the
    reference's ``CompileLog``).

    Reads each step's :attr:`CapturedStep.compiles` around the call,
    falling back to a seen-shape set for a plain function (an eager run
    on the card), as the reference falls back where a jit cache cannot be
    read."""

    def __init__(self):
        self.warm_compiles: Dict[str, int] = {}
        self.steady_compiles: Dict[str, int] = {}
        self._steady = False
        self._shapes: Dict[str, set] = {}

    def mark_steady(self) -> None:
        """End of warmup: every compile from here on is a violation."""
        self._steady = True

    def call(self, name: str, fn: Callable, *args, **kwargs):
        before = getattr(fn, "compiles", None)
        out = fn(*args, **kwargs)
        after = getattr(fn, "compiles", None)
        if before is not None and after is not None:
            compiled = after - before
        else:   # fallback: infer from the argument shapes
            shapes = tuple(getattr(a, "shape", None) for a in args)
            seen = self._shapes.setdefault(name, set())
            compiled = 0 if shapes in seen else 1
            seen.add(shapes)
        if compiled:
            book = (self.steady_compiles if self._steady
                    else self.warm_compiles)
            book[name] = book.get(name, 0) + compiled
            phase = "steady" if self._steady else "warm"
            obs.counter(f"serving.compiles.{phase}").inc(compiled)
        return out

    @property
    def steady_state_recompiles(self) -> int:
        return sum(self.steady_compiles.values())

    def stats(self) -> Dict[str, Any]:
        return {"warm_compiles": dict(self.warm_compiles),
                "steady_compiles": dict(self.steady_compiles),
                "steady_state_recompiles": self.steady_state_recompiles}
