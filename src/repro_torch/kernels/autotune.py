"""Autotuned kernel configs: per-(backend, shape-bucket) strategy and knobs.

The counterpart of the reference's ``repro.kernels.autotune``. The GCN
layers ask :func:`get_config` which strategy, and which knobs of kernels A
and B, a call of a given shape runs:

* **KernelConfig** — a *strategy* plus the kernels' knobs. Strategies:

  - ``"cuda_fused"`` — kernel B: kernel A's gather into the aggregate, then
    B's own f32 product with bias and relu (the reference's
    ``"pallas_fused"``); the fallback on the card;
  - ``"cuda"`` — kernel A's aggregation, then ``torch.matmul`` + bias +
    relu (the reference's ``"pallas"``, whose product XLA computes outside
    any Pallas kernel);
  - ``"torch"`` — the kernels' plain versions (the reference's ``"xla"``):
    the CPU path, and the only candidate there. A CUDA tensor never takes
    it (:mod:`repro_torch.kernels.ops` raises).

  Knobs, in place of the TPU's tiles: ``node_tile``, kernel B's product
  rows per block (32, 64 or 128; ``csrc/fused_layer.cu``), and ``items``,
  kernel A's merged row ends and arcs per warp (16 to 128; 0 is the shape
  rule of :func:`repro_torch.kernels.csr_aggregate.split`).

* **shape buckets** — configs are keyed by ``(backend, bucket)``, where the
  bucket rounds N and E up to powers of two and F up to a multiple of 128
  (the reference's rule and key strings, so a bucket names the same shapes
  in both packages). The backend is ``"cpu"`` or ``"cuda/<device name>"``,
  so an entry tuned on one card is never read on another.

* **disk cache** — tuning is paid once: results land in a JSON cache
  (``REPRO_TORCH_AUTOTUNE_CACHE`` or
  ``~/.cache/repro_torch/autotune_cache.json``, rewritten atomically),
  consulted before the packaged factory table (``autotune_defaults.json``)
  and the per-backend fallback. Entries that cannot be read, or that name
  a strategy or knob this package does not have (the reference's
  ``"xla"``, say), are skipped.

* **the tuner** — :func:`autotune` times one layer's forward + backward
  under every candidate on the device's clock (CUDA events, with the
  launches queued behind a spin kernel so that the host's launch rate,
  which bounds the training loop, does not blur the kernels' times). It
  times the caller's own graphs where it is given them (the pipeline
  gives every partition's CSR), and sweeps ``items``, whose worth depends
  on how the arcs are spread over the rows, only then; the reference's
  uniform probe graph tunes the strategy and row tile alone. A candidate
  replaces the fallback only when its median beats the fallback's by
  more than the spread of either's samples, so an entry never records a
  win that the timer cannot tell from noise.

Resolution order for :func:`get_config`:
``override() > in-memory memo > user cache > factory defaults > fallback``.
After the first call for a shape a resolution is one dictionary lookup: no
file read, no device synchronisation, no tensor read on the host. A change
of ``REPRO_TORCH_AUTOTUNE_CACHE`` is read at the next
:func:`clear_memory_cache`.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import statistics
import time
from typing import Dict, Iterable, List, Optional, Tuple, Union

import numpy as np
import torch

from repro_torch import obs

from .csr_aggregate import ITEMS
from .fused_layer import NODE_TILES, block_threads, smem_bytes

__all__ = [
    "KernelConfig", "ShapeBucket", "shape_bucket", "get_config", "autotune",
    "override", "candidate_space", "smem_bytes", "block_threads",
    "cache_path", "clear_memory_cache", "backend_key", "fallback_config",
    "FALLBACK", "STRATEGIES", "NODE_TILES", "ITEMS",
]

STRATEGIES = ("cuda_fused", "cuda", "torch")


@dataclasses.dataclass(frozen=True)
class KernelConfig:
    """One point in the kernel search space (hashable). ``node_tile`` is
    read by ``cuda_fused`` only and ``items`` by both CUDA strategies; the
    ``torch`` strategy keeps them for bookkeeping."""
    strategy: str = "cuda_fused"
    node_tile: int = 64
    items: int = 0

    def __post_init__(self):
        if self.strategy not in STRATEGIES:
            raise ValueError(f"strategy must be one of {STRATEGIES}, "
                             f"got {self.strategy!r}")
        if self.node_tile not in NODE_TILES:
            raise ValueError(f"node_tile must be one of {NODE_TILES}, "
                             f"got {self.node_tile!r}")
        if self.items != 0 and self.items not in ITEMS:
            raise ValueError(f"items must be 0 or one of {ITEMS}, "
                             f"got {self.items!r}")

    def as_dict(self) -> Dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: Dict) -> "KernelConfig":
        return cls(**{f.name: d[f.name] for f in dataclasses.fields(cls)
                      if f.name in d})


#: The untuned config on the card: today's launches exactly.
FALLBACK = KernelConfig("cuda_fused", node_tile=64, items=0)
_CPU_FALLBACK = KernelConfig("torch")


@dataclasses.dataclass(frozen=True)
class ShapeBucket:
    """Power-of-two shape bucket a concrete (n, e, f) pads into."""
    n: int
    e: int
    f: int

    @property
    def key(self) -> str:
        return f"n{self.n}_e{self.e}_f{self.f}"


def _pow2_ceil(x: int) -> int:
    x = max(int(x), 1)
    return 1 << (x - 1).bit_length()


def shape_bucket(n: int, e: int, f: int) -> ShapeBucket:
    """Bucket: N and E to the next power of two (min 8 nodes / 128 edges),
    F to the next multiple of 128."""
    return ShapeBucket(n=max(_pow2_ceil(n), 8),
                       e=max(_pow2_ceil(e), 128),
                       f=((max(int(f), 1) + 127) // 128) * 128)


# ---------------------------------------------------------------------------
# Backend key
# ---------------------------------------------------------------------------
_backend_of: Dict[torch.device, str] = {}

BackendLike = Union[str, torch.device, None]


def backend_key(device: BackendLike = None) -> str:
    """``"cpu"`` or ``"cuda/<device name>"`` for ``device`` (a string key is
    returned as it is; None means the current CUDA device, or the CPU
    where there is none). Memoized per device: the name is read once."""
    if isinstance(device, str) and (device == "cpu"
                                    or device.startswith("cuda/")):
        return device
    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    dev = torch.device(device)
    key = _backend_of.get(dev)
    if key is None:
        if dev.type == "cuda":
            index = torch.cuda.current_device() if dev.index is None \
                else dev.index
            key = f"cuda/{torch.cuda.get_device_name(index)}"
        else:
            key = dev.type
        _backend_of[dev] = key
    return key


def fallback_config(backend: BackendLike = None) -> KernelConfig:
    """Untuned default: kernel B at today's tile and split on the card, the
    plain versions elsewhere."""
    if backend_key(backend).startswith("cuda/"):
        return FALLBACK
    return _CPU_FALLBACK


# ---------------------------------------------------------------------------
# Cache: user file + packaged factory defaults + in-memory memo
# ---------------------------------------------------------------------------
_DEFAULTS_PATH = os.path.join(os.path.dirname(__file__),
                              "autotune_defaults.json")
_memo: Dict[Tuple[str, str], KernelConfig] = {}
_user_cache_loaded: Optional[str] = None   # path the memo was seeded from
# get_config's answers by its own arguments: (backend, n, e, f) -> config
_resolved: Dict[tuple, KernelConfig] = {}
_override_stack: List[KernelConfig] = []


def cache_path() -> str:
    return os.environ.get(
        "REPRO_TORCH_AUTOTUNE_CACHE",
        os.path.join(os.path.expanduser("~"), ".cache", "repro_torch",
                     "autotune_cache.json"))


def clear_memory_cache() -> None:
    """Drop the in-process memo (tests; forces a re-read of the files and
    of ``REPRO_TORCH_AUTOTUNE_CACHE``)."""
    global _user_cache_loaded
    _memo.clear()
    _resolved.clear()
    _user_cache_loaded = None


@contextlib.contextmanager
def override(config: KernelConfig):
    """Force every resolution to ``config`` inside the context (tests, and
    forced-strategy measurements)."""
    _override_stack.append(config)
    try:
        yield config
    finally:
        _override_stack.pop()


def _read_json(path: str) -> Dict:
    try:
        with open(path) as f:
            data = json.load(f)
    except (OSError, ValueError):
        return {}
    return data if isinstance(data, dict) else {}


def _configs_from_file(path: str) -> Dict[Tuple[str, str], KernelConfig]:
    out = {}
    configs = _read_json(path).get("configs", {})
    if not isinstance(configs, dict):
        return out
    for backend, buckets in configs.items():
        if not isinstance(buckets, dict):
            continue
        for key, entry in buckets.items():
            try:
                out[(backend, key)] = KernelConfig.from_dict(entry["config"])
            except (KeyError, TypeError, ValueError):
                continue
    return out


def _seed_memo() -> None:
    """Load factory defaults then the user cache (user wins) into the memo,
    once per cache path."""
    global _user_cache_loaded
    path = cache_path()
    if _user_cache_loaded == path:
        return
    fresh = {}
    fresh.update(_configs_from_file(_DEFAULTS_PATH))
    fresh.update(_configs_from_file(path))
    _memo.clear()
    _memo.update(fresh)
    _resolved.clear()
    _user_cache_loaded = path


def _persist(backend: str, bucket: ShapeBucket, config: KernelConfig,
             measurements: Dict[str, float], spreads: Dict[str, float],
             probe: str) -> None:
    path = cache_path()
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    data = _read_json(path)
    data.setdefault("version", 1)
    if not isinstance(data.get("configs"), dict):
        data["configs"] = {}
    if not isinstance(data["configs"].get(backend), dict):
        data["configs"][backend] = {}
    data["configs"][backend][bucket.key] = {
        "config": config.as_dict(),
        "source": "tuned",
        "measured_ms": {k: round(v, 4) for k, v in measurements.items()},
        "spread_ms": {k: round(v, 4) for k, v in spreads.items()},
        "probe": probe,
        "tuned_at": time.strftime("%Y-%m-%dT%H:%M:%S"),
    }
    tmp = f"{path}.{os.getpid()}.tmp"
    with open(tmp, "w") as f:
        json.dump(data, f, indent=2, sort_keys=True)
    os.replace(tmp, path)


def get_config(n: int, e: int, f: int,
               backend: BackendLike = None) -> KernelConfig:
    """Resolve the kernel config for a concrete shape on ``backend`` (a key
    of :func:`backend_key`, or the device the call runs on). Memoized by
    the arguments: a repeated call is the override check and one lookup."""
    if _override_stack:
        return _override_stack[-1]
    hit = _resolved.get((backend, n, e, f))
    if hit is None:
        hit = _resolve(n, e, f, backend)
    return hit


def _resolve(n: int, e: int, f: int, backend: BackendLike) -> KernelConfig:
    key = backend_key(backend)
    _seed_memo()
    config = _memo.get((key, shape_bucket(n, e, f).key)) \
        or fallback_config(key)
    _resolved[(backend, n, e, f)] = config
    return config


# ---------------------------------------------------------------------------
# The tuner
# ---------------------------------------------------------------------------
#: A probe graph: a CSR at the bucket's shape and its rows' in-degrees.
Graph = Tuple["ops.Csr", torch.Tensor]


def candidate_space(bucket: ShapeBucket, backend: BackendLike = None,
                    smem_limit: Optional[int] = None,
                    sweep_items: bool = True) -> List[KernelConfig]:
    """Deterministically ordered candidates for one (backend, bucket).

    The card: ``cuda_fused`` over node tiles x items, then ``cuda`` over
    items (its product is cuBLAS's, so ``node_tile`` stays 64), never
    ``torch``. A node tile whose shared memory exceeds ``smem_limit`` (the
    device's opt-in limit when None) or whose block exceeds 1,024 threads
    is dropped, and so is an ``items`` above ``n + e``; without
    ``sweep_items`` (a probe graph that is not the caller's own) items
    stays 0. The fallback is the first candidate. Elsewhere: ``torch``,
    plus the two CUDA strategies (their plain compositions) when
    ``REPRO_TORCH_AUTOTUNE_EXHAUSTIVE=1``.
    """
    backend = backend_key(backend)
    if not backend.startswith("cuda/"):
        cands = [_CPU_FALLBACK]
        if os.environ.get("REPRO_TORCH_AUTOTUNE_EXHAUSTIVE") == "1":
            cands += [FALLBACK, KernelConfig("cuda")]
        return cands
    if smem_limit is None:
        props = torch.cuda.get_device_properties(torch.cuda.current_device())
        smem_limit = props.shared_memory_per_block_optin
    items = [0]
    if sweep_items:
        items += [k for k in ITEMS if k <= bucket.n + bucket.e]
    tiles = [nt for nt in NODE_TILES
             if smem_bytes(nt) <= smem_limit and block_threads(nt) <= 1024]
    # the fallback's tile first, so that ties go to today's launches
    tiles.sort(key=lambda nt: nt != FALLBACK.node_tile)
    cands = [KernelConfig("cuda_fused", node_tile=nt, items=k)
             for nt in tiles for k in items]
    cands += [KernelConfig("cuda", items=k) for k in items]
    return cands


def _device_of(backend: str) -> torch.device:
    return torch.device("cuda") if backend.startswith("cuda/") \
        else torch.device("cpu")


def _probe(bucket: ShapeBucket, f: int, device: torch.device,
           graphs: Optional[Iterable[Graph]] = None):
    """``(h, w, b, [(csr, inv), ...])``: seeded features and a [F, F]
    layer shared by the probe graphs. The graphs are the caller's (at
    their rows and width ``f``, each inside ``bucket``) or, with none, the
    reference's: seeded uniform arcs with sorted destinations at the
    bucket shape."""
    from . import ops
    rng = np.random.default_rng(0)
    if graphs is None:
        n, e, f = bucket.n, bucket.e, bucket.f
        src = torch.as_tensor(rng.integers(0, n, e), dtype=torch.int32)
        dst = torch.as_tensor(np.sort(rng.integers(0, n, e)),
                              dtype=torch.int32)
        w_edge = torch.as_tensor(rng.random(e), dtype=torch.float32)
        deg = torch.as_tensor(np.bincount(dst.numpy(), minlength=n)[:n],
                              dtype=torch.float32)
        graphs = [(ops.to_csr(src.to(device), dst.to(device),
                              w_edge.to(device), n), deg.to(device))]
    pairs = []
    for csr, deg in graphs:
        got = shape_bucket(csr.num_nodes, csr.src.shape[0], f)
        if got != bucket:
            raise ValueError(f"probe graph of bucket {got.key} tuning "
                             f"{bucket.key}")
        pairs.append((csr, ops.inv_degree(deg)))
    n = pairs[0][0].num_nodes
    if any(csr.num_nodes != n for csr, _ in pairs):
        raise ValueError("probe graphs must have one row count")
    h = torch.as_tensor(rng.normal(size=(n, f)), dtype=torch.float32)
    w = torch.as_tensor(rng.normal(size=(f, f)) * 0.1, dtype=torch.float32)
    return h.to(device), w.to(device), torch.zeros(f, device=device), pairs


_cycles_per_ms: Dict[torch.device, float] = {}


def _spin_rate(device: torch.device) -> float:
    """Clock cycles a millisecond of ``torch.cuda._sleep``'s spin."""
    rate = _cycles_per_ms.get(device)
    if rate is None:
        start, end = (torch.cuda.Event(enable_timing=True) for _ in "se")
        torch.cuda._sleep(1_000_000)        # bring the clock up
        start.record()
        torch.cuda._sleep(10_000_000)
        end.record()
        end.synchronize()
        rate = _cycles_per_ms[device] = 10_000_000 / start.elapsed_time(end)
    return rate


def _device_times(step, repeats: int, device: torch.device) -> List[float]:
    """CUDA-event ms of ``step``, launched ahead: a spin kernel holds the
    stream while the host queues the step, so the events time the kernels
    back to back and not the host's launch rate. The hold starts at twice
    the host's queueing time and doubles (three times at most) whenever
    the stream reached the start before the host had queued the end."""
    rate = _spin_rate(device)
    t0 = time.perf_counter()
    step()
    hold_ms = 2e3 * (time.perf_counter() - t0) + 1.0
    _sync(device)
    start, end = (torch.cuda.Event(enable_timing=True) for _ in "se")
    samples = []
    for _ in range(max(repeats, 1)):
        for _attempt in range(4):
            torch.cuda._sleep(int(rate * hold_ms))
            start.record()
            step()
            end.record()
            ahead = not start.query()
            end.synchronize()
            if ahead:
                break
            hold_ms *= 2
        samples.append(start.elapsed_time(end))
    return samples


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _measure(cfg: KernelConfig, probe, repeats: int = 3,
             device: Optional[torch.device] = None) -> List[float]:
    """``repeats`` ms samples of one layer's forward + backward over every
    probe graph: the gradient of ``sum(out²)`` in (h, W, b) through
    :func:`repro_torch.kernels.ops.fused_gcn_layer` under ``cfg``, as the
    reference's probe. The first call is excluded. On the card the device
    clock (:func:`_device_times`), elsewhere the host clock, each sample
    ending in a synchronize."""
    from . import ops
    device = device or torch.device("cpu")
    h, w, b, pairs = probe
    h, w, b = (t.detach().requires_grad_() for t in (h, w, b))

    def step():
        loss = 0.0
        for csr, inv in pairs:
            out = ops.fused_gcn_layer(h, csr, inv, w, b, activate=True,
                                      config=cfg)
            loss = loss + (out * out).sum()
        loss.backward()
        h.grad = w.grad = b.grad = None

    step()
    _sync(device)
    if device.type == "cuda":
        return _device_times(step, repeats, device)
    walls = []
    for _ in range(max(repeats, 1)):
        t0 = time.perf_counter()
        step()
        _sync(device)
        walls.append((time.perf_counter() - t0) * 1e3)
    return walls


def autotune(n: int, e: int, f: int, backend: BackendLike = None,
             force: bool = False, repeats: int = 3,
             graphs: Optional[Iterable[Graph]] = None
             ) -> Tuple[KernelConfig, Dict[str, float]]:
    """Tune the (backend, bucket) of a concrete shape and cache the winner.

    Returns ``(config, median_ms_per_candidate)``; a cache hit returns the
    cached config with an empty table unless ``force``. ``graphs`` are the
    caller's own ``(csr, in_degree)`` at the shape (read only when there
    is more than one candidate); without them the reference's uniform
    probe tunes strategy and row tile, not ``items``. Candidates are
    measured in their fixed order. The fallback (the first) stays unless
    a candidate's median is below the fallback's by more than the larger
    spread (max - min) of the two's samples; among those the strict
    argmin wins, the first on ties. The disk cache makes every later
    process see the same choice without measuring again."""
    backend = backend_key(backend)
    bucket = shape_bucket(n, e, f)
    if not force:
        _seed_memo()
        hit = _memo.get((backend, bucket.key))
        if hit is not None:
            obs.counter("autotune.cache_hits").inc()
            return hit, {}
    own = graphs is not None
    cands = candidate_space(bucket, backend, sweep_items=own)
    measurements: Dict[str, float] = {}
    spreads: Dict[str, float] = {}
    with obs.span("autotune.bucket", bucket=bucket.key, backend=backend,
                  candidates=len(cands)) as bsp:
        best = cands[0]
        if len(cands) > 1:
            device = _device_of(backend)
            probe = _probe(bucket, f, device, graphs)
            for cfg in cands:
                with obs.span("autotune.candidate",
                              candidate=cand_key(cfg)) as csp:
                    samples = _measure(cfg, probe, repeats, device)
                    ms = statistics.median_low(samples)
                    csp.set(measured_ms=round(ms, 4))
                obs.counter("autotune.candidates_measured").inc()
                key = cand_key(cfg)
                measurements[key] = ms
                spreads[key] = max(samples) - min(samples)
                base = cand_key(cands[0])
                margin = max(spreads[base], spreads[key])
                if ms < measurements[base] - margin \
                        and ms < measurements[cand_key(best)]:
                    best = cfg
            del probe
        bsp.set(winner=cand_key(best))
    _persist(backend, bucket, best, measurements, spreads,
             "own graphs" if own else "uniform")
    _memo[(backend, bucket.key)] = best
    _resolved.clear()
    return best, measurements


def cand_key(cfg: KernelConfig) -> str:
    return f"{cfg.strategy}/nt{cfg.node_tile}/it{cfg.items}"
