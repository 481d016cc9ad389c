"""The paper's training with one process per partition: the three modes
under a ``torch.distributed`` mesh (:mod:`repro_torch.launch.mesh`), the
reference's ``train_*(mesh=...)``.

* **local**: with a mesh whose ``data`` axis has D ranks, rank r holds
  partitions ``[r·k/D, (r+1)·k/D)`` stacked and runs local mode's step on
  them (a captured CUDA graph on the card). Its steps issue no
  collective; the pooled table needs every rank's embeddings, gathered
  once after training, as the reference's global array is.
* **sync / stale**: ``data`` must equal k: rank r holds partition r.
  :class:`HaloAllGather` keeps the reference's exchange layout, so that
  what it moves is what the reference's HLO counts: each rank fills its
  padded send buffer ``[k, H_pad, F]`` from ``send_rows`` and
  all-gathers it into ``[k, k, H_pad, F]``, and writes column r into its
  ``recv_rows``; the backward is the all-gather's transpose, a
  reduce-scatter of the ``[k, k, H_pad, F]`` gradient that leaves ``[1,
  k, H_pad, F]`` on each rank, summed into the rows that were sent by
  kernel A over the rank's CSR (:func:`repro_torch.kernels.exchange.
  rank_backward_sum`), in a fixed order: no atomics, so training on the
  card repeats bit for bit. The steps run eagerly: a collective cannot
  sit in a CUDA graph, and asking to capture one raises
  :class:`~repro_torch.graphs.CaptureError`.

With ``gloo`` and ranks sharing a card, the exchange stages its buffers
through pinned host memory, explicitly, and times those copies apart from
the collectives (:func:`repro_torch.launch.collectives.add_staging`);
with ``nccl`` the buffers stay on the card, and on the CPU there is
nothing to stage.

Every rank draws the parameters and dropout generators the in-process
run gives its partitions (the full k's, sliced), so a distributed run
computes what the stacked run computes. Every collective is counted
(:mod:`repro_torch.launch.collectives`) under "training steps",
"embedding gather" or "integration"; the trainers return each epoch's
count of the first.
"""
from __future__ import annotations

import logging
import time
import types
from typing import Any, Callable, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.graphs import CaptureError
from repro_torch.kernels import exchange as _exchange
from repro_torch.launch import collectives
from repro_torch.launch.mesh import data_group, data_rank, data_size
from repro_torch.tree import tree_leaves, tree_map

from .infer import Params, pool_embeddings

log = logging.getLogger("repro_torch.gnn.distributed")

__all__ = ["Shard", "shard", "local_mesh", "check_halo_mesh",
           "refuse_capture", "HaloAllGather", "slice_params", "gather_params",
           "integrate", "pooled_table", "StepCounter", "collective_report"]


class Shard(NamedTuple):
    """This rank's place on the mesh's ``data`` axis and its partitions."""
    group: Any          # the data axis's process group
    rank: int           # coordinate on the data axis
    size: int           # D, ranks on the data axis
    lo: int             # partitions [lo, hi) are this rank's
    hi: int
    k: int
    stage: bool         # stage collectives through pinned host memory

    @property
    def count(self) -> int:
        return self.hi - self.lo


def shard(mesh, k: int, device: torch.device) -> Shard:
    """The shard of ``k`` partitions over ``mesh``'s ``data`` axis; raises
    ``ValueError`` unless D divides k."""
    size, rank = data_size(mesh), data_rank(mesh)
    if k % size:
        raise ValueError(f"k={k} partitions do not divide over the mesh's "
                         f"data axis of {size}")
    group = data_group(mesh)
    stage = device.type == "cuda" and dist.get_backend(group) == "gloo"
    per = k // size
    return Shard(group, rank, size, rank * per, (rank + 1) * per, k, stage)


def local_mesh(mesh, k: int):
    """``mesh`` where its ``data`` axis divides ``k``; else None, with the
    reference's warning (local training then runs unsharded)."""
    if mesh is not None and k % data_size(mesh):
        log.warning("k=%d not divisible by mesh data axis %d — running "
                    "unsharded", k, data_size(mesh))
        return None
    return mesh


def check_halo_mesh(mesh, k: int) -> None:
    """Sync and stale need one partition per rank (the reference's
    ``train_sync`` check)."""
    size = data_size(mesh)
    if size != k:
        raise ValueError(
            f"sync and stale training need one partition per rank: the "
            f"mesh's data axis has {size} ranks but k={k}; launch with "
            f"torch.distributed.run --nproc-per-node {k}")


def refuse_capture(mode: str) -> None:
    raise CaptureError(
        f"{mode} steps under a mesh hold collectives, which a CUDA graph "
        f"cannot hold; pass capture=False to run them eagerly")


# ---------------------------------------------------------------------------
# the exchange
# ---------------------------------------------------------------------------
class _HaloFn(torch.autograd.Function):
    """The exchange with the reduce-scatter and kernel A as its backward."""

    @staticmethod
    def forward(ctx, h, ex):
        ctx.ex = ex
        return ex.forward(h)

    @staticmethod
    def backward(ctx, g):
        return ctx.ex.backward(g), None


class HaloAllGather:
    """Rank ``sh.rank``'s halo exchange (the module docstring): the
    counterpart of :class:`~repro_torch.kernels.exchange.ExchangePlan`,
    with the same ``exchange``/``refresh`` methods over this rank's
    ``[1, N_pad, F]`` rows."""

    def __init__(self, halo, sh: Shard, n_pad: int, device: torch.device):
        self.pl = _exchange.rank_plan(halo, sh.rank, n_pad, device)
        self.sh = sh
        self.device = device
        self._host: Dict[int, Tuple[torch.Tensor, ...]] = {}

    def exchange(self, h: torch.Tensor) -> torch.Tensor:
        _exchange.calls += 1
        if torch.is_grad_enabled() and h.requires_grad:
            return _HaloFn.apply(h, self)
        return self.forward(h)

    def refresh(self, h: torch.Tensor, cache: torch.Tensor) -> torch.Tensor:
        """The halo rows from ``cache``, the rest from ``h``: no
        collective and no gradient into ``cache``."""
        return torch.where(self.pl.received, cache, h)

    def _buffers(self, f: int) -> Tuple[torch.Tensor, ...]:
        """Pinned host buffers of width ``f``: send ``[k·H, F]``, gathered
        ``[k·k·H, F]``, the reduce-scatter's input ``[k·k·H, F]`` and its
        output ``[k·H, F]``; allocated once a width."""
        bufs = self._host.get(f)
        if bufs is None:
            kh = self.pl.k * self.pl.h_pad
            bufs = tuple(torch.empty((n, f), dtype=torch.float32,
                                     pin_memory=True)
                         for n in (kh, self.pl.k * kh, self.pl.k * kh, kh))
            self._host[f] = bufs
        return bufs

    def _column(self, x: torch.Tensor) -> torch.Tensor:
        """Column ``rank`` of a ``[k·k·H, F]`` buffer: ``[k, H, F]``."""
        pl = self.pl
        return x.view(pl.k, pl.k, pl.h_pad, -1)[:, pl.rank]

    def forward(self, h: torch.Tensor) -> torch.Tensor:
        pl, sh = self.pl, self.sh
        x = h.reshape(pl.n_pad, -1)
        f, kh = x.shape[1], pl.k * pl.h_pad
        buf = x.index_select(0, pl.send_idx) * pl.send_mask     # [k·H, F]
        if sh.stage:
            send, gathered, _, _ = self._buffers(f)
            t0 = time.perf_counter()
            send.copy_(buf)
            collectives.add_staging(time.perf_counter() - t0)
            collectives.all_gather_into_tensor(gathered, send, sh.group)
            t0 = time.perf_counter()
            incoming = self._column(gathered).to(self.device)
            collectives.add_staging(time.perf_counter() - t0)
        else:
            gathered = torch.empty((pl.k * kh, f), dtype=buf.dtype,
                                   device=buf.device)
            collectives.all_gather_into_tensor(gathered, buf, sh.group)
            incoming = self._column(gathered)
        incoming = incoming.reshape(kh, f)
        out = x.clone()
        out.index_copy_(0, pl.recv_row, incoming.index_select(0, pl.recv_slot))
        return out.reshape(h.shape)

    def backward(self, g: torch.Tensor) -> torch.Tensor:
        pl, sh = self.pl, self.sh
        x = g.reshape(pl.n_pad, -1).float()
        f, kh = x.shape[1], pl.k * pl.h_pad
        # what my received rows' gradients owe each sender, at its slot
        col = torch.zeros((kh, f), dtype=torch.float32, device=x.device)
        col.index_copy_(0, pl.recv_slot, x.index_select(0, pl.recv_row))
        rows = torch.empty((pl.n_pad + kh, f), dtype=torch.float32,
                           device=x.device)
        rows[:pl.n_pad] = x
        if sh.stage:
            _, _, big, fed = self._buffers(f)
            t0 = time.perf_counter()
            big.zero_()
            self._column(big).copy_(col.view(pl.k, pl.h_pad, f))
            collectives.add_staging(time.perf_counter() - t0)
            collectives.reduce_scatter_tensor(fed, big, sh.group)
            t0 = time.perf_counter()
            rows[pl.n_pad:] = fed
            collectives.add_staging(time.perf_counter() - t0)
        else:
            big = torch.zeros((pl.k * kh, f), dtype=torch.float32,
                              device=x.device)
            self._column(big).copy_(col.view(pl.k, pl.h_pad, f))
            collectives.reduce_scatter_tensor(rows[pl.n_pad:], big, sh.group)
        return _exchange.rank_backward_sum(rows, pl).reshape(g.shape) \
            .to(g.dtype)


# ---------------------------------------------------------------------------
# parameters, integration and the pooled table
# ---------------------------------------------------------------------------
def slice_params(params: Params, sh: Shard) -> Params:
    """This rank's partitions of stacked ``[k, ...]`` parameters."""
    return tree_map(lambda x: x[sh.lo:sh.hi].contiguous(), params)


def _gather_rows(x: torch.Tensor, sh: Shard) -> torch.Tensor:
    """Every rank's ``x`` (``[count, ...]``) stacked in rank order: ``[k,
    ...]`` on ``x``'s device, by one counted all-gather."""
    flat = x.reshape(x.shape[0], -1).contiguous()
    if sh.stage:
        t0 = time.perf_counter()
        flat = flat.cpu()
        collectives.add_staging(time.perf_counter() - t0)
    out = torch.empty((sh.size * flat.shape[0], flat.shape[1]),
                      dtype=flat.dtype, device=flat.device)
    collectives.all_gather_into_tensor(out, flat, sh.group)
    if sh.stage:
        t0 = time.perf_counter()
        out = out.to(x.device)
        collectives.add_staging(time.perf_counter() - t0)
    return out.reshape((sh.k,) + tuple(x.shape[1:]))


def _flat(params: Params) -> Tuple[torch.Tensor, List[torch.Tensor]]:
    leaves = tree_leaves(params)
    return torch.cat([x.reshape(x.shape[0], -1) for x in leaves], 1), leaves


def _unflat(flat: torch.Tensor, leaves: List[torch.Tensor],
            like: Params) -> Params:
    sizes = [x[0].numel() for x in leaves]
    parts = iter(torch.split(flat, sizes, dim=1))
    return tree_map(lambda x: next(parts).reshape((flat.shape[0],)
                                                  + tuple(x.shape[1:]))
                    .contiguous(), like)


def gather_params(params: Params, sh: Shard) -> Params:
    """The k stacked models from every rank's, by one counted
    all-gather."""
    flat, leaves = _flat(params)
    return _unflat(_gather_rows(flat, sh), leaves, params)


def integrate(params: Params, how: Optional[str],
              emb_fn: Callable[[Params], torch.Tensor], sh: Shard
              ) -> Tuple[Params, torch.Tensor]:
    """:func:`repro_torch.gnn.train.apply_integration` across ranks, under
    the "integration" phase: returns the k stacked models (integrated) and
    this rank's embeddings ``[count, N_pad, E]``.

    ``"none"`` gathers the k models (one all-gather); ``"model_avg"``
    averages them with one all-reduce of every rank's sum; ``"ensemble"``
    gathers them and embeds this rank's subgraphs with each."""
    with collectives.phase("integration"):
        if how in (None, "none"):
            return gather_params(params, sh), emb_fn(params)
        if how == "model_avg":
            flat, leaves = _flat(params)
            total = flat.float().sum(0, keepdim=True)
            if sh.stage:
                total = total.cpu()
            collectives.all_reduce(total, sh.group)
            mean = (total / float(sh.k)).to(flat.device)
            full = _unflat(mean.expand(sh.k, -1), leaves, params)
            mine = _unflat(mean.expand(sh.count, -1), leaves, params)
            return full, emb_fn(mine)
        if how == "ensemble":
            full = gather_params(params, sh)
            acc = None
            for m in range(sh.k):
                pm = tree_map(lambda x: x[m:m + 1].expand(
                    (sh.count,) + tuple(x.shape[1:])), full)
                emb = emb_fn(pm)
                acc = emb if acc is None else acc + emb
            return full, acc / float(sh.k)
    raise ValueError(f"integrate must be none|model_avg|ensemble, got "
                     f"{how!r}")


def pooled_table(emb: torch.Tensor, batch, n: int, sh: Shard
                 ) -> torch.Tensor:
    """The ``[n, E]`` table from every rank's ``[count, N_pad, E]``
    embeddings, by one counted all-gather ("embedding gather")."""
    with collectives.phase("embedding gather"):
        full = _gather_rows(emb, sh)
    owned = types.SimpleNamespace(
        owned_mask=torch.as_tensor(batch.owned_mask, device=emb.device),
        node_ids=torch.as_tensor(batch.node_ids.astype(np.int64),
                                 device=emb.device))
    return pool_embeddings(full, owned, n)


# ---------------------------------------------------------------------------
# counting
# ---------------------------------------------------------------------------
class StepCounter:
    """Each epoch's counted "training steps" bytes (:meth:`step` around a
    step) and the run's phase totals (:meth:`summary`)."""

    def __init__(self, sh: Shard):
        self.sh = sh
        self.steps: List[Dict[str, int]] = []
        self._phases0 = {p: collectives.counted(p)
                         for p in collectives.PHASES}
        self._seconds0 = {p: collectives.seconds(p)
                          for p in collectives.PHASES}

    def step(self, fn: Callable[[], Any]) -> Any:
        before = collectives.counted("training steps")
        with collectives.phase("training steps"):
            out = fn()
        self.steps.append(collectives.delta(
            collectives.counted("training steps"), before))
        return out

    def summary(self) -> Dict[str, Any]:
        return {"rank": self.sh.rank, "size": self.sh.size,
                "partitions": [self.sh.lo, self.sh.hi],
                "steps": self.steps,
                "phases": {p: collectives.delta(collectives.counted(p),
                                                self._phases0[p])
                           for p in collectives.PHASES},
                "seconds": {p: {key: collectives.seconds(p)[key]
                                - self._seconds0[p][key]
                                for key in self._seconds0[p]}
                            for p in collectives.PHASES}}


def collective_report(counted: Dict[str, Any], expected: Dict[str, int],
                      mode: str, schedule) -> Dict[str, int]:
    """The pipeline report's ``collectives`` from a rank's counted steps,
    in :func:`~repro_torch.gnn.halo.exchange_collective_bytes`'s keys; a
    step whose count is not the schedule's (the exchange step's bytes on
    exchange epochs, 0 otherwise) raises ``RuntimeError``."""
    steps = counted["steps"]
    on = set(schedule)
    zero = {key: 0 for key in steps[0]} if steps else {}
    live = {key: expected.get(key, 0) for key in zero}
    for e, got in enumerate(steps):
        want = live if e in on else zero
        if got != want:
            raise RuntimeError(
                f"rank {counted['rank']}: the counted collectives of epoch "
                f"{e} ({mode}) are {got}, the schedule's {want}")
    out = dict(live if on else zero) if steps else dict(expected)
    out["per_epoch_avg"] = int(round(sum(s["total"] for s in steps)
                                     / max(len(steps), 1)))
    if mode == "stale":
        out["stale_step_total"] = max([s["total"] for e, s in
                                       enumerate(steps) if e not in on],
                                      default=0)
        out["n_exchange_epochs"] = len(on)
    if out != expected:
        raise RuntimeError(f"rank {counted['rank']}: counted collectives "
                           f"{out} differ from the schedule's {expected}")
    return out
