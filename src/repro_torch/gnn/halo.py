"""Sync and stale training: the halo-exchange baseline the paper argues
against, and its periodic middle ground.

* **sync** (the DGL-style baseline): before every layer of every step,
  every partition's halo rows are refreshed from their owners' current
  rows. The reference runs one partition per device and exchanges with an
  ``all_gather``; its bytes are the paper's "continuous communication".
* **stale(N)**: the exchange runs on every N-th epoch only; in between,
  the halo rows are read from the activations cached at the last exchange.
  ``sync_period=1`` is sync, ``0`` (or None) never exchanges and is local
  training.

The port holds the k partitions stacked on one device, so the exchange is
an index copy (:mod:`repro_torch.kernels.exchange`) and its gradient, the
reference's reduce-scatter, runs kernel A. The forward goes layer by layer
over all k partitions (refresh, each partition's layer, the ``node_mask``
multiply, then dropout on non-final layers from the partition's own
generator, as local mode draws it), and one backward of ``Σ_p L_p`` runs
through the stacked tensors: the gradient of ``L_q`` reaches partition
``p``'s parameters through the rows ``p`` sent ``q``. The update is the
stacked AdamW, clipped and counted per partition.

Under a ``torch.distributed`` mesh (``mesh=``) each rank holds one
partition and the exchange is a counted all-gather, its gradient a
reduce-scatter (:mod:`repro_torch.gnn.distributed`); the steps are the
same functions, over the rank's one partition.

The step before a stale run's first exchange is local mode's own
(:func:`~repro_torch.gnn.train.stacked_train_step`), so stale(0) is local
training bit for bit. Both trainers return what ``train_local`` returns,
with the exchanges of every epoch. :func:`exchange_collective_bytes` gives
the reference's collective-byte report of the step from the schedule.

As in local mode, each step is a :class:`repro_torch.graphs.CapturedStep`
(one CUDA graph on the card; ``capture=False`` runs them eagerly): sync's
one step, and stale's three ("exchange", "stale", "frozen", the
reference's three jits), which share one memory pool and are each
captured at their first call. The partition tensors are bound by
address, and so is the "stale" step's ``caches`` input, which is the
"exchange" graph's own static output: an exchange epoch's replay
refreshes what the stale epochs after it read, with no copy. The
exchange's ``calls`` move on every replay, so ``exchanges[e]`` counts
each epoch's exchanges as the eager loop does.
"""
from __future__ import annotations

import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import obs
from repro_torch.core import HaloExchangeSpec, NodeDataset, PartitionBatch
from repro_torch.device import DeviceLike, resolve_device, synchronize
from repro_torch.graphs import CapturedStep, new_pool
from repro_torch.kernels import exchange as _exchange
from repro_torch.launch import collectives
from repro_torch.optim import OptState, adamw_init, adamw_update
from repro_torch.tree import tree_leaves, tree_map

from .infer import (Params, PartitionTensors, compute_embeddings,
                    gather_partition_tensors, init_partition_models,
                    partition_params, pool_embeddings)
from .layers import gcn_layer, sage_layer
from .model import (GNNConfig, dropout, head_logits, sigmoid_bce,
                    softmax_xent)
from .train import (LocalTraining, apply_integration, dropout_generators,
                    finish_epoch_span, stacked_train_step)

__all__ = ["REFRESH_MODES", "make_halo_forward", "make_sync_forward",
           "make_sync_train_step", "train_sync", "stale_exchange_epochs",
           "stale_bytes_per_epoch", "make_stale_train_steps", "capture_steps",
           "train_stale",
           "exchange_collective_bytes"]

REFRESH_MODES = ("exchange", "cached", "frozen")

_COLLECTIVE_OPS = collectives.COLLECTIVE_OPS

Caches = Tuple[torch.Tensor, ...]
Gens = Sequence[Optional[torch.Generator]]


def make_halo_forward(cfg: GNNConfig, plan: _exchange.ExchangePlan
                      ) -> Callable:
    """``forward(params, tensors, gens=None, caches=None,
    refresh_mode="exchange") -> (embeddings [k, N_pad, E], logits [k,
    N_pad, C], caches)`` over the k stacked partitions.

    ``refresh_mode`` before every layer: ``"exchange"`` refreshes the halo
    rows from their owners (and returns the refreshed layer inputs,
    detached, as ``caches``); ``"cached"`` overwrites them from ``caches``;
    ``"frozen"`` leaves them as local compute made them. ``gens`` (one
    generator per partition) turns dropout on; None is inference."""
    layer = gcn_layer if cfg.kind == "gcn" else sage_layer

    def forward(params: Params, tensors: PartitionTensors,
                gens: Optional[Gens] = None, caches: Optional[Caches] = None,
                refresh_mode: str = "exchange"):
        if refresh_mode not in REFRESH_MODES:
            raise ValueError(f"refresh_mode must be one of {REFRESH_MODES}, "
                             f"got {refresh_mode!r}")
        k = tensors.k
        mask = tensors.node_mask[..., None]
        h = tensors.features * mask
        layers = params["body"]["layers"]
        new_caches = []
        for i, lp in enumerate(layers):
            last = i == len(layers) - 1
            if refresh_mode == "exchange":
                h = plan.exchange(h)
                new_caches.append(h.detach())
            elif refresh_mode == "cached":
                h = plan.refresh(h, caches[i])
            rows = h.unbind(0)
            outs = []
            for p in range(k):
                out = layer(partition_params(lp, p), rows[p],
                            tensors.csrs[p], tensors.in_degree[p],
                            activate=not last) * mask[p]
                if gens is not None and cfg.dropout > 0 and not last:
                    out = dropout(out, cfg.dropout, gens[p])
                outs.append(out)
            h = torch.stack(outs)
        logits = torch.stack([head_logits(partition_params(params["head"], p),
                                          h[p]) for p in range(k)])
        return h, logits, (tuple(new_caches) if refresh_mode == "exchange"
                           else None)
    return forward


def make_sync_forward(cfg: GNNConfig, plan: _exchange.ExchangePlan
                      ) -> Callable:
    """``forward(params, tensors, gens=None) -> (embeddings, logits)`` with
    a live refresh before every layer (sync semantics)."""
    halo_forward = make_halo_forward(cfg, plan)

    def forward(params, tensors, gens=None):
        h, logits, _ = halo_forward(params, tensors, gens)
        return h, logits
    return forward


def _halo_step(forward: Callable, refresh_mode: str, params: Params,
               opt: OptState, tensors: PartitionTensors, multilabel: bool,
               lr: float, gens: Gens, caches: Optional[Caches] = None
               ) -> Tuple[Params, OptState, torch.Tensor, Optional[Caches]]:
    """One AdamW step of all k partitions through ``forward``: one backward
    of the summed losses, then the stacked update. Returns ``(params, opt,
    losses [k], caches)``."""
    leaves = tree_map(lambda x: x.detach().requires_grad_(), params)
    _, logits, new_caches = forward(leaves, tensors, gens, caches,
                                    refresh_mode)
    loss_fn = sigmoid_bce if multilabel else softmax_xent
    losses = torch.stack([loss_fn(logits[p], tensors.labels[p],
                                  tensors.train_mask[p])
                          for p in range(tensors.k)])
    grads = iter(torch.autograd.grad(losses.sum(), tree_leaves(leaves)))
    grads = tree_map(lambda _: next(grads), leaves)
    params, opt = adamw_update(grads, opt, params, lr, weight_decay=0.0)
    return params, opt, losses.detach(), new_caches


def make_sync_train_step(cfg: GNNConfig, plan: _exchange.ExchangePlan,
                         multilabel: bool, lr: float) -> Callable:
    """``step(params, opt, tensors, gens) -> (params, opt, losses [k])``:
    the sync baseline's step, an exchange before every layer."""
    forward = make_halo_forward(cfg, plan)

    def step(params, opt, tensors, gens):
        return _halo_step(forward, "exchange", params, opt, tensors,
                          multilabel, lr, gens)[:3]
    return step


def stale_exchange_epochs(epochs: int, period: Optional[int]) -> List[int]:
    """Epochs on which stale mode exchanges: every ``e`` with ``e % period
    == 0`` for ``period >= 1`` (epoch 0 always); none for ``period`` None,
    0 or negative (the local limit). ``period=1`` is every epoch."""
    if not period or period < 1:
        return []
    return [e for e in range(epochs) if e % period == 0]


def stale_bytes_per_epoch(exchange_bytes: int, epochs: int,
                          period: Optional[int]) -> List[int]:
    """Collective bytes of each epoch: ``exchange_bytes`` on exchange
    epochs, 0 in between."""
    on = set(stale_exchange_epochs(epochs, period))
    return [int(exchange_bytes) if e in on else 0 for e in range(epochs)]


def _stale_cache_shapes(cfg: GNNConfig, n_pad: int) -> List[Tuple[int, int]]:
    """Per-layer cache shapes: layer ``i``'s input ``[N_pad, F_i]`` (one
    partition's; the port stacks k of them)."""
    dims = [cfg.feature_dim] + [cfg.hidden_dim] * (cfg.num_layers - 1)
    return [(n_pad, d) for d in dims]


def make_stale_train_steps(cfg: GNNConfig, plan: _exchange.ExchangePlan,
                           multilabel: bool, lr: float
                           ) -> Dict[str, Callable]:
    """Stale mode's three steps, by discipline:

    - ``"exchange"``: ``(params, opt, tensors, gens) -> (params, opt,
      losses, caches)``, the sync step that also returns every layer's
      refreshed input;
    - ``"stale"``: ``(params, opt, tensors, gens, caches) -> (params, opt,
      losses)``, the halo rows read from ``caches``; no exchange;
    - ``"frozen"``: ``(params, opt, tensors, gens) -> (params, opt,
      losses)``, local mode's step, before the first exchange."""
    forward = make_halo_forward(cfg, plan)

    def step_ex(params, opt, tensors, gens):
        return _halo_step(forward, "exchange", params, opt, tensors,
                          multilabel, lr, gens)

    def step_st(params, opt, tensors, gens, caches):
        return _halo_step(forward, "cached", params, opt, tensors,
                          multilabel, lr, gens, caches)[:3]

    def step_fz(params, opt, tensors, gens):
        return stacked_train_step(params, opt, tensors, cfg, multilabel, lr,
                                  gens)
    return {"exchange": step_ex, "stale": step_st, "frozen": step_fz}


def capture_steps(steps: Dict[str, Callable], device: torch.device
                  ) -> Dict[str, CapturedStep]:
    """Each of :func:`make_stale_train_steps`'s steps as a
    :class:`CapturedStep` in one shared pool: params and opt donated, the
    tensors (and the "stale" step's caches) borrowed."""
    pool = new_pool(device)
    return {kind: CapturedStep(fn, device, pool=pool, donate=(0, 1),
                               borrow=(2, 4) if kind == "stale" else (2,),
                               name=kind)
            for kind, fn in steps.items()}


def _train_halo(mode: str, ds: NodeDataset, batch: PartitionBatch,
                halo: HaloExchangeSpec, cfg: GNNConfig, epochs: int,
                lr: float, seed: int, schedule: Sequence[int],
                integrate: str, device: DeviceLike, params: Optional[Params],
                tensors: Optional[PartitionTensors],
                capture: bool = True, mesh=None) -> LocalTraining:
    """The epoch loop of both modes (``mode`` "sync" or "stale"): exchange
    steps on the epochs of ``schedule`` (every epoch: sync), local steps
    before the first, cached steps after it. Traced epochs are
    ``train.epoch`` spans (stale's with the step's ``kind``); stale counts
    its exchange epochs in ``train.stale_exchanges``. Under ``mesh`` this
    rank trains partition ``rank`` with :class:`~repro_torch.gnn.
    distributed.HaloAllGather` as its exchange, eagerly, each step's
    collectives counted."""
    device = resolve_device(device)
    k = batch.k
    if halo.send_rows.shape[0] != k:
        raise ValueError(f"halo spec is for k={halo.send_rows.shape[0]}, "
                         f"the batch has k={k}")
    sh = None
    if mesh is not None:
        from . import distributed
        distributed.check_halo_mesh(mesh, k)
        if capture:
            distributed.refuse_capture(mode)
        sh = distributed.shard(mesh, k, device)
    if params is None:
        params = init_partition_models(cfg, ds.num_classes, k,
                                       torch.Generator().manual_seed(seed),
                                       device)
    gens = dropout_generators(seed, k, device)
    if sh is None:
        if tensors is None:
            tensors = gather_partition_tensors(ds, batch, device)
        plan = _exchange.plan(halo, batch.n_pad, device)
    else:
        params = distributed.slice_params(params, sh)
        gens = gens[sh.lo:sh.hi]
        if tensors is None:
            tensors = gather_partition_tensors(ds, batch, device,
                                               only=slice(sh.lo, sh.hi))
        plan = distributed.HaloAllGather(halo, sh, batch.n_pad, device)
        counter = distributed.StepCounter(sh)
    steps = make_stale_train_steps(cfg, plan, ds.multilabel, lr)
    if capture:
        steps = capture_steps(steps, device)
    opt = adamw_init(params, stacked=True)
    losses = torch.empty((epochs, tensors.k), dtype=torch.float32,
                         device=device)
    exchanges = np.zeros(epochs, dtype=np.int64)
    on = set(schedule)
    caches = None

    def run_epoch(kind):
        nonlocal params, opt, caches
        if kind == "exchange":
            params, opt, loss, caches = steps["exchange"](params, opt,
                                                          tensors, gens)
        elif kind == "frozen":
            params, opt, loss = steps["frozen"](params, opt, tensors, gens)
        else:
            params, opt, loss = steps["stale"](params, opt, tensors, gens,
                                               caches)
        return loss

    def run(kind):
        if sh is None:
            return run_epoch(kind)
        return counter.step(lambda: run_epoch(kind))

    epochs_ctr = obs.counter("train.epochs")
    exchanges_ctr = obs.counter("train.stale_exchanges")
    traced = obs.enabled()
    synchronize(device)
    t0 = time.perf_counter()
    for e in range(epochs):
        before = _exchange.calls
        kind = ("exchange" if e in on
                else "frozen" if caches is None else "stale")
        if traced:
            attrs = {"kind": kind} if mode == "stale" else {}
            with obs.span("train.epoch", epoch=e, mode=mode, **attrs) as sp:
                losses[e] = run(kind)
                finish_epoch_span(sp, losses[e])
        else:
            losses[e] = run(kind)
        if mode == "stale" and kind == "exchange":
            exchanges_ctr.inc()
        epochs_ctr.inc()
        exchanges[e] = _exchange.calls - before
    del caches
    synchronize(device)
    t1 = time.perf_counter()
    # the embedding pass refreshes live if the run ever exchanged (the sync
    # limit stays exact) and is local otherwise (the local limit does)
    if on:
        forward = make_halo_forward(cfg, plan)

        def emb_fn(ps):
            with torch.no_grad():
                return forward(ps, tensors)[0]
    else:
        def emb_fn(ps):
            return compute_embeddings(ps, cfg, tensors)
    if sh is None:
        params, emb = apply_integration(params, integrate, emb_fn, k)
        table = pool_embeddings(emb, tensors, ds.graph.n)
    else:
        def sharded_emb_fn(ps):
            with collectives.phase("embedding gather"):
                return emb_fn(ps)
        params, emb = distributed.integrate(params, integrate,
                                            sharded_emb_fn, sh)
        table = distributed.pooled_table(emb, batch, ds.graph.n, sh)
    synchronize(device)
    return LocalTraining(params=params, embeddings=table,
                         losses=losses.cpu().numpy(),
                         seconds={"epochs": t1 - t0,
                                  "embed": time.perf_counter() - t1},
                         exchanges=exchanges,
                         compiles={kind: getattr(fn, "compiles", 0)
                                   for kind, fn in steps.items()},
                         collectives=None if sh is None
                         else counter.summary())


def train_sync(ds: NodeDataset, batch: PartitionBatch,
               halo: HaloExchangeSpec, cfg: GNNConfig, *, epochs: int = 60,
               lr: float = 1e-2, seed: int = 0, integrate: str = "none",
               device: DeviceLike = "cuda", params: Optional[Params] = None,
               tensors: Optional[PartitionTensors] = None,
               capture: bool = True, mesh=None) -> LocalTraining:
    """The sync baseline: the halo rows are exchanged before every layer of
    every step. ``params``/``tensors``/``capture``/``mesh`` as in
    ``train_local``; under a mesh its ``data`` axis must have k ranks
    (``ValueError`` otherwise) and ``capture`` must be False
    (``CaptureError`` otherwise)."""
    return _train_halo("sync", ds, batch, halo, cfg, epochs, lr, seed,
                       range(epochs), integrate, device, params, tensors,
                       capture, mesh)


def train_stale(ds: NodeDataset, batch: PartitionBatch,
                halo: HaloExchangeSpec, cfg: GNNConfig, *, epochs: int = 60,
                lr: float = 1e-2, seed: int = 0,
                sync_period: Optional[int] = 4, integrate: str = "none",
                device: DeviceLike = "cuda", params: Optional[Params] = None,
                tensors: Optional[PartitionTensors] = None,
                capture: bool = True, mesh=None) -> LocalTraining:
    """Stale mode: the exchange runs on :func:`stale_exchange_epochs`
    only; the epochs between train against the halo rows cached at the
    last exchange, and those before the first (``sync_period`` 0 or None:
    every epoch) are local steps. ``mesh`` as in :func:`train_sync`: the
    steps between exchanges issue no collective."""
    return _train_halo("stale", ds, batch, halo, cfg, epochs, lr, seed,
                       stale_exchange_epochs(epochs, sync_period),
                       integrate, device, params, tensors, capture, mesh)


def exchange_collective_bytes(cfg: GNNConfig,
                              halo: Optional[HaloExchangeSpec], k: int,
                              mode: str = "sync", epochs: int = 1,
                              sync_period: Optional[int] = None
                              ) -> Dict[str, int]:
    """The reference's collective-byte report of a training step
    (``collective_bytes`` of its compiled HLO, with the pipeline's
    ``per_epoch_avg`` and, for stale, ``stale_step_total`` and
    ``n_exchange_epochs``), from the exchange schedule.

    Per device, the reference's sync step all-gathers ``[k, k, H_pad,
    F_i]`` f32 before each layer ``i`` and reduce-scatters ``[1, k, H_pad,
    F_i]`` for each layer but the first, whose input needs no gradient.
    Local mode, and stale mode that never exchanges, move nothing; stale's
    between-exchange step moves nothing."""
    if mode not in ("local", "sync", "stale"):
        raise ValueError(f"mode must be local|sync|stale, got {mode!r}")
    out = {op: 0 for op in _COLLECTIVE_OPS}
    counts = {op: 0 for op in _COLLECTIVE_OPS}
    n_exchange = len(stale_exchange_epochs(epochs, sync_period)) \
        if mode == "stale" else 0
    if mode == "sync" or n_exchange:
        widths = [f for _, f in _stale_cache_shapes(cfg, 0)]
        h_pad = int(halo.h_pad)
        out["all-gather"] = sum(k * k * h_pad * f * 4 for f in widths)
        out["reduce-scatter"] = sum(k * h_pad * f * 4 for f in widths[1:])
        counts["all-gather"] = len(widths)
        counts["reduce-scatter"] = len(widths) - 1
    out["total"] = sum(out[op] for op in _COLLECTIVE_OPS)
    out.update({f"n_{op}": counts[op] for op in _COLLECTIVE_OPS})
    if mode == "stale":
        per_epoch = stale_bytes_per_epoch(out["total"], epochs, sync_period)
        out["stale_step_total"] = 0
        out["n_exchange_epochs"] = n_exchange
        out["per_epoch_avg"] = int(round(sum(per_epoch) / max(epochs, 1)))
    else:
        out["per_epoch_avg"] = out["total"]
    return out
