"""Training of the k partition models, and the MLP classifier on the
pooled embeddings.

Three modes train the k GNN replicas: local, the paper's scheme, here
(each partition trains on its own subgraph with no communication); sync,
the halo-exchange baseline, and stale, which exchanges every N epochs,
in :mod:`repro_torch.gnn.halo` (their steps reuse this module's local
step, integration and classifier).

The reference vmaps one partition's AdamW step over the k partitions. Here
the k partitions are a loop inside each epoch, which is the same math,
since partitions never interact: the parameters stay stacked ``[k, ...]``,
each partition's loss is differentiated with respect to its own slice, and
one stacked AdamW step, which clips and counts steps per partition,
updates all k. The ``sequential=True`` path (the reference's low-memory
path) keeps one partition's tensors on the device at a time and swaps the
loops: partition p runs all its epochs before p+1 starts.

Dropout masks come from one generator per partition, seeded from
``(seed, p)``, so the two loop orders draw the same masks.

Every epoch counts ``train.epochs``. When :mod:`repro_torch.obs` traces,
each epoch runs in a ``train.epoch`` span (the sequential path: each
partition in a ``train.partition`` span) that ends in one ``.item()`` of
the mean loss, so the span covers the card's work; the untraced loop never
waits on the card.

Each step runs as a :class:`repro_torch.graphs.CapturedStep` (the
reference jits it): on the card one CUDA graph holds the whole stacked
step (k forwards, k backwards, the stacked AdamW), the sequential path's
single-partition step (one graph for all k partitions, which padding
gives one shape) and the classifier's step. Parameters and optimizer
state are donated, so they stay in the graph's static buffers from epoch
to epoch, and each epoch's loss is copied out of its static output.
``capture=False`` runs the eager loop instead (the tests and
``chip_smoke.py`` compare the two on the card).
"""
from __future__ import annotations

import time
import types
from typing import Callable, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch import obs
from repro_torch.core import (NodeDataset, PartitionBatch,
                              average_partition_params)
from repro_torch.device import DeviceLike, resolve_device, synchronize
from repro_torch.graphs import CapturedStep
from repro_torch.optim import OptState, adamw_init, adamw_update
from repro_torch.tree import tree_map, value_and_grad

from .infer import (Params, PartitionTensors, compute_embeddings,
                    gather_partition_tensors, init_partition_models,
                    partition_params, pool_embeddings)
from .model import (GNNConfig, gnn_forward, head_logits, init_mlp,
                    mlp_forward, sigmoid_bce, softmax_xent)

__all__ = ["LocalTraining", "dropout_generators", "partition_loss",
           "local_train_step", "stacked_train_step", "make_stacked_step",
           "make_local_step", "make_classifier_step", "train_local",
           "apply_integration", "train_classifier", "mean_rocauc",
           "finish_epoch_span"]


def finish_epoch_span(sp, loss: torch.Tensor) -> None:
    """Close a traced epoch: one ``.item()`` of the mean loss waits for the
    card, so the span covers its work; the value goes on the span and the
    ``train.loss`` gauge. Called under ``obs.enabled()`` only."""
    val = loss.mean().item()
    sp.set(loss=round(val, 6))
    obs.gauge("train.loss").set(val)


class LocalTraining(NamedTuple):
    """What a training mode returns (local, and sync and stale in
    :mod:`repro_torch.gnn.halo`)."""
    params: Params              # stacked [k, ...], after integration
    embeddings: torch.Tensor    # [n, E] pooled table
    losses: np.ndarray          # [epochs, k] loss of every partition's step
    seconds: Dict[str, float]   # "epochs" (the loop), "embed" (+ pooling)
    exchanges: Optional[np.ndarray] = None   # [epochs] halo exchanges in
                                             # each step (sync and stale)
    compiles: Optional[Dict[str, int]] = None   # step kind -> signatures
                                                # compiled (captured)


def dropout_generators(seed: int, k: int, device: torch.device
                       ) -> List[torch.Generator]:
    """One generator per partition on ``device``, seeded from
    ``(seed, p)``."""
    seeds = np.random.SeedSequence(seed).spawn(k)
    return [torch.Generator(device=device).manual_seed(
        int(s.generate_state(1, dtype=np.uint64)[0])) for s in seeds]


def partition_loss(params: Params, cfg: GNNConfig, tensors: PartitionTensors,
                   p: int, multilabel: bool,
                   gen: Optional[torch.Generator] = None) -> torch.Tensor:
    """Partition ``p``'s training loss under its own (unstacked) model."""
    emb = gnn_forward(params["body"], cfg, tensors.features[p],
                      tensors.csrs[p], tensors.in_degree[p],
                      node_mask=tensors.node_mask[p], dropout_gen=gen)
    logits = head_logits(params["head"], emb)
    loss_fn = sigmoid_bce if multilabel else softmax_xent
    return loss_fn(logits, tensors.labels[p], tensors.train_mask[p])


def local_train_step(params: Params, opt: OptState,
                     tensors: PartitionTensors, p: int, cfg: GNNConfig,
                     multilabel: bool, lr: float,
                     gen: Optional[torch.Generator] = None
                     ) -> Tuple[Params, OptState, torch.Tensor]:
    """One AdamW step of partition ``p``'s model (unstacked parameters and
    state): the counterpart of the reference's single-partition step.
    Returns ``(params, opt, loss)``."""
    loss, grads = value_and_grad(
        lambda pp: partition_loss(pp, cfg, tensors, p, multilabel, gen),
        params)
    params, opt = adamw_update(grads, opt, params, lr, weight_decay=0.0)
    return params, opt, loss


def stacked_train_step(params: Params, opt: OptState, tensors: PartitionTensors,
                   cfg: GNNConfig, multilabel: bool, lr: float,
                   gens: List[Optional[torch.Generator]]
                   ) -> Tuple[Params, OptState, torch.Tensor]:
    """One AdamW step of all k partitions (stacked parameters and state):
    the counterpart of the reference's vmapped step. Per-partition
    gradients, then one stacked update that clips and counts steps per
    partition. Returns ``(params, opt, losses [k])``."""
    losses, grads = [], []
    for p in range(tensors.k):
        loss, g = value_and_grad(
            lambda pp: partition_loss(pp, cfg, tensors, p, multilabel,
                                      gens[p]),
            partition_params(params, p))
        losses.append(loss)
        grads.append(g)
    grads = tree_map(lambda *gs: torch.stack(gs), *grads)
    params, opt = adamw_update(grads, opt, params, lr, weight_decay=0.0)
    return params, opt, torch.stack(losses)


def make_stacked_step(tensors: PartitionTensors, cfg: GNNConfig,
                      multilabel: bool, lr: float, device: torch.device,
                      capture: bool = True) -> Callable:
    """``step(params, opt, gens) -> (params, opt, losses [k])`` over
    ``tensors`` (bound by address): :func:`stacked_train_step` as one
    :class:`CapturedStep` with params and opt donated, or itself with
    ``capture=False``."""
    def stacked(params, opt, gens):
        return stacked_train_step(params, opt, tensors, cfg, multilabel, lr,
                                  gens)
    if not capture:
        return stacked
    return CapturedStep(stacked, device, donate=(0, 1), name="local")


def make_local_step(cfg: GNNConfig, multilabel: bool, lr: float,
                    device: torch.device, capture: bool = True) -> Callable:
    """``step(params, opt, tensors, gen) -> (params, opt, loss)``: one
    partition's step (:func:`local_train_step` on a ``k = 1`` batch), whose
    tensors are copied into the step's static inputs on every call, so one
    graph serves every partition of one padded shape."""
    def local(params, opt, tensors, gen):
        return local_train_step(params, opt, tensors, 0, cfg, multilabel,
                                lr, gen)
    if not capture:
        return local
    return CapturedStep(local, device, donate=(0, 1), name="sequential")


def train_local(ds: NodeDataset, batch: PartitionBatch, cfg: GNNConfig, *,
                epochs: int = 60, lr: float = 1e-2, seed: int = 0,
                integrate: str = "none", sequential: bool = False,
                device: DeviceLike = "cuda", params: Optional[Params] = None,
                tensors: Optional[PartitionTensors] = None,
                capture: bool = True) -> LocalTraining:
    """The paper's local training; returns the trained (and integrated)
    stacked parameters, the pooled ``[n, E]`` table and every step's loss.

    ``params`` defaults to :func:`init_partition_models` seeded with
    ``seed``; ``tensors`` (the vmapped path) to the batch gathered onto
    ``device``. ``sequential=True`` gathers one partition at a time
    instead; the trained parameters are the same. ``capture=False`` runs
    the eager loop (see the module docstring)."""
    device = resolve_device(device)
    k = batch.k
    if params is None:
        params = init_partition_models(cfg, ds.num_classes, k,
                                       torch.Generator().manual_seed(seed),
                                       device)
    gens = dropout_generators(seed, k, device)
    losses = torch.empty((epochs, k), dtype=torch.float32, device=device)
    epochs_ctr = obs.counter("train.epochs")
    traced = obs.enabled()
    synchronize(device)
    t0 = time.perf_counter()
    if sequential:
        def one(p):
            return gather_partition_tensors(ds, batch, device, only=p)
        step = make_local_step(cfg, ds.multilabel, lr, device, capture)
        trained = []
        for p in range(k):
            t_p = one(p)
            params_p = partition_params(params, p)
            opt = adamw_init(params_p)
            with obs.span("train.partition", partition=p, epochs=epochs,
                          mode="local_sequential") as psp:
                for e in range(epochs):
                    params_p, opt, losses[e, p] = step(params_p, opt, t_p,
                                                       gens[p])
                    epochs_ctr.inc()
                if traced and epochs:
                    finish_epoch_span(psp, losses[epochs - 1, p])
            # the next partition's first call overwrites the static buffers
            trained.append(tree_map(torch.clone, params_p))
            del t_p
        params = tree_map(lambda *xs: torch.stack(xs), *trained)
        compiles = {"sequential": getattr(step, "compiles", 0)}

        def emb_fn(ps):
            return torch.cat([compute_embeddings(
                tree_map(lambda x: x[p:p + 1], ps), cfg, one(p))
                for p in range(k)])
        owned = types.SimpleNamespace(
            owned_mask=torch.as_tensor(batch.owned_mask, device=device),
            node_ids=torch.as_tensor(batch.node_ids.astype(np.int64),
                                     device=device))
    else:
        if tensors is None:
            tensors = gather_partition_tensors(ds, batch, device)
        opt = adamw_init(params, stacked=True)
        step = make_stacked_step(tensors, cfg, ds.multilabel, lr, device,
                                 capture)
        for e in range(epochs):
            if traced:
                with obs.span("train.epoch", epoch=e, mode="local") as sp:
                    params, opt, losses[e] = step(params, opt, gens)
                    finish_epoch_span(sp, losses[e])
            else:
                params, opt, losses[e] = step(params, opt, gens)
            epochs_ctr.inc()
        compiles = {"local": getattr(step, "compiles", 0)}

        def emb_fn(ps):
            return compute_embeddings(ps, cfg, tensors)
        owned = tensors
    synchronize(device)
    t1 = time.perf_counter()
    params, emb = apply_integration(params, integrate, emb_fn, k)
    table = pool_embeddings(emb, owned, ds.graph.n)
    synchronize(device)
    return LocalTraining(params=params, embeddings=table,
                         losses=losses.cpu().numpy(),
                         seconds={"epochs": t1 - t0,
                                  "embed": time.perf_counter() - t1},
                         compiles=compiles)


def apply_integration(params: Params, integrate: Optional[str],
                      emb_fn: Callable[[Params], torch.Tensor], k: int
                      ) -> Tuple[Params, torch.Tensor]:
    """Integrate the k partition models before embedding assembly.

    ``emb_fn(params) -> [k, N_pad, E]`` is the mode's embedding forward.
    ``"none"`` keeps the k models; ``"model_avg"`` parameter-averages them
    and embeds with the average everywhere; ``"ensemble"`` embeds each
    subgraph with all k models and averages the embeddings."""
    if integrate in (None, "none"):
        return params, emb_fn(params)
    if integrate == "model_avg":
        params = average_partition_params(params)
        return params, emb_fn(params)
    if integrate == "ensemble":
        acc = None
        for m in range(k):
            pm = tree_map(lambda x: x[m:m + 1].expand_as(x), params)
            emb = emb_fn(pm)
            acc = emb if acc is None else acc + emb
        return params, acc / float(k)
    raise ValueError(
        f"integrate must be none|model_avg|ensemble, got {integrate!r}")


def make_classifier_step(x: torch.Tensor, y: torch.Tensor,
                         train_mask: torch.Tensor, multilabel: bool,
                         lr: float, capture: bool = True) -> Callable:
    """``step(params, opt) -> (params, opt)``: one full-batch AdamW step
    of the classifier on ``x`` (bound by address), as one
    :class:`CapturedStep` with both donated, or eager with
    ``capture=False``."""
    loss_fn = sigmoid_bce if multilabel else softmax_xent

    def classifier(params, opt):
        _, grads = value_and_grad(
            lambda p: loss_fn(mlp_forward(p, x), y, train_mask), params)
        return adamw_update(grads, opt, params, lr)
    if not capture:
        return classifier
    return CapturedStep(classifier, x.device, donate=(0, 1),
                        name="classifier")


def train_classifier(ds: NodeDataset, embeddings: torch.Tensor,
                     hidden: int = 256, epochs: int = 150, lr: float = 1e-2,
                     seed: int = 0, params: Optional[Params] = None,
                     capture: bool = True
                     ) -> Tuple[Dict[str, float], Params]:
    """Train the MLP on the frozen pooled table (full batch, AdamW) and
    report train/val/test accuracy (mean ROC-AUC for multilabel data).

    ``params`` defaults to :func:`init_mlp` seeded with ``seed``;
    ``capture=False`` runs the eager loop. Returns ``(metrics, trained
    params)``."""
    device = embeddings.device
    if params is None:
        params = init_mlp(torch.Generator().manual_seed(seed),
                          embeddings.shape[1], hidden, ds.num_classes,
                          device)
    opt = adamw_init(params)
    x = embeddings.float()
    y = torch.as_tensor(ds.labels, device=device,
                        dtype=torch.float32 if ds.multilabel
                        else torch.int64)
    tr = torch.as_tensor(ds.train_mask, dtype=torch.float32, device=device)
    step = make_classifier_step(x, y, tr, ds.multilabel, lr, capture)
    for _ in range(epochs):
        params, opt = step(params, opt)
    with torch.no_grad():
        logits = mlp_forward(params, x).cpu().numpy()
    out = {}
    for split, mask in (("train", ds.train_mask), ("val", ds.val_mask),
                        ("test", ds.test_mask)):
        if ds.multilabel:
            out[split] = float(mean_rocauc(ds.labels[mask], logits[mask]))
        else:
            pred = logits[mask].argmax(-1)
            out[split] = float((pred == ds.labels[mask]).mean())
    return out, params


def mean_rocauc(y: np.ndarray, score: np.ndarray) -> float:
    """Mean ROC-AUC over tasks (rank statistic, ties averaged)."""
    aucs = []
    for t in range(y.shape[1]):
        yt, st = y[:, t], score[:, t]
        pos = yt > 0.5
        n_pos, n_neg = int(pos.sum()), int((~pos).sum())
        if n_pos == 0 or n_neg == 0:
            continue
        order = np.argsort(st, kind="mergesort")
        ranks = np.empty_like(order, dtype=np.float64)
        ranks[order] = np.arange(1, len(st) + 1)
        sorted_s = st[order]
        i = 0
        while i < len(st):
            j = i
            while j + 1 < len(st) and sorted_s[j + 1] == sorted_s[i]:
                j += 1
            if j > i:
                ranks[order[i:j + 1]] = (i + j + 2) / 2.0
            i = j + 1
        aucs.append((ranks[pos].sum() - n_pos * (n_pos + 1) / 2)
                    / (n_pos * n_neg))
    return float(np.mean(aucs)) if aucs else 0.5
