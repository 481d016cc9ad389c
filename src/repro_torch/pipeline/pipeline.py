"""The pipeline: the training run and the inference run.

    dataset -> partition (any registered method, by spec string; through
    the artifact cache when ``cache_dir`` is set) -> partition metrics
    -> per-partition assembly (+ the halo exchange plan for sync and stale)
    -> to device (one CSR per partition)
    -> train: k GNN replicas, in one of three  | embed: seeded or given
       modes, pooled embeddings                |   parameters, pooled
    -> classifier trained on the pooled table  |   embeddings
    -> offline answer key (blocked classify) -> serving bundle

:func:`run_training` trains in ``mode`` "local" (the paper's scheme, no
communication), "sync" (the halo-exchange baseline: halo rows refreshed
from their owners before every layer) or "stale" (the exchange every
``sync_period`` epochs, cached halo rows in between); sync and stale run
on the Repli assembly, whatever ``scheme`` says, and the report carries
the reference's collective bytes of the step. :func:`run_inference` runs
the same stages with seeded (or handed-in) parameters and no training.

Both time every stage on the host clock, each ending in a device
synchronize, and run it inside a :mod:`repro_torch.obs` span under the
reference's names (``pipeline.total``, ``pipeline.dataset``,
``pipeline.partition``, ``pipeline.partition_eval``, ``pipeline.train``,
``pipeline.classifier``, ``pipeline.serving_export``; the port's other
stages as ``pipeline.<key>``). When tracing is on, each timing is its
span's duration; off, a ``perf_counter`` pair over the same window.
Memory is sampled after every stage. ``checkpoint_dir`` saves the trained
parameters at step ``epochs`` in the reference's checkpoint layout, and
``torch_profile_dir`` runs ``torch.profiler`` over the train stage.
"""
from __future__ import annotations

import contextlib
import dataclasses
import logging
import time
from typing import Any, Callable, Dict, Iterator, Mapping, Optional

import numpy as np
import torch

from repro_torch import obs
from repro_torch.checkpoint import save_checkpoint
from repro_torch.core import (INTEGRATION_KINDS, NodeDataset,
                              PartitionBatch, PartitionerSpec,
                              evaluate_partition)
from repro_torch.device import DeviceLike, resolve_device, synchronize
from repro_torch.gnn.infer import (PartitionTensors, compute_embeddings,
                                   gather_partition_tensors,
                                   init_partition_models, pool_embeddings)
from repro_torch.gnn.model import GNNConfig, init_mlp
from repro_torch.gnn.halo import (exchange_collective_bytes, train_stale,
                                  train_sync)
from repro_torch.gnn.train import train_classifier, train_local

from .artifacts import (ArtifactBundle, PartitionArtifactStore,
                        compute_bundle)
from .datasets import get_dataset

__all__ = ["PipelineConfig", "PipelineResult", "PipelineReport",
           "run_training", "run_inference"]

log = logging.getLogger("repro_torch.pipeline")

HALO_MODES = ("sync", "stale")


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    """One run. Defaults are the reference pipeline's."""
    dataset: str = "arxiv-like"
    method: str = "leiden_fusion"   # partitioner spec, e.g. "metis",
                                    # "lpa+f(alpha=0.1)"
    k: int = 8
    seed: int = 0
    scheme: str = "repli"           # "inner" | "repli" (sync/stale force
                                    # repli)
    mode: str = "local"             # "local" | "sync" | "stale"
    sync_period: int = 4            # stale mode: exchange halos every N
                                    # epochs (1 = sync; 0 = never = local)
    integrate: str = "none"         # "none" | "model_avg" | "ensemble"
    model: str = "gcn"              # "gcn" | "sage"
    hidden_dim: int = 128
    embed_dim: int = 128
    num_layers: int = 3
    dropout: float = 0.3
    epochs: int = 60
    lr: float = 5e-3
    classifier_epochs: int = 150    # <= 0 skips the classifier stage
    classifier_hidden: int = 256
    low_memory: bool = False        # local mode: train one partition at
                                    # a time
    cache_dir: Optional[str] = None     # None disables the artifact cache
    checkpoint_dir: Optional[str] = None    # save the trained parameters
    serving_dir: Optional[str] = None   # export a serving bundle here
    torch_profile_dir: Optional[str] = None     # torch.profiler over the
                                                # train stage, written here
    dataset_kwargs: Mapping[str, Any] = dataclasses.field(
        default_factory=dict)


@dataclasses.dataclass
class PipelineResult:
    """What one run produced, on the run's device where it is a tensor."""
    dataset: NodeDataset
    labels: np.ndarray              # [n] partition of every node
    batch: PartitionBatch
    spec: PartitionerSpec
    bundle: ArtifactBundle          # cache hits, paths, partition seconds
    partition: Dict[str, Any]       # PartitionReport.as_dict()
    tensors: Optional[PartitionTensors]   # None for a low-memory run
    gnn: GNNConfig
    params: Dict[str, Any]          # stacked k replicas (body + head)
    classifier: Dict[str, torch.Tensor]
    embeddings: torch.Tensor        # [n, E] pooled table
    predictions: np.ndarray         # [n] offline answer key
    timings: Dict[str, float]
    accuracy: Dict[str, float] = dataclasses.field(default_factory=dict)
    losses: Optional[np.ndarray] = None   # [epochs, k], training runs
    exchanges: Optional[np.ndarray] = None   # [epochs], sync and stale
    collectives: Dict[str, int] = dataclasses.field(default_factory=dict)
    serving_path: Optional[str] = None
    checkpoint_path: Optional[str] = None
    profile_path: Optional[str] = None    # the torch.profiler trace


@dataclasses.dataclass(frozen=True)
class PipelineReport:
    """The reference's report fields that apply to the port's run."""
    config: Dict[str, Any]
    dataset: str
    num_nodes: int
    num_edges: int
    device: str
    partition: Dict[str, Any]       # PartitionReport.as_dict()
    partition_cache_hit: bool
    batch_cache_hit: bool
    artifact_paths: Dict[str, Optional[str]]
    shapes: Dict[str, int]          # k, n_pad, e_pad
    collectives: Dict[str, int]     # the reference's collective bytes of
                                    # the step (training runs)
    accuracy: Dict[str, float]      # train/val/test (empty if skipped)
    timings: Dict[str, float]
    partition_fingerprint: str
    serving_path: Optional[str] = None
    checkpoint_path: Optional[str] = None

    @classmethod
    def of(cls, cfg: PipelineConfig, result: PipelineResult
           ) -> "PipelineReport":
        ds, batch, bundle = result.dataset, result.batch, result.bundle
        return cls(
            config={**dataclasses.asdict(cfg), "scheme": _scheme(cfg),
                    "method": result.spec.canonical(),
                    "dataset_kwargs": dict(cfg.dataset_kwargs)},
            dataset=ds.name,
            num_nodes=int(ds.graph.n), num_edges=int(ds.graph.num_arcs // 2),
            device=str(result.embeddings.device),
            partition=dict(result.partition),
            partition_cache_hit=bundle.labels_hit,
            batch_cache_hit=bundle.batch_hit,
            artifact_paths={"labels": bundle.labels_path,
                            "batch": bundle.batch_path},
            shapes={"k": batch.k, "n_pad": batch.n_pad,
                    "e_pad": batch.e_pad},
            collectives=dict(result.collectives),
            accuracy=dict(result.accuracy),
            timings={k: round(v, 4) for k, v in result.timings.items()},
            partition_fingerprint=result.spec.fingerprint(),
            serving_path=result.serving_path,
            checkpoint_path=result.checkpoint_path)

    def as_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    def summary(self) -> str:
        c, p = self.config, self.partition
        hit = "HIT" if self.partition_cache_hit else "miss"
        bhit = "HIT" if self.batch_cache_hit else "miss"
        mode = c["mode"]
        if mode == "stale":
            mode = f"stale(period={c['sync_period'] or '∞'})"
        lines = ["PipelineReport",
                 f"  dataset      {self.dataset} (n={self.num_nodes}, "
                 f"edges={self.num_edges})",
                 f"  partition    {c['method']} k={c['k']} "
                 f"seed={c['seed']} fp={self.partition_fingerprint} "
                 f"[cache {hit}]",
                 f"               cut={p['edge_cut_pct']:.1f}% "
                 f"components={p['total_components']} "
                 f"isolated={p['total_isolated']} "
                 f"balance={p['node_balance']:.2f} "
                 f"replication={p['replication_factor']:.2f}",
                 f"  assembly     scheme={c['scheme']} "
                 f"n_pad={self.shapes['n_pad']} "
                 f"e_pad={self.shapes['e_pad']} [cache {bhit}]",
                 f"  training     mode={mode} model={c['model']} "
                 f"layers={c['num_layers']} epochs={c['epochs']} "
                 f"device={self.device}"]
        if c["integrate"] != "none":
            lines.append(f"  integration  {c['integrate']} over "
                         f"k={c['k']} partition models (pre-assembly)")
        if self.collectives:
            col = self.collectives
            lines.append(f"  collectives  {col['total']} bytes/step "
                         f"(all-gather={col['all-gather']}, all-reduce="
                         f"{col['all-reduce']})")
            if c["mode"] == "stale":
                lines.append(
                    f"  stale comm   {col.get('per_epoch_avg', 0)} "
                    f"bytes/epoch avg ({col.get('n_exchange_epochs', 0)}/"
                    f"{c['epochs']} exchange epochs, between-exchange step="
                    f"{col.get('stale_step_total', 0)} bytes)")
        if self.accuracy:
            lines.append(f"  accuracy     train={self.accuracy['train']:.3f}"
                         f" val={self.accuracy['val']:.3f} "
                         f"test={self.accuracy['test']:.3f}")
        if self.checkpoint_path:
            lines.append(f"  checkpoint   {self.checkpoint_path}")
        if self.serving_path:
            lines.append(f"  serving      {self.serving_path}")
        lines.append("  timings      " + " ".join(
            f"{k}={v:.2f}s" for k, v in self.timings.items()))
        return "\n".join(lines)


# timing key -> span name, where the reference's name is not
# ``pipeline.<key>``
_SPAN_NAMES = {"partition_stage": "pipeline.partition",
               "export": "pipeline.serving_export"}


class _Stages:
    """Times each stage into ``timings`` (host clock, ending in a device
    synchronize) inside its ``pipeline.*`` span; the counterpart of the
    reference's ``_stage_span``."""

    def __init__(self, device: torch.device):
        self.device = device
        self.timings: Dict[str, float] = {}

    @contextlib.contextmanager
    def span(self, key: str, **attrs: Any) -> Iterator[Any]:
        """Time the block into ``timings[key]``: traced, exactly the
        span's duration; untraced, a ``perf_counter`` pair."""
        name = _SPAN_NAMES.get(key, f"pipeline.{key}")
        if obs.enabled():
            with obs.span(name, **attrs) as sp:
                yield sp
                synchronize(self.device)
            self.timings[key] = sp.duration
        else:
            t0 = time.perf_counter()
            yield obs.span(name)     # the shared no-op span
            synchronize(self.device)
            self.timings[key] = time.perf_counter() - t0
        obs.sample_memory_now()

    def __call__(self, key: str, fn: Callable[[], Any], **attrs: Any) -> Any:
        with self.span(key, **attrs):
            return fn()


def _check(cfg: PipelineConfig) -> PartitionerSpec:
    """Validate the config; returns the resolved partitioner spec (a bad
    spec string fails here, before any dataset or partition work)."""
    if cfg.k < 1:
        raise ValueError(f"k must be >= 1, got {cfg.k}")
    if cfg.mode not in ("local",) + HALO_MODES:
        raise ValueError(f"mode must be local|sync|stale, got {cfg.mode!r}")
    if cfg.sync_period < 0:
        raise ValueError(f"sync_period must be >= 0 (0 = never exchange), "
                         f"got {cfg.sync_period}")
    if cfg.integrate not in INTEGRATION_KINDS:
        raise ValueError(f"integrate must be one of {INTEGRATION_KINDS}, "
                         f"got {cfg.integrate!r}")
    return PartitionerSpec.parse(cfg.method)


def _scheme(cfg: PipelineConfig) -> str:
    """The assembly a run uses: sync and stale need the halo replicas."""
    return "repli" if cfg.mode in HALO_MODES else cfg.scheme


def _partitioned(cfg: PipelineConfig, spec: PartitionerSpec,
                 stage: _Stages, ds: Optional[NodeDataset]):
    """Dataset, partition and assembly (load-or-compute; with the halo plan
    for sync and stale), and the partition report. Returns (ds, bundle,
    report, gnn config)."""
    ds = stage("dataset", lambda: ds if ds is not None else get_dataset(
        cfg.dataset, **dict(cfg.dataset_kwargs)), dataset=cfg.dataset)
    scheme, with_halo = _scheme(cfg), cfg.mode in HALO_MODES
    if scheme != cfg.scheme:
        log.info("%s mode requires halo replicas: forcing scheme=repli "
                 "(was %s)", cfg.mode, cfg.scheme)
    with stage.span("partition_stage", method=spec.canonical(), k=cfg.k,
                    scheme=scheme) as psp:
        if cfg.cache_dir:
            bundle = PartitionArtifactStore(cfg.cache_dir).load_or_compute(
                ds.graph, spec, cfg.k, cfg.seed, scheme, with_halo=with_halo)
        else:
            bundle = compute_bundle(ds.graph, spec, cfg.k, cfg.seed, scheme,
                                    with_halo=with_halo)
        stage.timings["partition"] = bundle.partition_seconds
        stage.timings["assemble"] = bundle.assemble_seconds
        psp.set(cache_hit=bundle.labels_hit)
        report = stage("partition_eval", lambda: evaluate_partition(
            ds.graph, bundle.labels).as_dict())
    gnn = GNNConfig(kind=cfg.model, feature_dim=int(ds.features.shape[1]),
                    hidden_dim=cfg.hidden_dim, embed_dim=cfg.embed_dim,
                    num_layers=cfg.num_layers, dropout=cfg.dropout)
    return ds, bundle, report, gnn


def _finish(cfg: PipelineConfig, stage: _Stages,
            result: PipelineResult) -> PipelineResult:
    from repro_torch.serving.store import classify, export_from_pipeline
    result.predictions = stage("classify", lambda: classify(
        result.classifier, result.embeddings).argmax(-1).cpu().numpy()
        .astype(np.int32))
    if cfg.serving_dir:
        result.serving_path = stage("export", lambda: export_from_pipeline(
            cfg.serving_dir, result, result.spec))
    result.timings = stage.timings
    return result


def run_training(cfg: PipelineConfig, device: DeviceLike = "cuda",
                 ds: Optional[NodeDataset] = None,
                 params: Optional[Dict[str, Any]] = None,
                 classifier: Optional[Dict[str, torch.Tensor]] = None
                 ) -> PipelineResult:
    """The paper's pipeline: train the k GNN replicas in ``cfg.mode``, pool
    their embeddings, train the classifier, and export the trained bundle.

    ``params``/``classifier`` are the initial parameters; they default to
    the seeded ones :func:`run_inference` uses. The offline answer key is
    the trained classifier's blocked ``classify`` of the pooled table.
    ``low_memory`` applies to local mode only."""
    spec = _check(cfg)
    if cfg.serving_dir and cfg.classifier_epochs <= 0:
        raise ValueError("serving_dir requires the classifier stage "
                         "(classifier_epochs > 0)")
    stage = _Stages(resolve_device(device))
    with stage.span("total", dataset=cfg.dataset, mode=cfg.mode, k=cfg.k):
        return _train(cfg, spec, stage, ds, params, classifier)


def _train(cfg: PipelineConfig, spec: PartitionerSpec, stage: _Stages,
           ds: Optional[NodeDataset], params: Optional[Dict[str, Any]],
           classifier: Optional[Dict[str, torch.Tensor]]) -> PipelineResult:
    device = stage.device
    ds, bundle, report, gnn = _partitioned(cfg, spec, stage, ds)
    batch = bundle.batch
    low_memory = cfg.low_memory and cfg.mode == "local"
    tensors = None
    if not low_memory:
        tensors = stage("to_device",
                        lambda: gather_partition_tensors(ds, batch, device))
    gen = torch.Generator().manual_seed(cfg.seed)
    if params is None:
        params = init_partition_models(gnn, ds.num_classes, batch.k, gen,
                                       device)
    if classifier is None:
        classifier = init_mlp(gen, cfg.embed_dim, cfg.classifier_hidden,
                              ds.num_classes, device)
    profiler = obs.profiler_session(cfg.torch_profile_dir)

    def train():
        common = dict(epochs=cfg.epochs, lr=cfg.lr, seed=cfg.seed,
                      integrate=cfg.integrate, device=device, params=params,
                      tensors=tensors)
        with profiler:
            if cfg.mode == "sync":
                return train_sync(ds, batch, bundle.halo, gnn, **common)
            if cfg.mode == "stale":
                return train_stale(ds, batch, bundle.halo, gnn,
                                   sync_period=cfg.sync_period, **common)
            return train_local(ds, batch, gnn, sequential=low_memory,
                               **common)
    trained = stage("train", train, mode=cfg.mode, epochs=cfg.epochs,
                    model=cfg.model, k=cfg.k)
    stage.timings["train_epochs"] = trained.seconds["epochs"]
    stage.timings["train_embed"] = trained.seconds["embed"]
    collectives = exchange_collective_bytes(gnn, bundle.halo, batch.k,
                                            cfg.mode, cfg.epochs,
                                            cfg.sync_period)
    # the report's byte count, in the registry too: a trace is
    # self-contained
    obs.gauge("train.collective_bytes_per_step").set(collectives["total"])
    obs.gauge("train.collective_bytes_per_epoch_avg").set(
        collectives["per_epoch_avg"])
    accuracy: Dict[str, float] = {}
    if cfg.classifier_epochs > 0:
        accuracy, classifier = stage("classifier", lambda: train_classifier(
            ds, trained.embeddings, hidden=cfg.classifier_hidden,
            epochs=cfg.classifier_epochs, seed=cfg.seed, params=classifier),
            epochs=cfg.classifier_epochs)
    result = PipelineResult(
        dataset=ds, labels=bundle.labels, batch=batch, spec=spec,
        bundle=bundle, partition=report, tensors=tensors, gnn=gnn,
        params=trained.params, classifier=classifier,
        embeddings=trained.embeddings, predictions=np.zeros(0, np.int32),
        timings={}, accuracy=accuracy, losses=trained.losses,
        exchanges=trained.exchanges, collectives=collectives,
        profile_path=profiler.path)
    if cfg.checkpoint_dir:
        result.checkpoint_path = stage("checkpoint", lambda: save_checkpoint(
            cfg.checkpoint_dir, cfg.epochs, trained.params))
        log.info("saved model checkpoint: %s", result.checkpoint_path)
    return _finish(cfg, stage, result)


def run_inference(cfg: PipelineConfig, device: DeviceLike = "cuda",
                  ds: Optional[NodeDataset] = None,
                  params: Optional[Dict[str, Any]] = None,
                  classifier: Optional[Dict[str, torch.Tensor]] = None
                  ) -> PipelineResult:
    """Run the pipeline without training; ``params``/``classifier``
    default to seeded ones."""
    spec = _check(cfg)
    stage = _Stages(resolve_device(device))
    with stage.span("total", dataset=cfg.dataset, mode="inference",
                    k=cfg.k):
        return _infer(cfg, spec, stage, ds, params, classifier)


def _infer(cfg: PipelineConfig, spec: PartitionerSpec, stage: _Stages,
           ds: Optional[NodeDataset], params: Optional[Dict[str, Any]],
           classifier: Optional[Dict[str, torch.Tensor]]) -> PipelineResult:
    device = stage.device
    ds, bundle, report, gnn = _partitioned(cfg, spec, stage, ds)
    batch = bundle.batch
    tensors = stage("to_device",
                    lambda: gather_partition_tensors(ds, batch, device))
    gen = torch.Generator().manual_seed(cfg.seed)
    if params is None:
        params = init_partition_models(gnn, ds.num_classes, batch.k, gen,
                                       device)
    if classifier is None:
        classifier = init_mlp(gen, cfg.embed_dim, cfg.classifier_hidden,
                              ds.num_classes, device)
    emb = stage("embed", lambda: compute_embeddings(params, gnn, tensors))
    pooled = stage("pool", lambda: pool_embeddings(emb, tensors, ds.graph.n))
    del emb
    result = PipelineResult(
        dataset=ds, labels=bundle.labels, batch=batch, spec=spec,
        bundle=bundle, partition=report, tensors=tensors, gnn=gnn,
        params=params, classifier=classifier, embeddings=pooled,
        predictions=np.zeros(0, np.int32), timings={})
    return _finish(cfg, stage, result)
