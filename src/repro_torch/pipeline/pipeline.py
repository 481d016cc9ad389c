"""The inference pipeline (the serving path's offline half).

    dataset -> Leiden-Fusion partition -> per-partition assembly
    -> GNN forward per partition -> pooled embedding table
    -> classifier forward (the offline answer key) -> serving bundle

Parameters are seeded (``torch.Generator``) or handed in, for example the
reference's carried across with ``params_from_jax``; training is not part
of this package yet.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch

from repro_torch.core import (LeidenFusionConfig, NodeDataset,
                              PartitionBatch, build_partition_batch,
                              partition)
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.gnn.infer import (PartitionTensors, compute_embeddings,
                                   gather_partition_tensors,
                                   init_partition_models, pool_embeddings)
from repro_torch.gnn.model import GNNConfig, init_mlp

from .datasets import get_dataset

__all__ = ["PipelineConfig", "InferenceResult", "run_inference"]


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    """One inference run. Defaults are the reference pipeline's."""
    dataset: str = "arxiv-like"
    k: int = 8
    seed: int = 0
    scheme: str = "repli"           # "inner" | "repli"
    model: str = "gcn"              # "gcn" | "sage"
    hidden_dim: int = 128
    embed_dim: int = 128
    num_layers: int = 3
    classifier_hidden: int = 256
    partitioner: LeidenFusionConfig = LeidenFusionConfig()
    serving_dir: Optional[str] = None   # export a serving bundle here
    dataset_kwargs: Mapping[str, Any] = dataclasses.field(
        default_factory=dict)


@dataclasses.dataclass
class InferenceResult:
    """What one run produced, on the run's device where it is a tensor."""
    dataset: NodeDataset
    labels: np.ndarray              # [n] partition of every node
    batch: PartitionBatch
    tensors: PartitionTensors
    gnn: GNNConfig
    params: Dict[str, Any]          # stacked k replicas (body + head)
    classifier: Dict[str, torch.Tensor]
    embeddings: torch.Tensor        # [n, E] pooled table
    predictions: np.ndarray         # [n] offline answer key
    timings: Dict[str, float]
    serving_path: Optional[str] = None


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_inference(cfg: PipelineConfig, device: DeviceLike = "cuda",
                  ds: Optional[NodeDataset] = None,
                  params: Optional[Dict[str, Any]] = None,
                  classifier: Optional[Dict[str, torch.Tensor]] = None
                  ) -> InferenceResult:
    """Run the pipeline; ``params``/``classifier`` default to seeded ones.

    Each stage's wall time (ending in a device synchronize) lands in
    ``timings``.
    """
    from repro_torch.serving.store import classify, export_from_pipeline
    device = resolve_device(device)
    if cfg.k < 1:
        raise ValueError(f"k must be >= 1, got {cfg.k}")
    timings: Dict[str, float] = {}

    def stage(name, fn):
        t0 = time.perf_counter()
        out = fn()
        _sync(device)
        timings[name] = time.perf_counter() - t0
        return out

    if ds is None:
        ds = stage("dataset", lambda: get_dataset(cfg.dataset,
                                                  **dict(cfg.dataset_kwargs)))
    labels = stage("partition", lambda: partition(
        ds.graph, cfg.k, seed=cfg.seed, cfg=cfg.partitioner))
    batch = stage("assemble", lambda: build_partition_batch(
        ds.graph, labels, scheme=cfg.scheme))
    tensors = stage("to_device",
                    lambda: gather_partition_tensors(ds, batch, device))
    gnn = GNNConfig(kind=cfg.model, feature_dim=int(ds.features.shape[1]),
                    hidden_dim=cfg.hidden_dim, embed_dim=cfg.embed_dim,
                    num_layers=cfg.num_layers)
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
    predictions = stage("classify", lambda: classify(
        classifier, pooled).argmax(-1).cpu().numpy().astype(np.int32))
    result = InferenceResult(
        dataset=ds, labels=labels, batch=batch, tensors=tensors, gnn=gnn,
        params=params, classifier=classifier, embeddings=pooled,
        predictions=predictions, timings=timings)
    if cfg.serving_dir:
        result.serving_path = stage("export", lambda: export_from_pipeline(
            cfg.serving_dir, result, cfg.partitioner))
    return result
