"""Per-partition tensors and embedding inference: the stacked partition
tensors with one prebuilt CSR per partition, seeded parameters for the k
replicas, the per-partition forward, pooling of the owned rows into one
table, and the bridge from the reference's parameters.

Layouts match the reference package at these public functions: stacked
parameters with a leading axis k, embeddings ``[k, N_pad, E]``, the pooled
table ``[N, E]``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Tuple, Union

import numpy as np
import torch

from repro_torch.core import NodeDataset, PartitionBatch
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kernels import ops

from .model import GNNConfig, gnn_forward

Params = Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class PartitionTensors:
    """Stacked per-partition tensors on one device, axis 0 = k, and each
    partition's CSR (forward and reversed arcs), built once and shared by
    every layer, epoch and embedding pass."""
    features: torch.Tensor      # [k, N_pad, F] f32, zero on padded rows
    labels: torch.Tensor        # [k, N_pad] int64 or [k, N_pad, T] f32
    train_mask: torch.Tensor    # [k, N_pad] f32 (owned & train & valid)
    edge_src: torch.Tensor      # [k, E_pad] int32
    edge_dst: torch.Tensor      # [k, E_pad] int32, sorted per partition
    edge_weight: torch.Tensor   # [k, E_pad] f32
    in_degree: torch.Tensor     # [k, N_pad] f32
    node_mask: torch.Tensor     # [k, N_pad] f32
    owned_mask: torch.Tensor    # [k, N_pad] bool
    node_ids: torch.Tensor      # [k, N_pad] int64, -1 = padding
    csrs: Tuple[ops.Csr, ...]   # one per partition

    @property
    def k(self) -> int:
        return int(self.features.shape[0])


def gather_partition_tensors(ds: NodeDataset, batch: PartitionBatch,
                             device: DeviceLike = "cuda",
                             only: Union[int, slice, None] = None
                             ) -> PartitionTensors:
    """Gather each partition's node features, labels and training mask,
    move the batch to ``device`` and build every partition's CSR there.

    ``only=p`` gathers partition ``p`` alone (``k`` = 1), for training one
    partition at a time; ``only=slice(lo, hi)`` partitions ``lo..hi-1``
    (one rank's shard)."""
    device = resolve_device(device)
    sel = (slice(None) if only is None else only
           if isinstance(only, slice) else slice(only, only + 1))
    node_ids, node_mask = batch.node_ids[sel], batch.node_mask[sel]
    owned_mask = batch.owned_mask[sel]
    ids = np.maximum(node_ids, 0)
    feats = ds.features[ids] * node_mask[..., None]
    labels = ds.labels[ids]
    train = ds.train_mask[ids] & owned_mask & node_mask

    def dev(x, dtype):
        return torch.as_tensor(np.ascontiguousarray(x)).to(device=device,
                                                           dtype=dtype)
    edge_src = dev(batch.edge_src[sel], torch.int32)
    edge_dst = dev(batch.edge_dst[sel], torch.int32)
    edge_weight = dev(batch.edge_weight[sel], torch.float32)
    return PartitionTensors(
        features=dev(feats, torch.float32),
        labels=dev(labels, torch.float32 if ds.multilabel else torch.int64),
        train_mask=dev(train, torch.float32),
        edge_src=edge_src, edge_dst=edge_dst, edge_weight=edge_weight,
        in_degree=dev(batch.in_degree[sel], torch.float32),
        node_mask=dev(node_mask, torch.float32),
        owned_mask=dev(owned_mask, torch.bool),
        node_ids=dev(node_ids, torch.int64),
        csrs=tuple(ops.to_csr(edge_src[p], edge_dst[p], edge_weight[p],
                              batch.n_pad)
                   for p in range(edge_src.shape[0])))


def init_partition_models(cfg: GNNConfig, num_classes: int, k: int,
                          gen: torch.Generator, device: DeviceLike = "cuda"
                          ) -> Params:
    """k independent GNN + head replicas, stacked on axis 0: He-normal
    weights and zero biases, drawn on the host from ``gen``."""
    def normal(fan_in, *shape):
        return torch.randn((k, *shape), generator=gen) \
            * math.sqrt(2.0 / fan_in)
    dims = cfg.dims
    layers = []
    for f_in, f_out in zip(dims[:-1], dims[1:]):
        if cfg.kind == "gcn":
            layers.append({"w": normal(f_in, f_in, f_out),
                           "b": torch.zeros(k, f_out)})
        else:
            layers.append({"w_self": normal(f_in, f_in, f_out),
                           "w_neigh": normal(f_in, f_in, f_out),
                           "b": torch.zeros(k, f_out)})
    head = {"w": normal(cfg.embed_dim, cfg.embed_dim, num_classes),
            "b": torch.zeros(k, num_classes)}
    return _to_device({"body": {"layers": layers}, "head": head},
                      resolve_device(device))


def _to_device(tree: Any, device: torch.device) -> Any:
    if isinstance(tree, dict):
        return {key: _to_device(v, device) for key, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_to_device(v, device) for v in tree]
    if not isinstance(tree, torch.Tensor):
        tree = torch.tensor(np.asarray(tree))     # copies read-only views
    return tree.to(device=device, dtype=torch.float32)


def params_from_jax(tree: Any, device: DeviceLike = "cuda") -> Any:
    """The reference's parameter tree (nested dicts and lists of numpy
    arrays, e.g. ``init_partition_models``'s stacked ``{"body": {"layers":
    [...]}, "head": {...}}`` or the classifier's ``w1, b1, w2, b2``) as the
    same tree of f32 tensors on ``device``."""
    return _to_device(tree, resolve_device(device))


def partition_params(params: Params, p: int) -> Params:
    """Partition ``p``'s slice of stacked parameters."""
    if isinstance(params, dict):
        return {key: partition_params(v, p) for key, v in params.items()}
    if isinstance(params, list):
        return [partition_params(v, p) for v in params]
    return params[p]


@torch.no_grad()
def compute_embeddings(params: Params, cfg: GNNConfig,
                       tensors: PartitionTensors) -> torch.Tensor:
    """Every partition's GNN body on its own subgraph: ``[k, N_pad, E]``,
    a loop over the k partitions on their prebuilt CSRs."""
    k, n_pad = tensors.k, tensors.features.shape[1]
    out = torch.empty((k, n_pad, cfg.embed_dim), dtype=torch.float32,
                      device=tensors.features.device)
    for p in range(k):
        out[p] = gnn_forward(partition_params(params["body"], p), cfg,
                             tensors.features[p], tensors.csrs[p],
                             tensors.in_degree[p],
                             node_mask=tensors.node_mask[p])
    return out


def pool_embeddings(emb: torch.Tensor, tensors: PartitionTensors,
                    n: int) -> torch.Tensor:
    """Scatter owned-node embeddings back into one ``[n, E]`` table (only
    ``tensors.owned_mask`` and ``tensors.node_ids`` are read)."""
    out = torch.zeros((n, emb.shape[-1]), dtype=torch.float32,
                      device=emb.device)
    for p in range(emb.shape[0]):
        owned = tensors.owned_mask[p]
        out[tensors.node_ids[p][owned]] = emb[p][owned]
    return out
