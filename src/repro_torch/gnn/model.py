"""Multi-layer GNN body (GCN / GraphSAGE), per-partition head, and the MLP
classifier on pooled embeddings — inference forwards and seeded inits.

Parameters are plain dictionaries of tensors laid out as in the reference
package, so :func:`repro_torch.gnn.infer.params_from_jax` can carry its
trained or initial parameters across unchanged.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional

import torch

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kernels import ops

from .layers import gcn_layer, sage_layer

Params = Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class GNNConfig:
    kind: str = "gcn"              # "gcn" | "sage"
    feature_dim: int = 128
    hidden_dim: int = 256
    embed_dim: int = 256           # output embedding size
    num_layers: int = 3

    def __post_init__(self):
        if self.kind not in ("gcn", "sage"):
            raise ValueError(f"kind must be gcn|sage, got {self.kind!r}")
        if self.num_layers < 1:
            raise ValueError(f"num_layers must be >= 1, "
                             f"got {self.num_layers}")

    @property
    def dims(self):
        return ([self.feature_dim] + [self.hidden_dim] * (self.num_layers - 1)
                + [self.embed_dim])


def gnn_forward(params: Params, cfg: GNNConfig, features: torch.Tensor,
                csr: ops.Csr, in_degree: torch.Tensor,
                node_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Run the GNN body; returns ``[N, embed_dim]`` embeddings. Padded rows
    (``node_mask == 0``) are zeroed before and after every layer."""
    layer = gcn_layer if cfg.kind == "gcn" else sage_layer
    h = features
    if node_mask is not None:
        h = h * node_mask[:, None]
    n_layers = len(params["layers"])
    for i, lp in enumerate(params["layers"]):
        h = layer(lp, h, csr, in_degree, activate=i < n_layers - 1)
        if node_mask is not None:
            h = h * node_mask[:, None]
    return h


def head_logits(head: Params, emb: torch.Tensor) -> torch.Tensor:
    """Per-partition linear head: ``emb @ w + b``."""
    return emb @ head["w"] + head["b"]


def mlp_forward(params: Params, x: torch.Tensor) -> torch.Tensor:
    """Two-layer classifier MLP on pooled embeddings."""
    h = torch.relu(x @ params["w1"] + params["b1"])
    return h @ params["w2"] + params["b2"]


def _normal(gen: torch.Generator, shape, fan_in: int) -> torch.Tensor:
    return torch.randn(shape, generator=gen) * math.sqrt(2.0 / fan_in)


def init_mlp(gen: torch.Generator, in_dim: int, hidden: int, out_dim: int,
             device: DeviceLike = "cuda") -> Params:
    """He-normal weights, zero biases, drawn on the host from ``gen`` (so
    the CPU and the card get the same numbers)."""
    p = {"w1": _normal(gen, (in_dim, hidden), in_dim),
         "b1": torch.zeros(hidden),
         "w2": _normal(gen, (hidden, out_dim), hidden),
         "b2": torch.zeros(out_dim)}
    device = resolve_device(device)
    return {k: v.to(device) for k, v in p.items()}
