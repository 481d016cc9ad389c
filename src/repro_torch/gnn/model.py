"""Multi-layer GNN body (GCN / GraphSAGE) with dropout, per-partition head,
the MLP classifier on pooled embeddings, seeded inits, and the two losses.

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
    dropout: float = 0.5           # applied only when a generator is given

    def __post_init__(self):
        if self.kind not in ("gcn", "sage"):
            raise ValueError(f"kind must be gcn|sage, got {self.kind!r}")
        if self.num_layers < 1:
            raise ValueError(f"num_layers must be >= 1, "
                             f"got {self.num_layers}")
        if not 0.0 <= self.dropout < 1.0:
            raise ValueError(f"dropout must be in [0, 1), "
                             f"got {self.dropout}")

    @property
    def dims(self):
        return ([self.feature_dim] + [self.hidden_dim] * (self.num_layers - 1)
                + [self.embed_dim])


def gnn_forward(params: Params, cfg: GNNConfig, features: torch.Tensor,
                csr: ops.Csr, in_degree: torch.Tensor,
                node_mask: Optional[torch.Tensor] = None,
                dropout_gen: Optional[torch.Generator] = None
                ) -> torch.Tensor:
    """Run the GNN body; returns ``[N, embed_dim]`` embeddings. Padded rows
    (``node_mask == 0``) are zeroed before and after every layer.

    With ``dropout_gen`` (a generator on the features' device) and
    ``cfg.dropout > 0``, every layer but the last is followed by dropout:
    each value is kept with probability ``1 - p`` and scaled by
    ``1 / (1 - p)``. The masks are drawn from ``dropout_gen``, so they are
    not the reference's threefry bits."""
    layer = gcn_layer if cfg.kind == "gcn" else sage_layer
    h = features
    if node_mask is not None:
        h = h * node_mask[:, None]
    n_layers = len(params["layers"])
    for i, lp in enumerate(params["layers"]):
        last = i == n_layers - 1
        h = layer(lp, h, csr, in_degree, activate=not last)
        if node_mask is not None:
            h = h * node_mask[:, None]
        if dropout_gen is not None and cfg.dropout > 0 and not last:
            h = dropout(h, cfg.dropout, dropout_gen)
    return h


def dropout(h: torch.Tensor, p: float, gen: torch.Generator) -> torch.Tensor:
    """Keep each value with probability ``1 - p``, scaled by ``1/(1-p)``."""
    keep = torch.rand(h.shape, generator=gen, device=h.device) < 1.0 - p
    return torch.where(keep, h / (1.0 - p), 0.0)


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


def softmax_xent(logits: torch.Tensor, labels: torch.Tensor,
                 mask: torch.Tensor) -> torch.Tensor:
    """Mean cross-entropy over the rows where ``mask`` is set."""
    logp = torch.log_softmax(logits, dim=-1)
    nll = -logp.gather(-1, labels.long()[..., None])[..., 0]
    return (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)


def sigmoid_bce(logits: torch.Tensor, targets: torch.Tensor,
                mask: torch.Tensor) -> torch.Tensor:
    """Mean (over tasks, then masked rows) binary cross-entropy on logits,
    in the numerically stable form."""
    per = (torch.clamp(logits, min=0) - logits * targets
           + torch.log1p(torch.exp(-logits.abs())))
    per = per.mean(dim=-1)
    return (per * mask).sum() / torch.clamp(mask.sum(), min=1.0)
