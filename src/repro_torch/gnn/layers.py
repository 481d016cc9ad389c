"""GCN and GraphSAGE layers on a partition subgraph's CSR.

The aggregation runs through :mod:`repro_torch.kernels.ops`: on the card
``gcn_layer`` is one launch of the fused-layer kernel (kernel B) and
``aggregate_mean`` one launch of the aggregation kernel (kernel A); on the
CPU both take the kernels' plain PyTorch versions. Both are differentiable
through the kernels' ``autograd.Function``s (backward on kernel A over the
reversed arcs and kernel C); SAGE's self term and relu are plain autograd,
as in the reference.
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.kernels import ops

Params = Dict[str, torch.Tensor]


def aggregate_mean(h: torch.Tensor, csr: ops.Csr,
                   in_degree: torch.Tensor) -> torch.Tensor:
    """Weighted mean over in-neighbours, ``[N, F] -> [N, F]``.

    Padding arcs carry weight 0 and may point at any in-range row."""
    return ops.csr_aggregate(h, csr, ops.inv_degree(in_degree))


def gcn_layer(params: Params, h: torch.Tensor, csr: ops.Csr,
              in_degree: torch.Tensor, activate: bool = True
              ) -> torch.Tensor:
    """Paper eq. (1): ``h_v = relu(mean_{u in N(v)} h_u @ W + b)``
    (aggregate-then-transform)."""
    return ops.fused_gcn_layer(h, csr, ops.inv_degree(in_degree),
                               params["w"], params["b"], activate=activate)


def sage_layer(params: Params, h: torch.Tensor, csr: ops.Csr,
               in_degree: torch.Tensor, activate: bool = True
               ) -> torch.Tensor:
    """Paper eq. (2) as ``h @ W_self + mean(h_u) @ W_neigh + b``; the
    neighbour half is the fused kernel with the activation deferred."""
    neigh = ops.fused_gcn_layer(h, csr, ops.inv_degree(in_degree),
                                params["w_neigh"],
                                torch.zeros_like(params["b"]),
                                activate=False)
    out = h @ params["w_self"] + neigh + params["b"]
    return torch.relu(out) if activate else out
