"""GCN and GraphSAGE layers on a partition subgraph's CSR.

The aggregation runs through :mod:`repro_torch.kernels.ops` under the
:class:`~repro_torch.kernels.autotune.KernelConfig` that
:func:`~repro_torch.kernels.autotune.get_config` resolves for the call's
shape and device, as the reference's ``_kernel_config`` does: on the card
``gcn_layer`` is one call of the fused-layer kernel (kernel B) under
``"cuda_fused"``, the untuned fallback, or kernel A and ``torch.matmul``
under ``"cuda"``, and ``aggregate_mean`` kernel A; on the CPU both take
the kernels' plain PyTorch versions. The reference's ``use_kernel`` has no
counterpart: the card always runs the kernels. A resolution is a lookup
in the autotuner's memo (no file read after the first, no device
synchronisation, no tensor read on the host), as the training loop is
host-bound. Both are differentiable through the kernels'
``autograd.Function``s (backward on kernel A over the reversed arcs and
kernel C); SAGE's self term and relu are plain autograd, as in the
reference.
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.kernels import ops
from repro_torch.kernels.autotune import KernelConfig, get_config

Params = Dict[str, torch.Tensor]


def _kernel_config(h: torch.Tensor, csr: ops.Csr) -> KernelConfig:
    return get_config(h.shape[0], csr.src.shape[0], h.shape[1], h.device)


def aggregate_mean(h: torch.Tensor, csr: ops.Csr,
                   in_degree: torch.Tensor) -> torch.Tensor:
    """Weighted mean over in-neighbours, ``[N, F] -> [N, F]``.

    Padding arcs carry weight 0 and may point at any in-range row."""
    return ops.csr_aggregate(h, csr, ops.inv_degree(in_degree),
                             config=_kernel_config(h, csr))


def gcn_layer(params: Params, h: torch.Tensor, csr: ops.Csr,
              in_degree: torch.Tensor, activate: bool = True
              ) -> torch.Tensor:
    """Paper eq. (1): ``h_v = relu(mean_{u in N(v)} h_u @ W + b)``
    (aggregate-then-transform)."""
    return ops.fused_gcn_layer(h, csr, ops.inv_degree(in_degree),
                               params["w"], params["b"], activate=activate,
                               config=_kernel_config(h, csr))


def sage_layer(params: Params, h: torch.Tensor, csr: ops.Csr,
               in_degree: torch.Tensor, activate: bool = True
               ) -> torch.Tensor:
    """Paper eq. (2) as ``h @ W_self + mean(h_u) @ W_neigh + b``; the
    neighbour half is the fused kernel with the activation deferred."""
    neigh = ops.fused_gcn_layer(h, csr, ops.inv_degree(in_degree),
                                params["w_neigh"],
                                torch.zeros_like(params["b"]),
                                activate=False,
                                config=_kernel_config(h, csr))
    out = h @ params["w_self"] + neigh + params["b"]
    return torch.relu(out) if activate else out
