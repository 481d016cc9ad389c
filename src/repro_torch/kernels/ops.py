"""Dispatch layer over the kernels.

A CPU tensor goes to the kernel's plain PyTorch version; a CUDA tensor
goes to the hand-written CUDA kernel, which launches or raises — there is
no fallback from the card to the plain version.

``flash_decode`` (kernel D) is the LM's decode attention over a KV cache.
The sync and stale modes' halo exchange (:mod:`.exchange`) runs kernel A in
its backward; ``exchange_backward`` counts those launches, and
``exchange_rank_backward`` those of a rank's backward when one process
holds each partition.

The graph kernels read a CSR over destination rows. :func:`to_csr` builds it
from an arc list on the arcs' own device: it checks on the device that
``edge_dst`` is sorted and stable-sorts ``(dst, src, w)`` when it is not
(the padding contract lets weight-0 arcs point at any in-range row, so a
caller may hand over unsorted arcs), then takes ``row_ptr`` with
``searchsorted``. It also builds the reversed arcs the backward passes
read (the same arcs sorted stably by source, with their own row offsets),
so a graph's CSR is built once and serves every layer of every epoch.

``csr_aggregate`` and ``fused_gcn_layer`` dispatch on a
:class:`repro_torch.kernels.autotune.KernelConfig` (None: the fallback of
the tensors' device), as the reference's ``ops`` does on its strategies:
``"cuda_fused"`` is kernel B, ``"cuda"`` kernel A then ``torch.matmul``,
``"torch"`` the plain versions, which a CUDA tensor never takes (it
raises ``ValueError``). On a CPU tensor every strategy is its plain
composition. They go through the kernels'
``autograd.Function``s when autograd records (a tensor they take requires
a gradient); otherwise they call the forward directly, so inference writes
no aggregate and saves nothing. The arc weights they differentiate are
``csr.weight``: ``to_csr`` gathers them with a differentiable index, so a
gradient reaches the caller's weights in the caller's arc order.
"""
from __future__ import annotations

from types import ModuleType
from typing import Dict, NamedTuple, Optional, Tuple

import torch

from . import autotune as _autotune
from . import csr_aggregate as _agg
from . import edge_dot as _edge_dot
from . import exchange as _exchange
from . import flash_decode as _flash
from . import fused_layer as _fused
from .flash_decode import flash_decode

__all__ = ["Csr", "to_csr", "csr_aggregate", "fused_gcn_layer",
           "flash_decode", "inv_degree", "COUNTERS", "launch_counts",
           "reset_launch_counts"]


class Csr(NamedTuple):
    """Arcs sorted (stably) by destination, with row offsets, and the same
    arcs reversed: sorted (stably) by source, with source-row offsets. The
    reversed arcs are None on a forward-only CSR (the serving path's star
    graphs), which no backward pass reads."""
    src: torch.Tensor           # [E] int32
    dst: torch.Tensor           # [E] int32, non-decreasing
    weight: torch.Tensor        # [E] f32
    row_ptr: torch.Tensor       # [N+1] int32
    num_nodes: int
    rev_perm: Optional[torch.Tensor] = None     # [E] int64: reversed arc i
                                                # is arc rev_perm[i]
    rev_src: Optional[torch.Tensor] = None      # [E] int32, dst[rev_perm]
    rev_dst: Optional[torch.Tensor] = None      # [E] int32, src[rev_perm],
                                                # non-decreasing
    rev_row_ptr: Optional[torch.Tensor] = None  # [N+1] int32, rows of
                                                # src[rev_perm]


def to_csr(edge_src: torch.Tensor, edge_dst: torch.Tensor,
           edge_weight: torch.Tensor, num_nodes: int) -> Csr:
    """Build the CSR of an arc list (see module docstring).

    Raises ``ValueError`` for mismatched lengths or out-of-range ids: a
    kernel would read out of bounds on them.
    """
    if not (edge_src.dim() == edge_dst.dim() == edge_weight.dim() == 1) or \
            not (edge_src.shape == edge_dst.shape == edge_weight.shape):
        raise ValueError(
            f"edge_src/edge_dst/edge_weight must be 1-D of one length, got "
            f"{tuple(edge_src.shape)}, {tuple(edge_dst.shape)}, "
            f"{tuple(edge_weight.shape)}")
    device = edge_dst.device
    src = edge_src.to(device=device, dtype=torch.int32).contiguous()
    dst = edge_dst.to(dtype=torch.int32).contiguous()
    w = edge_weight.to(device=device, dtype=torch.float32).contiguous()
    if dst.numel():
        flags = torch.stack([
            (dst[1:] >= dst[:-1]).all(),
            (dst.min() >= 0) & (dst.max() < num_nodes),
            (src.min() >= 0) & (src.max() < num_nodes)])
        is_sorted, dst_ok, src_ok = flags.tolist()      # one host read
        if not (dst_ok and src_ok):
            raise ValueError(f"arc endpoints must lie in [0, {num_nodes})")
        if not is_sorted:
            order = torch.sort(dst, stable=True).indices
            src, dst, w = src[order], dst[order], w[order]
    rows = torch.arange(num_nodes + 1, dtype=torch.int32, device=device)
    row_ptr = torch.searchsorted(dst, rows, out_int32=True)
    rev_sorted, rev_perm = torch.sort(src, stable=True)
    return Csr(src=src, dst=dst, weight=w, row_ptr=row_ptr,
               num_nodes=int(num_nodes), rev_perm=rev_perm,
               rev_src=dst.index_select(0, rev_perm), rev_dst=rev_sorted,
               rev_row_ptr=torch.searchsorted(rev_sorted, rows,
                                              out_int32=True))


def _check_rows(h: torch.Tensor, csr: Csr) -> None:
    if h.dim() != 2 or h.shape[0] != csr.num_nodes:
        raise ValueError(f"h must be [{csr.num_nodes}, F], got "
                         f"{tuple(h.shape)}")


def _records_grad(*tensors: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def _resolve(config: Optional[_autotune.KernelConfig],
             h: torch.Tensor) -> _autotune.KernelConfig:
    """``config``, or the fallback of ``h``'s device; a CUDA tensor under
    the ``"torch"`` strategy raises (the card has no plain path)."""
    if config is None:
        return _autotune.fallback_config(h.device)
    if config.strategy == "torch" and h.device.type == "cuda":
        raise ValueError("the 'torch' strategy (the plain versions) does "
                         "not run on CUDA tensors; the card runs the "
                         "kernels ('cuda_fused' or 'cuda')")
    return config


def csr_aggregate(h: torch.Tensor, csr: Csr,
                  inv_scale: Optional[torch.Tensor] = None,
                  config: Optional[_autotune.KernelConfig] = None
                  ) -> torch.Tensor:
    """``out[d] = inv[d] * Σ_{dst[e]=d} w[e]·h[src[e]]`` — kernel A, split
    by ``config.items`` under both CUDA strategies.

    Differentiable in ``h`` and ``csr.weight``."""
    _check_rows(h, csr)
    config = _resolve(config, h)
    if _records_grad(h, csr.weight):
        return _agg.AggregateFn.apply(h, csr.weight, csr, inv_scale, config)
    return _agg.aggregate(h, csr.src, csr.dst, csr.row_ptr, csr.weight,
                          inv_scale, config.items)


def fused_gcn_layer(h: torch.Tensor, csr: Csr,
                    inv_scale: Optional[torch.Tensor], w: torch.Tensor,
                    b: torch.Tensor, activate: bool = True,
                    config: Optional[_autotune.KernelConfig] = None
                    ) -> torch.Tensor:
    """``act((inv ⊙ A·h) @ w + b)``: kernel B under ``"cuda_fused"`` (and
    its plain version under ``"torch"``), kernel A then ``torch.matmul``
    under ``"cuda"``.

    Differentiable in ``h``, ``csr.weight``, ``w`` and ``b``."""
    _check_rows(h, csr)
    config = _resolve(config, h)
    if config.strategy == "cuda":
        # the reference's "pallas": the product outside the kernel, as XLA
        # computes it there; f32 in full (TF32 stays off, PyTorch's default
        # for matmul)
        agg = csr_aggregate(h, csr, inv_scale, config)
        z = agg @ w.float() + b.float()[None, :]
        return torch.relu(z) if activate else z
    if _records_grad(h, csr.weight, w, b):
        return _fused.FusedLayerFn.apply(h, csr.weight, w, b, csr, inv_scale,
                                         activate, config)
    return _fused.fused(h, csr, csr.weight, inv_scale, w, b, activate,
                        config=config)[0]


#: Every counter a kernel wrapper moves, by name: ``(module, attribute)``.
#: :func:`launch_counts` reads them, :func:`reset_launch_counts` zeroes
#: them, and a captured step (:mod:`repro_torch.graphs`) replays them all.
#: ``exchange_calls`` counts halo exchanges (on either device; the trainers
#: read it by epoch), every other entry the launches of a kernel on the
#: card.
COUNTERS: Dict[str, Tuple[ModuleType, str]] = {
    "csr_aggregate": (_agg, "launches"),
    "fused_gcn_layer": (_fused, "launches"),
    "fused_gcn_layer_need_agg": (_fused, "launches_need_agg"),
    "edge_dot": (_edge_dot, "launches"),
    "flash_decode": (_flash, "launches"),
    "exchange_backward": (_exchange, "launches"),
    "exchange_rank_backward": (_exchange, "launches_rank"),
    "exchange_calls": (_exchange, "calls"),
}


def launch_counts() -> Dict[str, int]:
    """Every :data:`COUNTERS` entry since the last
    :func:`reset_launch_counts`."""
    return {k: getattr(m, a) for k, (m, a) in COUNTERS.items()}


def reset_launch_counts() -> None:
    for m, a in COUNTERS.values():
        setattr(m, a, 0)


def inv_degree(in_degree: torch.Tensor) -> torch.Tensor:
    """``1 / max(in_degree, 1)`` in f32: the mean epilogue's scale."""
    return 1.0 / torch.clamp(in_degree.float(), min=1.0)
