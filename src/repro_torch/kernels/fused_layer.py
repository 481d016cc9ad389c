"""Kernel B: one GCN layer — CSR mean aggregation, dense transform, bias
and relu in one call.

``out = act((inv ⊙ Σ_e w[e]·h[src[e]]→dst[e]) @ W + b)``. The call is
kernel A (:func:`repro_torch.kernels.csr_aggregate.launch_into`, its
merge-path gather and partial-sum pass) writing the aggregate, then the
product of ``csrc/fused_layer.cu`` (f32 on the CUDA cores, k in order, so
that it rounds as the CPU path's product does, on a row tile of 32, 64 or
128 rows a block that changes no bit of the result) with bias and relu.
A :class:`repro_torch.kernels.autotune.KernelConfig` gives the row tile
(``node_tile``) and the gather's split (``items``). Its
plain version is
:func:`repro_torch.kernels.ref.fused_gcn_reference` (re-exported here as
``plain``). The aggregate is returned only when ``need_agg`` is set (a
backward pass needs it for dW; inference does not, and it goes to scratch
memory). :func:`fused`
dispatches: CPU tensors go to the plain version, CUDA tensors to
:func:`launch`.

:class:`FusedLayerFn` is the reference's custom VJP (``_fused_diff``): its
forward launches the kernel with ``need_agg``; its backward takes
``gz = g·(out > 0)``, ``db = Σgz``, ``dW = aggᵀgz`` and ``da = gz Wᵀ``
with ``torch.matmul`` (the reference leaves them to XLA), ``dh`` from
kernel A over the reversed arcs and ``dw`` from kernel C.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from . import _build
from ._build import check_tensor
from .csr_aggregate import plain as aggregate_plain
from .csr_aggregate import launch_into as aggregate_into
from .csr_aggregate import transpose
from .edge_dot import edge_dot
from .ref import fused_gcn_reference as plain
from .ref import gcn_epilogue

__all__ = ["FusedLayerFn", "fused", "launch", "plain", "launches",
           "launches_need_agg", "NODE_TILES", "block_threads", "smem_bytes"]

#: The product's row tiles a block (the template instances of
#: ``csrc/fused_layer.cu``), its k chunk and its output columns a block.
NODE_TILES = (32, 64, 128)
_BK, _BN = 32, 128

#: Kernel calls since the last reset (see ``ops.reset_launch_counts``),
#: one per layer call (its aggregation does not count as a kernel A call),
#: and those of them that returned the aggregate (``need_agg``).
launches = 0
launches_need_agg = 0

_lib_cache = None


def block_threads(node_tile: int) -> int:
    """The product's threads a block: 16 column groups x node_tile / 4 row
    groups (each thread owns 4 rows x 8 columns)."""
    return 16 * (node_tile // 4)


def smem_bytes(node_tile: int) -> int:
    """The product's dynamic shared memory: two buffers of an agg chunk
    [node_tile, 32 + 4] and a W chunk [32, 128], f32."""
    return 2 * (node_tile * (_BK + 4) + _BK * _BN) * 4


def _lib():
    global _lib_cache
    if _lib_cache is None:
        lib = _build.load("fused_layer")
        lib.fused_gcn_product_f32.argtypes = [ctypes.c_void_p] * 4 + [
            ctypes.c_int] * 5 + [ctypes.c_void_p]
        lib.fused_gcn_product_f32.restype = ctypes.c_int
        lib.fused_gcn_error.argtypes = [ctypes.c_int]
        lib.fused_gcn_error.restype = ctypes.c_char_p
        _lib_cache = lib
    return _lib_cache


def launch(h: torch.Tensor, src: torch.Tensor, row_ptr: torch.Tensor,
           weight: torch.Tensor, inv_scale: Optional[torch.Tensor],
           w: torch.Tensor, b: torch.Tensor, activate: bool = True,
           need_agg: bool = False, node_tile: int = 64, items: int = 0
           ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Run the CUDA kernel; returns ``(out [N, FO], agg [N, F] or None)``.

    ``node_tile`` is the product's rows a block (32, 64 or 128), ``items``
    the gather's split (0: the shape rule)."""
    global launches, launches_need_agg
    device = h.device
    if device.type != "cuda":
        raise ValueError(f"fused_gcn_layer kernel needs CUDA tensors, "
                         f"got {device}")
    if node_tile not in NODE_TILES:
        raise ValueError(f"node_tile must be one of {NODE_TILES}, "
                         f"got {node_tile}")
    if h.dim() != 2 or w.dim() != 2:
        raise ValueError(f"h and w must be 2-D, got {tuple(h.shape)} and "
                         f"{tuple(w.shape)}")
    n, f = h.shape
    fo = w.shape[1]
    check_tensor("w", w, torch.float32, (f, fo), device)
    check_tensor("b", b, torch.float32, (fo,), device)
    agg = torch.empty((n, f), dtype=torch.float32, device=device)
    aggregate_into(agg, h, src, row_ptr, weight, inv_scale, items)
    out = torch.empty((n, fo), dtype=torch.float32, device=device)
    lib = _lib()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = lib.fused_gcn_product_f32(
            agg.data_ptr(), w.data_ptr(), b.data_ptr(), out.data_ptr(), n,
            f, fo, int(bool(activate)), node_tile, stream)
    if err != 0:
        raise RuntimeError("fused_gcn_layer kernel launch failed: "
                           + lib.fused_gcn_error(err).decode())
    launches += 1
    launches_need_agg += int(need_agg)
    return out, agg if need_agg else None


def fused(h: torch.Tensor, csr, weight: torch.Tensor,
          inv_scale: Optional[torch.Tensor], w: torch.Tensor, b: torch.Tensor,
          activate: bool = True, need_agg: bool = False, config=None
          ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """The plain version for a CPU tensor, the kernel (at ``config``'s row
    tile and split; None: 64 and the shape rule) for a CUDA one; returns
    ``(out, agg or None)`` over ``csr``'s arcs with ``weight``."""
    if h.device.type == "cpu":
        agg = aggregate_plain(h, csr.src, csr.dst, weight, h.shape[0],
                              inv_scale)
        return gcn_epilogue(agg, w, b, activate), agg if need_agg else None
    knobs = {} if config is None else dict(node_tile=config.node_tile,
                                           items=config.items)
    return launch(h, csr.src, csr.row_ptr, weight, inv_scale, w, b,
                  activate=activate, need_agg=need_agg, **knobs)


class FusedLayerFn(torch.autograd.Function):
    """``out = act((inv ⊙ A·h) @ W + b)`` (kernel B) with the reference's
    VJP. ``weight`` is the CSR-ordered arc weight, passed on its own so
    autograd sees it; ``csr`` and ``inv_scale`` get no gradient. ``config``
    (the resolved ``KernelConfig``, kept on ``ctx``) gives the forward's
    row tile and split and the backward's transposed split."""

    @staticmethod
    def forward(ctx, h, weight, w, b, csr, inv_scale, activate, config):
        out, agg = fused(h, csr, weight, inv_scale, w, b, activate,
                         need_agg=True, config=config)
        ctx.csr, ctx.activate, ctx.config = csr, activate, config
        ctx.save_for_backward(h, weight, w, inv_scale, agg, out)
        return out

    @staticmethod
    def backward(ctx, g):
        h, weight, w, inv, agg, out = ctx.saved_tensors
        csr = ctx.csr
        need_h, need_weight, need_w, need_b = ctx.needs_input_grad[:4]
        gz = g.float()
        if ctx.activate:
            gz = gz * (out > 0.0)     # relu's gradient is 0 at z == 0
        db = gz.sum(dim=0) if need_b else None
        dw_mat = agg.t() @ gz if need_w else None
        dh = dw_arc = None
        if need_h or need_weight:
            da = (gz @ w.float().t()).contiguous()
            if need_h:
                dh = transpose(da, csr, weight, inv, ctx.config.items)
            if need_weight:
                dw_arc = edge_dot(h, da, csr.src, csr.dst, inv)
        return dh, dw_arc, dw_mat, db, None, None, None, None
