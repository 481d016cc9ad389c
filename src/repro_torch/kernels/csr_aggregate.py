"""Kernel A: CSR neighbour aggregation with a fused mean epilogue.

``out[d] = inv[d] * sum_{e in row d} w[e] * h[src[e]]`` over a CSR whose
rows are the destination nodes. The kernel is ``csrc/csr_aggregate.cu``
(two launches: a merge-path gather in which each warp walks at most
``split(n, e).items`` merged row ends and arcs, then a pass that adds the
partial sums of rows spanning warps; :func:`split` sizes both from the
shapes alone, or from the autotuner's ``items``, so no launch reads
anything back to the host);
its plain version is :func:`repro_torch.kernels.ref.csr_aggregate_ref`
(re-exported here as ``plain``). :func:`aggregate` dispatches: CPU tensors
go to the plain version, CUDA tensors to :func:`launch`.

:class:`AggregateFn` is the reference's custom VJP (``_aggregate_diff``):
``dh`` is this same kernel over the reversed arcs (:func:`transpose`),
``dw`` is kernel C (:mod:`repro_torch.kernels.edge_dot`); ``inv_scale``
and the arcs get no gradient.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional, Tuple

import torch

from . import _build
from ._build import check_tensor
from .edge_dot import edge_dot
from .ref import csr_aggregate_ref as plain

__all__ = ["AggregateFn", "Split", "aggregate", "transpose", "launch",
           "launch_into", "plain", "launches", "split", "scratch", "ITEMS"]

#: Kernel calls since the last reset (see ``ops.reset_launch_counts``).
launches = 0

#: The gather's warps: enough to fill the card's 132 SMs (16 warps each)
#: with one wave, and at least ``MIN_ITEMS``, at most ``MAX_ITEMS`` merged
#: items per warp. ``MAX_ITEMS`` bounds the arcs any warp walks.
TARGET_WARPS = 2048
MIN_ITEMS = 16
MAX_ITEMS = 128
#: The tuned splits the autotuner sweeps (``KernelConfig.items``; 0 there
#: is the rule above). ``MAX_ITEMS`` is ``csr_rows.cuh``'s ``kMaxItems``.
ITEMS = (16, 32, 64, MAX_ITEMS)

_lib_cache = None


class Split(NamedTuple):
    """The merge-path work split: ``items`` merged row ends and arcs per
    warp (K), and ``warps`` = ceil((n + e) / K), one partial slot each."""
    items: int
    warps: int


def split(n: int, e: int, items: int = 0) -> Split:
    """The work split of an ``n``-row, ``e``-arc CSR: ``items`` merged items
    per warp (a tuned ``KernelConfig.items``), or with 0 the shape rule."""
    total = n + e
    if items == 0:
        items = min(MAX_ITEMS, max(MIN_ITEMS, -(-total // TARGET_WARPS)))
    elif not 1 <= items <= MAX_ITEMS:
        raise ValueError(f"items must be 0 or in [1, {MAX_ITEMS}], "
                         f"got {items}")
    return Split(items, -(-total // items))


def scratch(sp: Split, f: int, device: torch.device
            ) -> Tuple[torch.Tensor, Tuple[int, int, int]]:
    """One allocation for the partial sums of the rows the split cuts, and
    the addresses in it of ``tail`` [warps, f] f32, ``head`` [warps, f] f32
    and ``head_row`` [warps] int32 (the tensor must outlive the launch)."""
    buf = torch.empty(sp.warps * (2 * f + 1), dtype=torch.float32,
                      device=device)
    tail = buf.data_ptr()
    part = 4 * sp.warps * f
    return buf, (tail, tail + part, tail + 2 * part)


def _lib():
    global _lib_cache
    if _lib_cache is None:
        lib = _build.load("csr_aggregate")
        lib.csr_aggregate_f32.argtypes = [ctypes.c_void_p] * 9 + [
            ctypes.c_int] * 5 + [ctypes.c_void_p]
        lib.csr_aggregate_f32.restype = ctypes.c_int
        lib.csr_aggregate_error.argtypes = [ctypes.c_int]
        lib.csr_aggregate_error.restype = ctypes.c_char_p
        _lib_cache = lib
    return _lib_cache


def launch(h: torch.Tensor, src: torch.Tensor, row_ptr: torch.Tensor,
           weight: torch.Tensor, inv_scale: Optional[torch.Tensor] = None,
           items: int = 0, rows: Optional[int] = None) -> torch.Tensor:
    """Run the CUDA kernel; returns ``out`` [N, F] f32.

    ``src``/``weight`` are the arcs sorted by destination and ``row_ptr``
    [N+1] int32 their row offsets (``ops.to_csr`` builds all three);
    ``items`` is the split's items per warp (0: :func:`split`'s rule).
    N is ``rows``, or ``h``'s rows when None: a CSR whose arcs all end in
    its first ``rows`` rows (``row_ptr[:rows + 1]``) writes only those.
    """
    global launches
    n = h.shape[0] if rows is None else rows
    out = torch.empty((n, h.shape[1]), dtype=torch.float32, device=h.device)
    launch_into(out, h, src, row_ptr, weight, inv_scale, items)
    launches += 1
    return out


def launch_into(out: torch.Tensor, h: torch.Tensor, src: torch.Tensor,
                row_ptr: torch.Tensor, weight: torch.Tensor,
                inv_scale: Optional[torch.Tensor] = None,
                items: int = 0) -> None:
    """:func:`launch` writing into ``out`` [N, F] f32, without counting a
    call: kernel B's wrapper fills its aggregate with it. ``h`` may hold
    more rows than ``out``: the arcs read it only through ``src``."""
    device = h.device
    if device.type != "cuda":
        raise ValueError(f"csr_aggregate kernel needs CUDA tensors, "
                         f"got {device}")
    if h.dim() != 2 or out.dim() != 2 or h.shape[0] < out.shape[0]:
        raise ValueError(f"h must be [M, F] and out [N, F] with M >= N, got "
                         f"{tuple(h.shape)} and {tuple(out.shape)}")
    n, f = out.shape
    e = src.shape[0]
    check_tensor("h", h, torch.float32, (h.shape[0], f), device)
    check_tensor("src", src, torch.int32, (e,), device)
    check_tensor("row_ptr", row_ptr, torch.int32, (n + 1,), device)
    check_tensor("weight", weight, torch.float32, (e,), device)
    if inv_scale is not None:
        check_tensor("inv_scale", inv_scale, torch.float32, (n,), device)
    check_tensor("out", out, torch.float32, (n, f), device)
    sp = split(n, e, items)
    buf, parts = scratch(sp, f, device)     # buf lives past the launch
    lib = _lib()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = lib.csr_aggregate_f32(
            h.data_ptr(), src.data_ptr(), row_ptr.data_ptr(),
            weight.data_ptr(),
            inv_scale.data_ptr() if inv_scale is not None else None,
            out.data_ptr(), *parts, n, e, f, sp.items, sp.warps, stream)
    if err != 0:
        raise RuntimeError("csr_aggregate kernel launch failed: "
                           + lib.csr_aggregate_error(err).decode())


def aggregate(h: torch.Tensor, src: torch.Tensor, dst: torch.Tensor,
              row_ptr: torch.Tensor, weight: torch.Tensor,
              inv_scale: Optional[torch.Tensor] = None,
              items: int = 0) -> torch.Tensor:
    """The plain version for a CPU tensor, the kernel (split by ``items``)
    for a CUDA one."""
    if h.device.type == "cpu":
        return plain(h, src, dst, weight, h.shape[0], inv_scale)
    return launch(h, src, row_ptr, weight, inv_scale, items)


def transpose(g: torch.Tensor, csr, weight: torch.Tensor,
              inv_scale: Optional[torch.Tensor],
              items: int = 0) -> torch.Tensor:
    """``dh = Aᵀ·diag(inv)·g``: the aggregation over the reversed arcs of
    ``csr`` (rows are source nodes), with the normalisation folded into the
    reversed weights ``w[e]·inv[dst[e]]`` and no epilogue.

    The reversed weights come from ``weight`` as it is now, never from a
    cache, as the reference's ``_aggregate_diff_bwd`` computes them."""
    w = weight if inv_scale is None else \
        weight * inv_scale.index_select(0, csr.dst.long())
    rev_w = w.index_select(0, csr.rev_perm).contiguous()
    return aggregate(g.contiguous(), csr.rev_src, csr.rev_dst,
                     csr.rev_row_ptr, rev_w, items=items)


class AggregateFn(torch.autograd.Function):
    """``out = inv ⊙ A·h`` (kernel A) with the reference's VJP.

    ``weight`` is the CSR-ordered arc weight, passed on its own so autograd
    sees it; ``csr`` carries the index arrays (forward and reversed) and
    ``inv_scale`` gets no gradient, as in the reference. ``config`` (a
    resolved :class:`repro_torch.kernels.autotune.KernelConfig`, kept on
    ``ctx``) gives the split of the forward and of the backward's
    transposed aggregation alike."""

    @staticmethod
    def forward(ctx, h, weight, csr, inv_scale, config):
        ctx.csr, ctx.config = csr, config
        ctx.save_for_backward(h, weight, inv_scale)
        return aggregate(h, csr.src, csr.dst, csr.row_ptr, weight, inv_scale,
                         config.items)

    @staticmethod
    def backward(ctx, g):
        h, weight, inv = ctx.saved_tensors
        csr = ctx.csr
        g = g.float().contiguous()
        dh = transpose(g, csr, weight, inv, ctx.config.items) \
            if ctx.needs_input_grad[0] else None
        dw = edge_dot(h, g, csr.src, csr.dst, inv) \
            if ctx.needs_input_grad[1] else None
        return dh, dw, None, None, None
