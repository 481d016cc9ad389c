"""Kernel C: the aggregation's edge-weight gradient.

``dw[e] = Σ_f h[src[e], f] · (inv ⊙ g)[dst[e], f]`` for a cotangent ``g``.
The kernel is ``csrc/edge_dot.cu``, a CSR row walk that gathers both rows
itself: each warp walks ``SPAN`` consecutive arcs, ``BATCH`` at a time,
``PASS`` columns a pass, and holds ``(inv ⊙ g)[dst]`` until ``dst``
changes. Its plain version is :func:`repro_torch.kernels.ref.edge_dot_ref`
(re-exported here as ``plain``), which builds the two ``[E, F]`` gathers.
:func:`edge_dot` dispatches: a CPU tensor takes the plain version, a CUDA
tensor the kernel.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import _build
from ._build import check_tensor
from .ref import edge_dot_ref as plain

__all__ = ["edge_dot", "launch", "plain", "launches"]

#: Kernel launches since the last reset (see ``ops.reset_launch_counts``).
launches = 0

SPAN = 64                  # arcs a warp walks, as in the source
BATCH = 8                  # arcs whose h rows are in flight at once
PASS = 128                 # feature columns a pass

_lib_cache = None


def _lib():
    global _lib_cache
    if _lib_cache is None:
        lib = _build.load("edge_dot")
        lib.edge_dot_f32.argtypes = [ctypes.c_void_p] * 6 + [
            ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        lib.edge_dot_f32.restype = ctypes.c_int
        lib.edge_dot_error.argtypes = [ctypes.c_int]
        lib.edge_dot_error.restype = ctypes.c_char_p
        _lib_cache = lib
    return _lib_cache


def launch(h: torch.Tensor, g: torch.Tensor, src: torch.Tensor,
           dst: torch.Tensor,
           inv_scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Run the CUDA kernel; returns ``dw`` [E] f32 in the arcs' order."""
    global launches
    device = h.device
    if device.type != "cuda":
        raise ValueError(f"edge_dot kernel needs CUDA tensors, got {device}")
    if h.dim() != 2:
        raise ValueError(f"h must be [N, F], got shape {tuple(h.shape)}")
    n, f = h.shape
    e = src.shape[0]
    check_tensor("h", h, torch.float32, (n, f), device)
    check_tensor("g", g, torch.float32, (n, f), device)
    check_tensor("src", src, torch.int32, (e,), device)
    check_tensor("dst", dst, torch.int32, (e,), device)
    if inv_scale is not None:
        check_tensor("inv_scale", inv_scale, torch.float32, (n,), device)
    out = torch.empty((e,), dtype=torch.float32, device=device)
    lib = _lib()
    args = (h.data_ptr(), g.data_ptr(), src.data_ptr(), dst.data_ptr(),
            inv_scale.data_ptr() if inv_scale is not None else None,
            out.data_ptr(), e, f)
    if device.index == torch.cuda.current_device():
        err = lib.edge_dot_f32(*args, torch.cuda.current_stream().cuda_stream)
    else:
        with torch.cuda.device(device):
            err = lib.edge_dot_f32(*args,
                                   torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError("edge_dot kernel launch failed: "
                           + lib.edge_dot_error(err).decode())
    launches += 1
    return out


def edge_dot(h: torch.Tensor, g: torch.Tensor, src: torch.Tensor,
             dst: torch.Tensor,
             inv_scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The plain version for a CPU tensor, the kernel for a CUDA one."""
    if h.device.type == "cpu":
        return plain(h, g, src, dst, inv_scale)
    return launch(h, g, src, dst, inv_scale)
