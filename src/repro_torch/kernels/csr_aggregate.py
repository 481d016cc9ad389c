"""Kernel A: CSR neighbour aggregation with a fused mean epilogue.

``out[d] = inv[d] * sum_{e in row d} w[e] * h[src[e]]`` over a CSR whose
rows are the destination nodes. The kernel is ``csrc/csr_aggregate.cu``;
its plain version is :func:`repro_torch.kernels.ref.csr_aggregate_ref`
(re-exported here as ``plain``). :mod:`repro_torch.kernels.ops` builds the
CSR and dispatches: CPU tensors go to the plain version, CUDA tensors to
:func:`launch`.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import _build
from .ref import csr_aggregate_ref as plain

__all__ = ["launch", "plain", "launches", "check_tensor"]

#: Kernel launches since the last reset (see ``ops.reset_launch_counts``).
launches = 0

_lib_cache = None


def _lib():
    global _lib_cache
    if _lib_cache is None:
        lib = _build.load("csr_aggregate")
        lib.csr_aggregate_f32.argtypes = [ctypes.c_void_p] * 6 + [
            ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        lib.csr_aggregate_f32.restype = ctypes.c_int
        lib.csr_aggregate_error.argtypes = [ctypes.c_int]
        lib.csr_aggregate_error.restype = ctypes.c_char_p
        _lib_cache = lib
    return _lib_cache


def check_tensor(name: str, t: torch.Tensor, dtype: torch.dtype,
                 shape: tuple, device: torch.device) -> None:
    """Raise ``ValueError`` unless ``t`` is what a kernel takes."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def launch(h: torch.Tensor, src: torch.Tensor, row_ptr: torch.Tensor,
           weight: torch.Tensor,
           inv_scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Run the CUDA kernel; returns ``out`` [N, F] f32.

    ``src``/``weight`` are the arcs sorted by destination and ``row_ptr``
    [N+1] int32 their row offsets (``ops.to_csr`` builds all three).
    """
    global launches
    device = h.device
    if device.type != "cuda":
        raise ValueError(f"csr_aggregate kernel needs CUDA tensors, "
                         f"got {device}")
    if h.dim() != 2:
        raise ValueError(f"h must be [N, F], got shape {tuple(h.shape)}")
    n, f = h.shape
    e = src.shape[0]
    check_tensor("h", h, torch.float32, (n, f), device)
    check_tensor("src", src, torch.int32, (e,), device)
    check_tensor("row_ptr", row_ptr, torch.int32, (n + 1,), device)
    check_tensor("weight", weight, torch.float32, (e,), device)
    if inv_scale is not None:
        check_tensor("inv_scale", inv_scale, torch.float32, (n,), device)
    out = torch.empty((n, f), dtype=torch.float32, device=device)
    lib = _lib()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = lib.csr_aggregate_f32(
            h.data_ptr(), src.data_ptr(), row_ptr.data_ptr(),
            weight.data_ptr(),
            inv_scale.data_ptr() if inv_scale is not None else None,
            out.data_ptr(), n, f, stream)
    if err != 0:
        raise RuntimeError("csr_aggregate kernel launch failed: "
                           + lib.csr_aggregate_error(err).decode())
    launches += 1
    return out
