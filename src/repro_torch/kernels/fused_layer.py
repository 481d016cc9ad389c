"""Kernel B: one fused GCN layer — CSR mean aggregation, dense transform,
bias and relu in one launch.

``out = act((inv ⊙ Σ_e w[e]·h[src[e]]→dst[e]) @ W + b)``. The kernel is
``csrc/fused_layer.cu``; its plain version is
:func:`repro_torch.kernels.ref.fused_gcn_reference` (re-exported here as
``plain``). The aggregate is written out only when ``need_agg`` is set
(a backward pass needs it for dW; inference does not).
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from . import _build
from .csr_aggregate import check_tensor
from .ref import fused_gcn_reference as plain

__all__ = ["launch", "plain", "launches", "smem_bytes"]

#: Kernel launches since the last reset (see ``ops.reset_launch_counts``).
launches = 0

_lib_cache = None


def _lib():
    global _lib_cache
    if _lib_cache is None:
        lib = _build.load("fused_layer")
        lib.fused_gcn_layer_f32.argtypes = [ctypes.c_void_p] * 9 + [
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_void_p]
        lib.fused_gcn_layer_f32.restype = ctypes.c_int
        lib.fused_gcn_smem_bytes.argtypes = [ctypes.c_int]
        lib.fused_gcn_smem_bytes.restype = ctypes.c_int
        lib.fused_gcn_error.argtypes = [ctypes.c_int]
        lib.fused_gcn_error.restype = ctypes.c_char_p
        _lib_cache = lib
    return _lib_cache


def smem_bytes(f: int) -> int:
    """Shared memory one block of the kernel takes for input width ``f``."""
    return int(_lib().fused_gcn_smem_bytes(int(f)))


def launch(h: torch.Tensor, src: torch.Tensor, row_ptr: torch.Tensor,
           weight: torch.Tensor, inv_scale: Optional[torch.Tensor],
           w: torch.Tensor, b: torch.Tensor, activate: bool = True,
           need_agg: bool = False
           ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Run the CUDA kernel; returns ``(out [N, FO], agg [N, F] or None)``."""
    global launches
    device = h.device
    if device.type != "cuda":
        raise ValueError(f"fused_gcn_layer kernel needs CUDA tensors, "
                         f"got {device}")
    if h.dim() != 2 or w.dim() != 2:
        raise ValueError(f"h and w must be 2-D, got {tuple(h.shape)} and "
                         f"{tuple(w.shape)}")
    n, f = h.shape
    fo = w.shape[1]
    e = src.shape[0]
    check_tensor("h", h, torch.float32, (n, f), device)
    check_tensor("src", src, torch.int32, (e,), device)
    check_tensor("row_ptr", row_ptr, torch.int32, (n + 1,), device)
    check_tensor("weight", weight, torch.float32, (e,), device)
    if inv_scale is not None:
        check_tensor("inv_scale", inv_scale, torch.float32, (n,), device)
    check_tensor("w", w, torch.float32, (f, fo), device)
    check_tensor("b", b, torch.float32, (fo,), device)
    limit = torch.cuda.get_device_properties(device) \
        .shared_memory_per_block_optin
    if smem_bytes(f) > limit:
        raise ValueError(f"input width F={f} needs {smem_bytes(f)} bytes of "
                         f"shared memory per block; the card allows {limit}")
    out = torch.empty((n, fo), dtype=torch.float32, device=device)
    agg = (torch.empty((n, f), dtype=torch.float32, device=device)
           if need_agg else None)
    lib = _lib()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = lib.fused_gcn_layer_f32(
            h.data_ptr(), src.data_ptr(), row_ptr.data_ptr(),
            weight.data_ptr(),
            inv_scale.data_ptr() if inv_scale is not None else None,
            w.data_ptr(), b.data_ptr(), out.data_ptr(),
            agg.data_ptr() if agg is not None else None,
            n, f, fo, int(bool(activate)), stream)
    if err != 0:
        raise RuntimeError("fused_gcn_layer kernel launch failed: "
                           + lib.fused_gcn_error(err).decode())
    launches += 1
    return out, agg
