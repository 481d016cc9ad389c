"""Kernel D: single-token GQA decode attention over a KV cache.

``out[b, h] = softmax(q[b, h]·K[b, :filled[b], h // G]ᵀ / √D)·V[...]`` for
a whole decode batch in one launch (plus a small merge launch). The kernel
is ``csrc/flash_decode.cu`` (split-K over the cache, log-sum-exp merge); its
plain version is :func:`repro_torch.kernels.ref.flash_decode_ref`
(re-exported here as ``plain``). :func:`flash_decode` dispatches: a CPU
tensor takes the plain version, a CUDA tensor the kernel. The kernel reads
``filled`` on the device, so a decode step never waits for the host.

At ``filled[b] == 0`` the kernel gives 0 and the plain version the mean of
V (the reference's kernel and oracle differ the same way); the decode path
always has ``filled >= 1``.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from . import _build
from ._build import check_tensor
from .ref import flash_decode_ref as plain

__all__ = ["flash_decode", "launch", "plain", "launches", "plan"]

#: Kernel launches since the last reset (see ``ops.reset_launch_counts``).
launches = 0

#: Head dims the kernel takes (a row is D/8 lanes of 8 elements each).
HEAD_DIMS = (64, 128)
WARPS = 4                  # warps per block, as in the source
MAX_CHUNK = 4096           # longest stretch of the cache one block reads
BLOCKS_PER_SM = 4          # blocks per SM the split count aims for

_lib_cache = None


def _lib():
    global _lib_cache
    if _lib_cache is None:
        lib = _build.load("flash_decode")
        for fn in (lib.flash_decode_f32, lib.flash_decode_bf16):
            fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 7 + [
                ctypes.c_void_p]
            fn.restype = ctypes.c_int
        lib.flash_decode_error.argtypes = [ctypes.c_int]
        lib.flash_decode_error.restype = ctypes.c_char_p
        _lib_cache = lib
    return _lib_cache


def group_rows(group: int) -> int:
    """Query rows one block holds (the source's GMAX): the group size
    rounded up to a power of two, at most 8; a larger group is cut into
    chunks of 8, each its own block."""
    return 1 if group <= 1 else 2 if group <= 2 else 4 if group <= 4 else 8


def plan(b: int, s: int, h: int, hkv: int, d: int,
         sms: int) -> Tuple[int, int]:
    """``(splits, chunk)``: the cache is cut into ``splits`` stretches of
    ``chunk`` positions (a multiple of the block's step), enough that
    ``b * hkv * group chunks * splits`` blocks fill ``sms`` SMs
    ``BLOCKS_PER_SM`` times over and no block reads more than
    ``MAX_CHUNK`` positions."""
    gmax = group_rows(h // hkv)
    gchunks = -(-(h // hkv) // gmax)
    step = WARPS * (32 // (d // 8)) * (4 if gmax <= 4 else 2)
    want = max(-(-BLOCKS_PER_SM * sms // (b * hkv * gchunks)),
               -(-s // MAX_CHUNK), 1)
    chunk = -(-max(1, -(-s // want)) // step) * step
    return -(-s // chunk), chunk


def launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           filled: torch.Tensor) -> torch.Tensor:
    """Run the CUDA kernel; returns ``[B, H, D]`` in the cache dtype.

    q: ``[B, H, D]``, k/v: ``[B, S, Hkv, D]`` (bf16 or f32, all one dtype),
    filled: ``[B]`` int32, all contiguous on one CUDA device."""
    global launches
    device = k.device
    if device.type != "cuda":
        raise ValueError(f"flash_decode kernel needs CUDA tensors, got "
                         f"{device}")
    if k.dim() != 4 or q.dim() != 3:
        raise ValueError(f"need q [B, H, D] and k/v [B, S, Hkv, D], got "
                         f"{tuple(q.shape)} and {tuple(k.shape)}")
    b, s, hkv, d = k.shape
    h = q.shape[1]
    if k.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"flash_decode kernel takes f32 or bf16, got "
                         f"{k.dtype}")
    if d not in HEAD_DIMS or h % hkv:
        raise ValueError(f"flash_decode kernel takes D in {HEAD_DIMS} and H "
                         f"a multiple of Hkv, got D={d}, H={h}, Hkv={hkv}")
    check_tensor("q", q, k.dtype, (b, h, d), device)
    check_tensor("k", k, k.dtype, (b, s, hkv, d), device)
    check_tensor("v", v, k.dtype, (b, s, hkv, d), device)
    check_tensor("filled", filled, torch.int32, (b,), device)
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    splits, chunk = plan(b, s, h, hkv, d, sms)
    out = torch.empty((b, h, d), dtype=k.dtype, device=device)
    part_m = torch.empty((b, h, splits), dtype=torch.float32, device=device)
    part_l = torch.empty_like(part_m)
    part_acc = torch.empty((b, h, splits, d), dtype=torch.float32,
                           device=device)
    lib = _lib()
    fn = lib.flash_decode_bf16 if k.dtype == torch.bfloat16 \
        else lib.flash_decode_f32
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), filled.data_ptr(),
                 out.data_ptr(), part_m.data_ptr(), part_l.data_ptr(),
                 part_acc.data_ptr(), b, s, h, hkv, d, splits, chunk, stream)
    if err != 0:
        raise RuntimeError("flash_decode kernel launch failed: "
                           + lib.flash_decode_error(err).decode())
    launches += 1
    return out


def flash_decode(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 filled: torch.Tensor) -> torch.Tensor:
    """The plain version for a CPU tensor, the kernel for a CUDA one."""
    if k.device.type == "cpu":
        return plain(q, k, v, filled)
    return launch(q, k, v, filled)

