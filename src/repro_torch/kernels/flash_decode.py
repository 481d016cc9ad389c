"""Kernel D: single-token GQA decode attention over a KV cache.

``out[b, h] = softmax(q[b, h]·K[b, :filled[b], h // G]ᵀ / √D)·V[...]`` for
a whole decode batch in one launch. The kernel is ``csrc/flash_decode.cu``
(split-K over the cache through a shared-memory ring of K/V tiles; bf16
products on tensor cores; the last block of each group merges the
stretches); its plain version is
:func:`repro_torch.kernels.ref.flash_decode_ref` (re-exported here as
``plain``). :func:`flash_decode` dispatches: a CPU
tensor takes the plain version, a CUDA tensor the kernel. The kernel reads
``filled`` on the device, so a decode step never waits for the host.

The first call of a shape (device, dtypes, shapes) checks the tensors,
reads the SM count and the kernel's occupancy, picks the plan and
allocates the kernel's workspace (per-stretch partials and zeroed arrival
counters, which every call leaves at zero); later calls of that shape
look the plan up, check contiguity and alignment, and allocate only their
output. Calls of one shape must not overlap on two streams: they share
the workspace.

At ``filled[b] == 0`` the kernel gives 0 and the plain version the mean of
V (the reference's kernel and oracle differ the same way); the decode path
always has ``filled >= 1``.
"""
from __future__ import annotations

import ctypes
from typing import Dict, NamedTuple, Tuple

import torch

from . import _build
from ._build import check_tensor
from .ref import flash_decode_ref as plain

__all__ = ["flash_decode", "launch", "plain", "launches", "plan"]

#: Kernel launches since the last reset (see ``ops.reset_launch_counts``).
launches = 0

#: Head dims the kernel takes (96: phi-3-vision's 3,072 / 32 heads).
HEAD_DIMS = (64, 96, 128)
MAX_ROWS = 16              # query rows one block holds (the source's)
MAX_CHUNK = 4096           # longest stretch of the cache one block reads
MAX_SPLITS = 256           # most stretches
WAVES = 8                  # waves of blocks that balance unequal lengths
MIN_TILES = 8              # tiles a stretch keeps when cut for balance


def tile(dtype: torch.dtype) -> int:
    """Positions of one ring stage: 64 in bf16, 32 in f32."""
    return 64 if dtype == torch.bfloat16 else 32


def group_rows(group: int, dtype: torch.dtype) -> int:
    """Query rows one block holds: 16 in bf16 (the tensor-core product's
    A operand, zero past the group), the group rounded up to 4, 8 or 16 in
    f32; a larger group is cut into chunks of that many, each its own
    block."""
    if dtype == torch.bfloat16:
        return MAX_ROWS
    return 4 if group <= 4 else 8 if group <= 8 else MAX_ROWS


def plan(b: int, s: int, h: int, hkv: int, dtype: torch.dtype, sms: int,
         blocks_per_sm: int) -> Tuple[int, int]:
    """``(splits, chunk)``: the cache is cut into ``splits`` stretches of
    ``chunk`` positions (a multiple of the tile), enough that the
    ``b * hkv * row chunks * splits`` blocks give each of ``sms`` SMs a
    block, no block reads more than ``MAX_CHUNK`` positions, and there are
    at most ``MAX_SPLITS`` stretches. Where stretches of ``MIN_TILES``
    tiles or more allow it, the blocks make ``WAVES`` waves of
    ``blocks_per_sm * sms``: the rows' lengths (read on the device)
    differ, and blocks past a row's length exit at once, so one wave would
    leave SMs idle behind the longest rows. Cutting further costs more
    than it gains: a block's fixed work (q, the first tiles' latency, its
    partials and the merge) is worth several tiles."""
    step = tile(dtype)
    g = h // hkv
    gchunks = -(-g // group_rows(g, dtype))
    groups = b * hkv * gchunks
    want = max(-(-sms // groups), -(-s // MAX_CHUNK), 1,
               min(-(-WAVES * blocks_per_sm * sms // groups),
                   s // (MIN_TILES * step)))
    want = min(want, MAX_SPLITS)
    chunk = -(-max(1, -(-s // want)) // step) * step
    return -(-s // chunk), chunk


class _Plan(NamedTuple):
    out_shape: Tuple[int, int, int]
    is_bf16: int
    ints: Tuple[int, ...]          # b, s, h, hkv, d, splits, chunk
    ws_ml: int                     # data pointers of the workspace
    ws_acc: int
    counters: int
    workspace: Tuple[torch.Tensor, ...]


_lib_cache = None
_PLANS: Dict[tuple, _Plan] = {}
_SMS: Dict[int, int] = {}


def _lib():
    global _lib_cache
    if _lib_cache is None:
        lib = _build.load("flash_decode")
        lib.flash_decode.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 8
                                     + [ctypes.c_int] * 7 + [ctypes.c_void_p])
        lib.flash_decode.restype = ctypes.c_int
        lib.flash_decode_occupancy.argtypes = [ctypes.c_int] * 3 + [
            ctypes.POINTER(ctypes.c_int)]
        lib.flash_decode_occupancy.restype = ctypes.c_int
        lib.flash_decode_error.argtypes = [ctypes.c_int]
        lib.flash_decode_error.restype = ctypes.c_char_p
        _lib_cache = lib
    return _lib_cache


def _raw_stream(index: int) -> int:
    """The current stream's handle on device ``index``: PyTorch's own
    accessor (what its compiled kernels launch on), which builds no
    ``torch.cuda.Stream`` object as ``current_stream()`` does."""
    return torch._C._cuda_getCurrentRawStream(index)


def _raise(lib, err: int, what: str):
    raise RuntimeError(f"flash_decode kernel {what} failed: "
                       + lib.flash_decode_error(err).decode())


def _new_plan(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              filled: torch.Tensor) -> _Plan:
    """Check a new shape, plan it and allocate its workspace."""
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
    lib = _lib()
    is_bf16 = int(k.dtype == torch.bfloat16)
    g = h // hkv
    with torch.cuda.device(device):
        if device.index not in _SMS:
            _SMS[device.index] = torch.cuda.get_device_properties(
                device).multi_processor_count
        blocks = ctypes.c_int(0)
        err = lib.flash_decode_occupancy(is_bf16, d, g, ctypes.byref(blocks))
    if err != 0:
        _raise(lib, err, "occupancy query")
    splits, chunk = plan(b, s, h, hkv, k.dtype, _SMS[device.index],
                         max(blocks.value, 1))
    rows = b * h * splits
    ws_ml = torch.empty((rows, 2), dtype=torch.float32, device=device)
    ws_acc = torch.empty((rows, d), dtype=torch.float32, device=device)
    gchunks = -(-g // group_rows(g, k.dtype))
    counters = torch.zeros((b * hkv * gchunks,), dtype=torch.int32,
                           device=device)
    return _Plan((b, h, d), is_bf16, (b, s, h, hkv, d, splits, chunk),
                 ws_ml.data_ptr(), ws_acc.data_ptr(), counters.data_ptr(),
                 (ws_ml, ws_acc, counters))


def plan_of(q: torch.Tensor, k: torch.Tensor) -> Tuple[int, int]:
    """``(splits, chunk)`` the kernel took for this shape (after a call)."""
    return next(p.ints[5:] for key, p in _PLANS.items()
                if key[:2] == (q.shape, k.shape) and key[5] == k.dtype
                and key[9] == k.device)


def launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           filled: torch.Tensor) -> torch.Tensor:
    """Run the CUDA kernel; returns ``[B, H, D]`` in the cache dtype.

    q: ``[B, H, D]``, k/v: ``[B, S, Hkv, D]`` (bf16 or f32, all one dtype),
    filled: ``[B]`` int32, all contiguous on one CUDA device, q, k and v
    16-byte aligned."""
    global launches
    key = (q.shape, k.shape, v.shape, filled.shape, q.dtype, k.dtype,
           v.dtype, filled.dtype, q.device, k.device, v.device,
           filled.device)
    p = _PLANS.get(key)
    if p is None:
        p = _new_plan(q, k, v, filled)
        _PLANS[key] = p
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()
            and filled.is_contiguous()):
        raise ValueError("q, k, v and filled must be contiguous")
    qp, kp, vp = q.data_ptr(), k.data_ptr(), v.data_ptr()
    if (qp | kp | vp) & 15:
        raise ValueError("q, k and v must be 16-byte aligned")
    device = k.device
    out = torch.empty(p.out_shape, dtype=k.dtype, device=device)
    lib = _lib()
    index = device.index
    if index == torch.cuda.current_device():
        err = lib.flash_decode(
            p.is_bf16, qp, kp, vp, filled.data_ptr(), out.data_ptr(),
            p.ws_ml, p.ws_acc, p.counters, *p.ints, _raw_stream(index))
    else:
        with torch.cuda.device(device):
            err = lib.flash_decode(
                p.is_bf16, qp, kp, vp, filled.data_ptr(), out.data_ptr(),
                p.ws_ml, p.ws_acc, p.counters, *p.ints, _raw_stream(index))
    if err != 0:
        _raise(lib, err, "launch")
    launches += 1
    return out


def flash_decode(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 filled: torch.Tensor) -> torch.Tensor:
    """The plain version for a CPU tensor, the kernel for a CUDA one."""
    if k.device.type == "cpu":
        return plain(q, k, v, filled)
    return launch(q, k, v, filled)
