"""Device resolution for the port's entry points.

Every entry point defaults to the GPU. Without one it raises instead of
running on the CPU quietly; the CPU path is taken only when the caller
asks for it (``device="cpu"``), as the tests do.
"""
from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = "cuda") -> torch.device:
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on a CUDA GPU by default and none is "
            "available; pass device='cpu' to run the plain PyTorch path")
    return dev


def synchronize(device: torch.device) -> None:
    """Wait for the device's queued work (a no-op on the CPU)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
