"""Device resolution for the port's entry points.

Every entry point defaults to the GPU. Without one it raises instead of
running on the CPU quietly; the CPU path is taken only when the caller
asks for it (``device="cpu"``), as the tests do.
"""
from __future__ import annotations

import subprocess
from typing import Optional, Tuple, Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = "cuda") -> torch.device:
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on a CUDA GPU by default and none is "
            "available; pass device='cpu' to run the plain PyTorch path")
    return dev


def card_info(device: DeviceLike) -> Tuple[Optional[str], Optional[float]]:
    """(name, power limit in W) of the card ``device`` runs on, as
    ``nvidia-smi --query-gpu=name,power.limit`` reports them; (None, None)
    on the CPU or where ``nvidia-smi`` cannot be read."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return None, None
    index = torch.cuda.current_device() if dev.index is None else dev.index
    try:
        out = subprocess.run(
            ["nvidia-smi", f"--id={index}", "--query-gpu=name,power.limit",
             "--format=csv,noheader,nounits"],
            capture_output=True, text=True, timeout=30, check=True).stdout
    except (OSError, subprocess.SubprocessError):
        return None, None
    name, _, limit = out.strip().splitlines()[0].rpartition(",")
    try:
        return name.strip(), float(limit)
    except ValueError:              # "[N/A]" on a card without a limit
        return name.strip(), None


def synchronize(device: torch.device) -> None:
    """Wait for the device's queued work (a no-op on the CPU)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
