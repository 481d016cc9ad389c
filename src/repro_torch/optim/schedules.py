"""Learning-rate schedules as ``step -> lr`` callables, the reference's
``repro.optim.schedules``.

Each takes the step as a tensor (the optimizer state's counter, on the
device) and returns a 0-d f32 tensor on the same device, computed there:
a captured step calls it without reading anything back to the host. The
arithmetic follows the reference's expressions term for term, with the
Python constants folded in the same places.
"""
from __future__ import annotations

import math
from typing import Callable

import torch

Schedule = Callable[[torch.Tensor], torch.Tensor]

__all__ = ["Schedule", "constant_schedule", "cosine_schedule",
           "linear_warmup_cosine"]


def constant_schedule(lr: float) -> Schedule:
    return lambda step: torch.full((), lr, dtype=torch.float32,
                                   device=step.device)


def cosine_schedule(lr: float, total_steps: int, final_frac: float = 0.1
                    ) -> Schedule:
    def fn(step: torch.Tensor) -> torch.Tensor:
        t = torch.clamp(step.float() / total_steps, 0.0, 1.0)
        cos = 0.5 * (1 + torch.cos(math.pi * t))
        return lr * (final_frac + (1 - final_frac) * cos)
    return fn


def linear_warmup_cosine(lr: float, warmup_steps: int, total_steps: int,
                         final_frac: float = 0.05) -> Schedule:
    def fn(step: torch.Tensor) -> torch.Tensor:
        step = step.float()
        warm = lr * step / max(warmup_steps, 1)
        t = torch.clamp((step - warmup_steps)
                        / max(total_steps - warmup_steps, 1), 0.0, 1.0)
        cos = lr * (final_frac + (1 - final_frac) * 0.5
                    * (1 + torch.cos(math.pi * t)))
        return torch.where(step < warmup_steps, warm, cos)
    return fn
