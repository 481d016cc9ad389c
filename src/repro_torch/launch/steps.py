"""The train, prefill and decode steps, the reference's
``repro.launch.steps`` on one device.

``make_train_step(cfg, lr)`` is the reference's train step: the gradient
of :func:`repro_torch.models.lm.train_loss`, then AdamW with weight decay
0.01 and the global norm clipped to 1.0. It runs as one
:class:`repro_torch.graphs.CapturedStep` (one CUDA graph: forward, the
remat recomputation, backward, AdamW) with params and optimizer state
*borrowed*: the graph reads and writes them where they are and the
update is in place (:func:`repro_torch.optim.adamw_update_`), so neither
the step's buffers nor a new tree ever hold a second copy of them (at
qwen3-4b's full width, params and moments are 44.1 GB). The warm-up
before the capture takes the gradient and no step, so the first call
updates once; it then hands its memory back to the device, so the
capture's pool does not sit beside it. ``capture=False`` returns the
plain function.

``make_prefill_step`` and ``make_decode_step`` are the model's
``prefill_step`` and ``serve_step`` with the config bound; serving
(:mod:`repro_torch.launch.serve`) builds its steps from them.

The reference's sharding helpers (``params_spec``, ``build``) serve its
TPU dry-run and are not ported here.
"""
from __future__ import annotations

from typing import Callable, Dict, Union

import torch

from ..device import DeviceLike, resolve_device
from ..graphs import CapturedStep
from ..models.config import ModelConfig
from ..models.lm import prefill_step, serve_step, train_loss
from ..optim import OptState, Schedule, adamw_update_
from ..tree import value_and_grad

__all__ = ["make_train_step", "make_prefill_step", "make_decode_step"]


def make_train_step(cfg: ModelConfig, lr: Union[float, Schedule] = 1e-4,
                    device: DeviceLike = "cuda",
                    capture: bool = True) -> Callable:
    """``step(params, opt, batch) -> (params, opt, loss)``: one AdamW
    step, written into ``params`` and ``opt`` (the same objects come
    back). ``lr`` is a rate or a schedule of the step count before the
    update. On the card a later call must pass the tensors of the first
    (they are bound by address); ``batch`` is copied in."""
    def train_step(params: Dict, opt: OptState, batch: Dict):
        loss, grads = value_and_grad(lambda p: train_loss(p, cfg, batch),
                                     params)
        rate = lr(opt.step) if callable(lr) else lr
        adamw_update_(grads, opt, params, rate, weight_decay=0.01)
        return params, opt, loss
    if not capture:
        return train_step
    device = resolve_device(device)

    def warmup(params: Dict, opt: OptState, batch: Dict) -> None:
        value_and_grad(lambda p: train_loss(p, cfg, batch), params)
        if device.type == "cuda":
            torch.cuda.empty_cache()
    return CapturedStep(train_step, device, borrow=(0, 1), name="train",
                        warmup=warmup)


def make_prefill_step(cfg: ModelConfig) -> Callable:
    def fn(params, batch):
        return prefill_step(params, cfg, batch)
    return fn


def make_decode_step(cfg: ModelConfig) -> Callable:
    def fn(params, tokens, cache, lengths):
        return serve_step(params, cfg, tokens, cache, lengths)
    return fn
