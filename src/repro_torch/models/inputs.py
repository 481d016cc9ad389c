"""Input shapes and synthetic batches for every (arch x shape) pair.

The four assigned input shapes:

    train_4k       seq_len=4,096    global_batch=256   (training)
    prefill_32k    seq_len=32,768   global_batch=32    (inference-prefill)
    decode_32k     seq_len=32,768   global_batch=128   (inference-decode)
    long_500k      seq_len=524,288  global_batch=1     (long-context-decode)

``long_500k`` switches pure-attention configs to the sliding-window variant
(``cfg.long_context == "sliding"``); SSM/hybrid archs run natively.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np
import torch

from .config import ModelConfig
from .layers import torch_dtype


@dataclasses.dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str                  # "train" | "prefill" | "decode"


SHAPES: Dict[str, InputShape] = {
    "train_4k": InputShape("train_4k", 4_096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32_768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524_288, 1, "decode"),
}


def effective_config(cfg: ModelConfig, shape_name: str) -> ModelConfig:
    """Apply the shape-conditional variants (sliding window for long_500k
    on archs that carry full-attention blocks)."""
    if shape_name == "long_500k" and "attn" in \
            list(cfg.blocks) + (["attn"] if "shared_attn" in cfg.blocks
                                else []):
        if cfg.long_context == "sliding" or "shared_attn" in cfg.blocks:
            return dataclasses.replace(cfg, attention="sliding")
    return cfg


def make_batch(cfg: ModelConfig, batch: int, seq: int, seed: int = 0,
               device: torch.device = torch.device("cpu")
               ) -> Dict[str, torch.Tensor]:
    """The reference's synthetic batch, drawn from the same numpy seed in
    the same order: tokens, loss mask, and the frontends' stub inputs."""
    rng = np.random.default_rng(seed)
    dt = torch_dtype(cfg)
    out = {"tokens": torch.as_tensor(
               rng.integers(0, cfg.vocab_size, (batch, seq)),
               dtype=torch.int32, device=device),
           "loss_mask": torch.ones((batch, seq), dtype=torch.float32,
                                   device=device)}
    if cfg.frontend == "vision":
        p = cfg.num_patch_tokens
        out["patch_embeds"] = torch.as_tensor(
            rng.normal(0, 0.02, (batch, p, cfg.d_model)), dtype=dt,
            device=device)
        out["loss_mask"][:, :p] = 0.0
    if cfg.frontend == "audio":
        e = max(8, seq // cfg.enc_seq_divisor)
        out["frames"] = torch.as_tensor(
            rng.normal(0, 0.02, (batch, e, cfg.d_model)), dtype=dt,
            device=device)
    return out
