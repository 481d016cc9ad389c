"""Shared neural building blocks: norms, RoPE, FFN.

The reference's cast rules hold: a norm computes in f32 and casts its
result back to ``x.dtype``; RoPE rotates in f32 and casts back. Weights are
made on the caller's device from the caller's ``torch.Generator`` with the
reference's distributions and scales (not its numbers: the tests hand both
packages the same weights through :mod:`repro_torch.models.convert`).
"""
from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from .config import ModelConfig

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def torch_dtype(cfg: ModelConfig) -> torch.dtype:
    return DTYPES[cfg.dtype]


def normal(shape, scale: float, dtype: torch.dtype, device: torch.device,
           gen: torch.Generator) -> torch.Tensor:
    """``N(0, 1) * scale`` in ``dtype``, drawn on ``device`` in f32."""
    x = torch.randn(shape, generator=gen, device=device, dtype=torch.float32)
    return x.mul_(scale).to(dtype)


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------
def init_norm(cfg: ModelConfig,
              device: torch.device) -> Dict[str, torch.Tensor]:
    d = cfg.d_model
    p = {"scale": torch.ones((d,), dtype=torch.float32, device=device)}
    if cfg.norm == "layernorm":
        p["bias"] = torch.zeros((d,), dtype=torch.float32, device=device)
    return p


def apply_norm(p: Dict[str, torch.Tensor], x: torch.Tensor,
               eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    if "bias" in p:
        mu = xf.mean(-1, keepdim=True)
        var = (xf - mu).square().mean(-1, keepdim=True)
        out = (xf - mu) * torch.rsqrt(var + eps) * p["scale"] + p["bias"]
    else:
        ms = xf.square().mean(-1, keepdim=True)
        out = xf * torch.rsqrt(ms + eps) * p["scale"]
    return out.to(x.dtype)


def rms_norm_heads(x: torch.Tensor, scale: torch.Tensor,
                   eps: float = 1e-6) -> torch.Tensor:
    """Per-head RMSNorm on ``[..., H, Dh]`` (qwen3 qk_norm)."""
    xf = x.float()
    ms = xf.square().mean(-1, keepdim=True)
    return (xf * torch.rsqrt(ms + eps) * scale).to(x.dtype)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------
def rope_frequencies(cfg: ModelConfig, head_dim: int,
                     device: torch.device) -> torch.Tensor:
    rot = int(head_dim * cfg.rope_fraction)
    rot -= rot % 2
    exps = torch.arange(0, rot, 2, dtype=torch.float32, device=device) / rot
    return 1.0 / (cfg.rope_theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               cfg: ModelConfig) -> torch.Tensor:
    """x: ``[..., S, H, Dh]``; positions: ``[..., S]``. Rotates the first
    ``rope_fraction`` of the head dim in interleaved pairs (GLM-style
    partial rotary)."""
    dh = x.shape[-1]
    freqs = rope_frequencies(cfg, dh, x.device)          # [rot/2]
    rot = freqs.shape[0] * 2
    angles = positions[..., :, None].float() * freqs     # [..., S, rot/2]
    cos = torch.cos(angles)[..., :, None, :]             # [..., S, 1, rot/2]
    sin = torch.sin(angles)[..., :, None, :]
    xr, xp = x[..., :rot], x[..., rot:]
    x1, x2 = xr[..., 0::2], xr[..., 1::2]
    o1 = x1 * cos - x2 * sin
    o2 = x2 * cos + x1 * sin
    out = torch.stack([o1, o2], dim=-1).reshape(xr.shape)
    return torch.cat([out.to(x.dtype), xp], dim=-1)


# ---------------------------------------------------------------------------
# FFN
# ---------------------------------------------------------------------------
def init_ffn(cfg: ModelConfig, device: torch.device,
             gen: torch.Generator) -> Dict[str, torch.Tensor]:
    d, f = cfg.d_model, cfg.d_ff
    dt = torch_dtype(cfg)
    s_in, s_out = (2.0 / d) ** 0.5, (2.0 / f) ** 0.5
    p = {}
    if cfg.ffn_activation == "swiglu":
        p["w_gate"] = normal((d, f), s_in, dt, device, gen)
    p["w_up"] = normal((d, f), s_in, dt, device, gen)
    p["w_out"] = normal((f, d), s_out, dt, device, gen)
    if cfg.ffn_bias:
        p["b_up"] = torch.zeros((f,), dtype=dt, device=device)
        p["b_out"] = torch.zeros((d,), dtype=dt, device=device)
    return p


def ffn_forward(p: Dict[str, torch.Tensor], cfg: ModelConfig,
                x: torch.Tensor) -> torch.Tensor:
    if cfg.ffn_activation == "swiglu":
        h = F.silu(x @ p["w_gate"]) * (x @ p["w_up"])
    else:
        h = x @ p["w_up"]
        if "b_up" in p:
            h = h + p["b_up"]
        if cfg.ffn_activation == "squared_relu":      # nemotron-4
            h = torch.relu(h).square()
        else:
            # jax.nn.gelu defaults to the tanh approximation
            h = F.gelu(h, approximate="tanh")
    out = h @ p["w_out"]
    if "b_out" in p:
        out = out + p["b_out"]
    return out
