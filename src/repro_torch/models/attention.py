"""Attention: GQA (+qk_norm, qkv bias, partial RoPE, sliding window); the
prefill path (query-chunked, causal) and the decode path (KV cache).

Prefill attention is **query-chunked**: a loop over query blocks keeps the
logits buffer at ``[B, Hkv, G, Cq, S]`` instead of ``[B, H, S, S]``. Decode
attention goes through :func:`repro_torch.kernels.ops.flash_decode`: kernel
D on the card, its plain version on the CPU. MLA and cross-attention are
not ported yet.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from ..kernels.ops import flash_decode
from .config import ModelConfig
from .layers import apply_rope, normal, rms_norm_heads, torch_dtype

Q_CHUNK = 512


def init_attention(cfg: ModelConfig, device: torch.device,
                   gen: torch.Generator) -> Dict[str, torch.Tensor]:
    d, h, hkv, dh = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    dt = torch_dtype(cfg)
    s = (1.0 / d) ** 0.5
    p = {"wq": normal((d, h * dh), s, dt, device, gen),
         "wk": normal((d, hkv * dh), s, dt, device, gen),
         "wv": normal((d, hkv * dh), s, dt, device, gen),
         "wo": normal((h * dh, d), s, dt, device, gen)}
    if cfg.qkv_bias:
        for name, width in (("bq", h * dh), ("bk", hkv * dh),
                            ("bv", hkv * dh)):
            p[name] = torch.zeros((width,), dtype=dt, device=device)
    if cfg.qk_norm:
        p["q_norm"] = torch.ones((dh,), dtype=torch.float32, device=device)
        p["k_norm"] = torch.ones((dh,), dtype=torch.float32, device=device)
    return p


def _project_qkv(p: Dict[str, torch.Tensor], cfg: ModelConfig,
                 x: torch.Tensor, positions: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    b, s, _ = x.shape
    h, hkv, dh = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    q, k, v = x @ p["wq"], x @ p["wk"], x @ p["wv"]
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q = q.reshape(b, s, h, dh)
    k = k.reshape(b, s, hkv, dh)
    v = v.reshape(b, s, hkv, dh)
    if cfg.qk_norm:
        q = rms_norm_heads(q, p["q_norm"])
        k = rms_norm_heads(k, p["k_norm"])
    return apply_rope(q, positions, cfg), apply_rope(k, positions, cfg), v


def _attend_chunked(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool, window: Optional[int]) -> torch.Tensor:
    """q: ``[B, Sq, H, Dh]``; k, v: ``[B, Sk, Hkv, Dh]`` -> ``[B, Sq, H, Dh]``.

    Each query chunk takes a masked f32 softmax against the whole K; query
    ``i`` sits at position ``i`` of the kv timeline."""
    b, sq, h, dh = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    dv = v.shape[-1]
    g = h // hkv
    scale = dh ** -0.5
    kf, vf = k.float(), v.float()
    kpos = torch.arange(sk, device=q.device)
    masked = torch.full((), -1e30, device=q.device)
    outs = []
    for c0 in range(0, sq, Q_CHUNK):
        qi = q[:, c0:c0 + Q_CHUNK]
        cq = qi.shape[1]
        qg = qi.reshape(b, cq, hkv, g, dh).float()
        logits = torch.einsum("bqhgd,bkhd->bhgqk", qg, kf) * scale
        qpos = c0 + torch.arange(cq, device=q.device)
        mask = torch.ones((cq, sk), dtype=torch.bool, device=q.device)
        if causal:
            mask &= kpos[None, :] <= qpos[:, None]
        if window is not None:
            mask &= kpos[None, :] > qpos[:, None] - window
        probs = torch.softmax(torch.where(mask, logits, masked), dim=-1)
        out = torch.einsum("bhgqk,bkhd->bqhgd", probs, vf)
        outs.append(out.reshape(b, cq, h, dv))
    return torch.cat(outs, dim=1).to(q.dtype)


def attention_train(p: Dict[str, torch.Tensor], cfg: ModelConfig,
                    x: torch.Tensor, positions: torch.Tensor,
                    return_kv: bool = False):
    """Full-sequence self-attention. x: ``[B, S, d]``."""
    b, s, _ = x.shape
    q, k, v = _project_qkv(p, cfg, x, positions)
    window = cfg.window if cfg.attention == "sliding" else None
    out = _attend_chunked(q, k, v, cfg.causal, window)
    out = out.reshape(b, s, -1) @ p["wo"]
    if return_kv:
        return out, k, v
    return out


def attention_decode(p: Dict[str, torch.Tensor], cfg: ModelConfig,
                     x: torch.Tensor, cache_k: torch.Tensor,
                     cache_v: torch.Tensor, length: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One-token decode. x: ``[B, 1, d]``; cache_*: ``[B, S, Hkv, Dh]``;
    length: ``[B]`` int32 (the fill before this token).

    Returns ``(out [B, 1, d], cache_k, cache_v)``. The new K/V row is
    written into the caches IN PLACE, at ``length`` (a sliding config's
    ring buffer: ``length % S``). The reference rewrites the whole cache
    through a one-hot ``where``, which costs nothing under its jit but in
    eager PyTorch would copy every layer's full cache on every step."""
    b = x.shape[0]
    h, dh = cfg.num_heads, cfg.head_dim
    s_cache = cache_k.shape[1]
    q, k, v = _project_qkv(p, cfg, x, length[:, None])
    sliding = cfg.attention == "sliding"
    slot = (length % s_cache if sliding else length).long()
    rows = torch.arange(b, device=x.device)
    cache_k[rows, slot] = k[:, 0].to(cache_k.dtype)
    cache_v[rows, slot] = v[:, 0].to(cache_v.dtype)
    # valid entries: a prefix of the cache in both cases (the ring buffer
    # fills its slots in order)
    filled = (torch.clamp(length + 1, max=s_cache) if sliding
              else length + 1).to(torch.int32)
    out = flash_decode(q[:, 0].to(cache_k.dtype).contiguous(), cache_k,
                       cache_v, filled)
    out = out.reshape(b, 1, h * dh).to(x.dtype)
    return out @ p["wo"], cache_k, cache_v
