"""Attention: GQA (+qk_norm, qkv bias, partial RoPE, sliding window) and
MLA (deepseek-v2's multi-head latent attention); the prefill path
(query-chunked, causal) and the decode path (KV cache).

Prefill attention is **query-chunked**: a loop over query blocks keeps the
logits buffer at ``[B, Hkv, G, Cq, S]`` instead of ``[B, H, S, S]``. GQA
decode attention goes through :func:`repro_torch.kernels.ops.flash_decode`:
kernel D on the card, its plain version on the CPU.

MLA caches a latent ``ckv [B, S, kv_lora_rank]`` and one shared RoPE key
``krope [B, S, qk_rope_head_dim]`` a token instead of per-head K/V. Its
prefill (:func:`mla_train`) expands them to per-head K/V and runs the
chunked attention; its decode (:func:`mla_decode`) is the reference's
**absorbed** form: ``W_uk`` folds into the query, attention runs over the
latent cache in f32, and ``W_uv`` applies to the result. Like the
reference's, it is plain products (``einsum``) and launches no kernel of
its own.

Cross-attention (:func:`cross_attention_train`, the enc-dec decoder's
attention over the encoder's ``memory``) is plain products too, with no
RoPE on either side, in prefill, training and decode alike: decode
recomputes the memory's K/V at every step, as the reference does.
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
                    causal: Optional[bool] = None, return_kv: bool = False):
    """Full-sequence self-attention. x: ``[B, S, d]``. ``causal`` (default
    ``cfg.causal``): an encoder layer passes False."""
    b, s, _ = x.shape
    q, k, v = _project_qkv(p, cfg, x, positions)
    window = cfg.window if cfg.attention == "sliding" else None
    causal = cfg.causal if causal is None else causal
    out = _attend_chunked(q, k, v, causal, window)
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


def cross_attention_train(p: Dict[str, torch.Tensor], cfg: ModelConfig,
                          x: torch.Tensor, memory: torch.Tensor
                          ) -> torch.Tensor:
    """Decoder -> encoder cross-attention: x ``[B, S, d]`` attends over
    ``memory [B, Sm, d]`` with no mask and no RoPE (nor biases) on either
    side. Decode calls it with ``S = 1``."""
    b, s, _ = x.shape
    sm = memory.shape[1]
    h, hkv, dh = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    q = (x @ p["wq"]).reshape(b, s, h, dh)
    k = (memory @ p["wk"]).reshape(b, sm, hkv, dh)
    v = (memory @ p["wv"]).reshape(b, sm, hkv, dh)
    out = _attend_chunked(q, k, v, causal=False, window=None)
    return out.reshape(b, s, -1) @ p["wo"]


# ---------------------------------------------------------------------------
# MLA: multi-head latent attention (deepseek-v2)
# ---------------------------------------------------------------------------
def init_mla(cfg: ModelConfig, device: torch.device,
             gen: torch.Generator) -> Dict[str, torch.Tensor]:
    """The query path ``x -> q_lora -> per-head (nope + rope)`` and the KV
    path ``x -> (ckv, shared k_rope)``, ``ckv -> per-head K_nope / V``,
    with the reference's shapes and scales."""
    d, h = cfg.d_model, cfg.num_heads
    dn, dr, dv = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
    qr, kvr = cfg.q_lora_rank, cfg.kv_lora_rank
    dt = torch_dtype(cfg)
    s = (1.0 / d) ** 0.5
    return {"w_dq": normal((d, qr), s, dt, device, gen),
            "w_uq": normal((qr, h * (dn + dr)), (1.0 / qr) ** 0.5, dt,
                           device, gen),
            "w_dkv": normal((d, kvr + dr), s, dt, device, gen),
            "w_uk": normal((kvr, h * dn), (1.0 / kvr) ** 0.5, dt, device,
                           gen),
            "w_uv": normal((kvr, h * dv), (1.0 / kvr) ** 0.5, dt, device,
                           gen),
            "wo": normal((h * dv, d), (1.0 / (h * dv)) ** 0.5, dt, device,
                         gen)}


def _mla_qkv(p: Dict[str, torch.Tensor], cfg: ModelConfig, x: torch.Tensor,
             positions: torch.Tensor
             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                        torch.Tensor]:
    """``x [B, S, d]`` -> ``(q_nope [B, S, H, Dn], q_rope [B, S, H, Dr],
    ckv [B, S, kvr], k_rope [B, S, Dr])``; RoPE on the rope slices only."""
    b, s, _ = x.shape
    dn, dr = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim
    q = ((x @ p["w_dq"]) @ p["w_uq"]).reshape(b, s, cfg.num_heads, dn + dr)
    q_nope, q_rope = q[..., :dn], apply_rope(q[..., dn:], positions, cfg)
    ckv_full = x @ p["w_dkv"]                            # [B, S, kvr + dr]
    c_kv = ckv_full[..., :cfg.kv_lora_rank]
    k_rope = apply_rope(ckv_full[..., cfg.kv_lora_rank:][:, :, None, :],
                        positions, cfg)[:, :, 0]
    return q_nope, q_rope, c_kv, k_rope


def mla_train(p: Dict[str, torch.Tensor], cfg: ModelConfig, x: torch.Tensor,
              positions: torch.Tensor, return_kv: bool = False):
    """Full-sequence causal MLA in the expanded form: per-head
    ``K = [ckv W_uk, k_rope]`` and ``V = ckv W_uv`` through
    :func:`_attend_chunked`. With ``return_kv``, ``(out, ckv, k_rope)``:
    the latent cache prefill hands to decode."""
    b, s, _ = x.shape
    h = cfg.num_heads
    dn, dr, dv = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
    q_nope, q_rope, c_kv, k_rope = _mla_qkv(p, cfg, x, positions)
    k_nope = (c_kv @ p["w_uk"]).reshape(b, s, h, dn)
    v = (c_kv @ p["w_uv"]).reshape(b, s, h, dv)
    q = torch.cat([q_nope, q_rope], dim=-1)
    k = torch.cat([k_nope, k_rope[:, :, None, :].expand(b, s, h, dr)],
                  dim=-1)
    out = _attend_chunked(q, k, v, causal=True, window=None)
    out = out.reshape(b, s, h * dv) @ p["wo"]
    if return_kv:
        return out, c_kv, k_rope
    return out


def mla_decode(p: Dict[str, torch.Tensor], cfg: ModelConfig,
               x: torch.Tensor, cache_ckv: torch.Tensor,
               cache_krope: torch.Tensor, length: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One-token absorbed MLA decode. x: ``[B, 1, d]``; cache_ckv:
    ``[B, S, kvr]``; cache_krope: ``[B, S, Dr]``; length: ``[B]`` int32
    (the fill before this token).

    ``out = softmax(q_nope W_uk^T ckv + q_rope k_rope) (ckv W_uv) W_o``,
    in f32 over the latent cache. This token's ``ckv``/``krope`` rows are
    written into the caches IN PLACE at ``length``, as
    :func:`attention_decode` writes K/V; nothing reads the device from the
    host, so the step records into a CUDA graph. Returns ``(out [B, 1,
    d], cache_ckv, cache_krope)``."""
    b = x.shape[0]
    h = cfg.num_heads
    dn, dr, dv = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
    kvr = cfg.kv_lora_rank
    s_cache = cache_ckv.shape[1]
    q_nope, q_rope, c_kv, k_rope = _mla_qkv(p, cfg, x, length[:, None])
    rows = torch.arange(b, device=x.device)
    slot = length.long()
    cache_ckv[rows, slot] = c_kv[:, 0].to(cache_ckv.dtype)
    cache_krope[rows, slot] = k_rope[:, 0].to(cache_krope.dtype)
    ckv = cache_ckv.float()
    w_uk = p["w_uk"].reshape(kvr, h, dn).float()
    q_abs = torch.einsum("bhd,khd->bhk", q_nope[:, 0].float(), w_uk)
    logits = torch.einsum("bhk,bsk->bhs", q_abs, ckv)
    logits = logits + torch.einsum("bhd,bsd->bhs", q_rope[:, 0].float(),
                                   cache_krope.float())
    logits = logits * (dn + dr) ** -0.5
    valid = torch.arange(s_cache, device=x.device)[None, :] <= length[:, None]
    logits = torch.where(valid[:, None, :], logits,
                         torch.full((), -1e30, device=x.device))
    probs = torch.softmax(logits, dim=-1)
    ctx = torch.einsum("bhs,bsk->bhk", probs, ckv)
    w_uv = p["w_uv"].reshape(kvr, h, dv).float()
    out = torch.einsum("bhk,khd->bhd", ctx, w_uv)
    out = out.reshape(b, 1, h * dv).to(x.dtype)
    return out @ p["wo"], cache_ckv, cache_krope
