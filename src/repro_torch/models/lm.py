"""Decoder-only dense language model: init, prefill, KV cache, decode.

Structure (the reference's names, one entry per layer instead of its
scan-stacked leaves)::

    params = {
      "embed":      [V, d] token embedding
      "layers":     [{"ln1", "attn", "ln2", "ffn"}, ...]   one dict a layer
      "final_norm", "head" ([d, V], absent when tied)
    }
    cache = {"first_dense": [], "layers": {"k": [L, B, S, Hkv, Dh],
                                           "v": [L, B, S, Hkv, Dh]}}

The cache keeps the reference's stacked layout, so layer ``i`` attends over
the contiguous view ``cache["layers"]["k"][i]``. ``serve_step`` writes each
new K/V row into it in place.

This slice ports the homogeneous attention stack (dense and GQA families:
qwen3, qwen1.5, glm4, nemotron). Experts, MLA, block patterns (SSM,
hybrid), encoders and modality frontends raise ``NotImplementedError``.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import torch

from ..device import DeviceLike, resolve_device
from .attention import attention_decode, attention_train, init_attention
from .config import ModelConfig
from .layers import (apply_norm, ffn_forward, init_ffn, init_norm, normal,
                     torch_dtype)

Params = Dict
Cache = Dict


def check_supported(cfg: ModelConfig) -> None:
    """Raise ``NotImplementedError`` for a family this slice does not run."""
    missing = [what for what, on in (
        ("mixture-of-experts layers", cfg.num_experts > 0),
        ("MLA attention", cfg.mla),
        ("SSM/hybrid block patterns", bool(cfg.block_pattern)),
        ("an encoder", cfg.encoder_layers > 0),
        (f"the {cfg.frontend} frontend", cfg.frontend != "none")) if on]
    if missing:
        raise NotImplementedError(
            f"{cfg.name}: {', '.join(missing)} are not ported yet; the "
            f"port's LM runs dense attention stacks only (MoE, MLA, SSM and "
            f"enc-dec families are a later slice of the port)")


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------
def _init_layer(cfg: ModelConfig, device: torch.device,
                gen: torch.Generator) -> Dict:
    return {"ln1": init_norm(cfg, device),
            "attn": init_attention(cfg, device, gen),
            "ln2": init_norm(cfg, device),
            "ffn": init_ffn(cfg, device, gen)}


def init_model(cfg: ModelConfig, device: DeviceLike = "cuda",
               seed: int = 0) -> Params:
    """Seeded weights, made directly on ``device`` by a generator there,
    with the reference's distributions and scales (not its numbers)."""
    check_supported(cfg)
    device = resolve_device(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    dt = torch_dtype(cfg)
    params: Params = {
        "embed": normal((cfg.vocab_size, cfg.d_model), 0.02, dt, device,
                        gen),
        "final_norm": init_norm(cfg, device),
        "layers": [_init_layer(cfg, device, gen)
                   for _ in range(cfg.num_layers)],
    }
    if not cfg.tie_embeddings:
        params["head"] = normal((cfg.d_model, cfg.vocab_size),
                                (1.0 / cfg.d_model) ** 0.5, dt, device, gen)
    return params


def _head_weight(params: Params) -> torch.Tensor:
    return params["head"] if "head" in params else params["embed"].t()


# ---------------------------------------------------------------------------
# prefill
# ---------------------------------------------------------------------------
def _apply_layer_prefill(p: Dict, cfg: ModelConfig, x: torch.Tensor,
                         positions: torch.Tensor
                         ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One attention layer over the whole prompt; returns ``(x, {"k", "v"})``
    with this layer's cache entry ``[B, S, Hkv, Dh]``."""
    out, k, v = attention_train(p["attn"], cfg, apply_norm(p["ln1"], x),
                                positions, return_kv=True)
    x = x + out
    x = x + ffn_forward(p["ffn"], cfg, apply_norm(p["ln2"], x))
    return x, {"k": k, "v": v}


def prefill_step(params: Params, cfg: ModelConfig,
                 batch: Dict[str, torch.Tensor]
                 ) -> Tuple[torch.Tensor, Cache, torch.Tensor]:
    """Process a full prompt; returns ``(last-token logits [B, V] f32,
    cache, lengths [B])``. The cache is sized exactly to the prompt:
    :func:`grow_cache` makes room for decode."""
    check_supported(cfg)
    tokens = batch["tokens"]
    b, s = tokens.shape
    x = params["embed"][tokens]
    positions = torch.arange(s, device=tokens.device)[None, :]
    ks: List[torch.Tensor] = []
    vs: List[torch.Tensor] = []
    for lp in params["layers"]:
        x, c = _apply_layer_prefill(lp, cfg, x, positions)
        ks.append(c["k"])
        vs.append(c["v"])
    h = apply_norm(params["final_norm"], x)
    logits = (h[:, -1] @ _head_weight(params)).float()
    cache = {"first_dense": [],
             "layers": {"k": torch.stack(ks), "v": torch.stack(vs)}}
    lengths = torch.full((b,), s, dtype=torch.int32, device=tokens.device)
    return logits, cache, lengths


def grow_cache(cache: Cache, target_len: int) -> Cache:
    """The cache with its sequence axis grown to ``target_len``: allocated
    once at full length, the prefill's K/V copied in, the rest zero."""
    out = dict(cache)
    layers = {}
    for name, t in cache["layers"].items():
        s = t.shape[2]
        if s >= target_len:
            layers[name] = t
            continue
        grown = t.new_zeros(t.shape[:2] + (target_len,) + t.shape[3:])
        grown[:, :, :s] = t
        layers[name] = grown
    out["layers"] = layers
    return out


# ---------------------------------------------------------------------------
# serving: cache init + single-token decode
# ---------------------------------------------------------------------------
def init_cache(cfg: ModelConfig, batch: int, seq_len: int,
               device: DeviceLike = "cuda") -> Cache:
    """Zero KV cache ``[L, B, S, Hkv, Dh]``; a sliding-window config's is
    only ``cfg.window`` long (a ring buffer)."""
    check_supported(cfg)
    device = resolve_device(device)
    s_att = min(seq_len, cfg.window) if cfg.attention == "sliding" \
        else seq_len
    shape = (cfg.num_layers, batch, s_att, cfg.num_kv_heads, cfg.head_dim)
    dt = torch_dtype(cfg)
    return {"first_dense": [],
            "layers": {"k": torch.zeros(shape, dtype=dt, device=device),
                       "v": torch.zeros(shape, dtype=dt, device=device)}}


def _decode_attn_layer(lp: Dict, cfg: ModelConfig, x: torch.Tensor,
                       cache_k: torch.Tensor, cache_v: torch.Tensor,
                       length: torch.Tensor) -> torch.Tensor:
    out, _, _ = attention_decode(lp["attn"], cfg, apply_norm(lp["ln1"], x),
                                 cache_k, cache_v, length)
    x = x + out
    return x + ffn_forward(lp["ffn"], cfg, apply_norm(lp["ln2"], x))


def serve_step(params: Params, cfg: ModelConfig, tokens: torch.Tensor,
               cache: Cache, lengths: torch.Tensor
               ) -> Tuple[torch.Tensor, Cache]:
    """Decode ONE token. tokens: ``[B, 1]``; lengths: ``[B]`` int32 (the
    current cache fill). Returns ``(logits [B, V] f32, cache)``: the same
    cache object, with this token's K/V written in place."""
    check_supported(cfg)
    x = params["embed"][tokens]                      # [B, 1, d]
    ck, cv = cache["layers"]["k"], cache["layers"]["v"]
    for i, lp in enumerate(params["layers"]):
        x = _decode_attn_layer(lp, cfg, x, ck[i], cv[i], lengths)
    h = apply_norm(params["final_norm"], x)
    logits = (h[:, 0] @ _head_weight(params)).float()
    return logits, cache
