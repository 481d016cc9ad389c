"""Language model (decoder-only: dense, MoE, SSM, hybrid and VLM; and
encoder-decoder): init, the train forward and its chunked loss, prefill,
KV cache and recurrent state, decode.

Structure (the reference's names, one entry per layer instead of its
scan-stacked leaves)::

    params = {
      "embed":      [V, d] token embedding
      "first_dense": [{"ln1", "attn", "ln2", "ffn"}, ...]  (deepseek-v2)
      "layers":     [{"ln1", "attn", "ln2", "ffn"}, ...]   one dict a layer
      "shared_attn": {"ln1", "attn", "ln2", "ffn"}          (zamba2)
      "encoder":    {"layers": [{"ln1", "attn", "ln2", "ffn"}, ...],
                     "final_norm"}                         (seamless)
      "final_norm", "head" ([d, V], absent when tied)
    }
    attn = {"wq", "wk", "wv", "wo", ...}                   GQA
    attn = {"w_dq", "w_uq", "w_dkv", "w_uk", "w_uv", "wo"} MLA
    ffn = {"w_gate", "w_up", "w_out"}                      a dense layer's
    ffn = {"router", "w_gate", "w_up", "w_out", "shared": [ffn, ...]}
                                                           an MoE layer's

An enc-dec model's decoder layers also hold ``ln_cross`` and ``cross``
(GQA weights): after self-attention each attends over the encoder's
output, ``memory [B, Se, d]``, with no mask and no RoPE. The encoder's
layers (kind ``enc_attn``) are bidirectional self-attention and a dense
FFN over the stub frame embeddings ``frames [B, Se, d]``, then a final
norm. Prefill runs the encoder once and keeps ``memory`` in the cache
(``cache["memory"]``, beside ``layers``); decode reads it at every step
and recomputes each layer's cross K/V from it, as the reference does, and
:func:`grow_cache` leaves it as it is. A VLM's ``patch_embeds [B, P, d]``
replace the embeddings of a prompt's first ``P`` positions, in training
and in prefill; a prompt shorter than ``P`` raises ``ValueError`` (the
reference fails there on a broadcast).

An MoE stack with ``first_k_dense`` leading dense layers (deepseek-v2)
keeps them apart, as the reference does: ``first_dense`` holds those
layers and ``layers`` the ``num_layers - first_k_dense`` MoE layers after
them.

A homogeneous attention stack (no block pattern, ``scan_layers``) keeps
the reference's stacked cache, so layer ``i`` of ``layers`` attends over
the contiguous view ``cache["layers"]["k"][i]``; the leading dense
layers' entries are a list. An MLA model caches its latent ``ckv`` and
shared ``krope`` in place of K/V::

    cache = {"first_dense": [], "layers": {"k": [L, B, S, Hkv, Dh],
                                           "v": [L, B, S, Hkv, Dh]}}
    cache = {"first_dense": [{"ckv": [B, S, kvr], "krope": [B, S, Dr]},
                             ...],
             "layers": {"ckv": [L', B, S, kvr], "krope": [L', B, S, Dr]}}

A block pattern (``cfg.blocks``: ``mlstm``, ``slstm``, ``mamba``,
``attn``, ``shared_attn``) takes the reference's per-layer layout: each
``layers`` entry holds its kind's block (:mod:`repro_torch.models.ssm`:
norm, block, residual, no FFN) or an attention layer, ``{}`` at a
``shared_attn`` position, whose weights are ``params["shared_attn"]``,
one layer applied at each such position (its gradient is the sum over
its applications)::

    cache = {"layers": [{"k", "v"} | mamba {"ssm", "conv"}
                        | mlstm {"S", "n"} | slstm {"h", "c", "n", "m"},
                        ...]}

``serve_step`` writes each new K/V (or ckv/krope) row into the cache in
place, and
copies each block's new state into the cache's own tensors, so a decode
captured with the cache bound by address reads and writes the live state.

Training (:func:`train_loss`) loops over the layers, each wrapped in
:func:`_remat` when ``cfg.remat`` is set, and takes the next-token loss in
sequence chunks (:func:`chunked_ce_loss`): each chunk's ``[B, c, V]``
logits are computed, reduced and dropped, and recomputed in the backward,
so no more than one chunk's logits ever exists.

The port runs every family of the reference: the homogeneous attention
stack (dense and GQA families: qwen3, qwen1.5, glm4, nemotron), its
mixture-of-experts variant, every layer's FFN after the leading dense ones
a :mod:`repro_torch.models.moe` layer (qwen2-moe, deepseek-v2): its
router's aux loss adds into the training loss, prefill drops it, decode
runs :func:`moe_decode`; MLA attention (deepseek-v2: prefill expanded,
decode absorbed); the block patterns of the SSM (xlstm) and hybrid
(zamba2) families; the enc-dec family (seamless-m4t) and the VLM
(phi-3-vision) with their frontends' stub inputs.
"""
from __future__ import annotations

import functools
from typing import Callable, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from ..device import DeviceLike, resolve_device
from .attention import (attention_decode, attention_train,
                        cross_attention_train, init_attention, init_mla,
                        mla_decode, mla_train)
from .config import ModelConfig
from .layers import (apply_norm, ffn_forward, init_ffn, init_norm, normal,
                     torch_dtype)
from .moe import init_moe, moe_decode, moe_forward
from .ssm import BLOCKS

Params = Dict
Cache = Dict
LOSS_CHUNK = 512
# the products the "dots" policy keeps: matmuls without batch dims, as
# jax.checkpoint_policies.dots_with_no_batch_dims_saveable (x @ W folds
# to mm; attention's einsums are batched, bmm, and are recomputed)
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def per_layer(cfg: ModelConfig) -> bool:
    """Whether ``cfg`` takes the reference's per-layer layout (a block
    pattern, or layers not scan-stacked) rather than its stacked cache."""
    return bool(cfg.block_pattern) or not cfg.scan_layers


def first_dense(cfg: ModelConfig) -> int:
    """How many leading dense layers a homogeneous MoE stack keeps apart
    in ``params["first_dense"]`` (0 for every other layout, where
    ``cfg.is_moe_layer`` tells each layer's FFN)."""
    if cfg.num_experts == 0 or per_layer(cfg):
        return 0
    return cfg.first_k_dense


def _layer(params: Params, i: int, kind: str
           ) -> Tuple[Dict, str]:
    """Layer ``i``'s weights and the kind they run as: the shared block's
    for a ``shared_attn`` position, an attention layer's."""
    if kind == "shared_attn":
        return params["shared_attn"], "attn"
    return params["layers"][i], kind


def _layers(params: Params, cfg: ModelConfig
            ) -> List[Tuple[Dict, str, bool]]:
    """Every layer in order as ``(weights, kind, moe)``: a homogeneous
    stack's leading dense layers, then ``params["layers"]``."""
    if per_layer(cfg):
        return [(*_layer(params, i, kind), cfg.is_moe_layer(i))
                for i, kind in enumerate(cfg.blocks)]
    moe = cfg.num_experts > 0
    return ([(lp, "attn", False) for lp in params.get("first_dense", [])]
            + [(lp, "attn", moe) for lp in params["layers"]])


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------
def _init_layer(cfg: ModelConfig, device: torch.device,
                gen: torch.Generator, kind: str, moe: bool) -> Dict:
    """One layer: a block, a decoder attention layer (with ``ln_cross``
    and ``cross`` in an enc-dec model) or an encoder layer
    (``enc_attn``: GQA self-attention and a dense FFN)."""
    if kind in BLOCKS:
        return {"ln1": init_norm(cfg, device),
                kind: BLOCKS[kind].init(cfg, device, gen)}
    if kind == "enc_attn":
        return {"ln1": init_norm(cfg, device),
                "attn": init_attention(cfg, device, gen),
                "ln2": init_norm(cfg, device),
                "ffn": init_ffn(cfg, device, gen)}
    if kind != "attn":
        raise ValueError(kind)
    p = {"ln1": init_norm(cfg, device),
         "attn": (init_mla(cfg, device, gen) if cfg.mla
                  else init_attention(cfg, device, gen))}
    if cfg.encoder_layers:              # the decoder of an enc-dec model
        p["ln_cross"] = init_norm(cfg, device)
        p["cross"] = init_attention(cfg, device, gen)
    p["ln2"] = init_norm(cfg, device)
    p["ffn"] = (init_moe(cfg, device, gen) if moe
                else init_ffn(cfg, device, gen))
    return p


def init_model(cfg: ModelConfig, device: DeviceLike = "cuda",
               seed: int = 0) -> Params:
    """Seeded weights, made directly on ``device`` by a generator there,
    with the reference's distributions and scales (not its numbers)."""
    device = resolve_device(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    dt = torch_dtype(cfg)
    n_fd = first_dense(cfg)
    params: Params = {
        "embed": normal((cfg.vocab_size, cfg.d_model), 0.02, dt, device,
                        gen),
        "final_norm": init_norm(cfg, device),
        # {} at a shared_attn position: its weights are params["shared_attn"]
        "layers": [{} if kind == "shared_attn" else
                   _init_layer(cfg, device, gen, kind, cfg.is_moe_layer(i))
                   for i, kind in enumerate(cfg.blocks) if i >= n_fd],
    }
    if n_fd:
        params["first_dense"] = [_init_layer(cfg, device, gen, "attn",
                                             moe=False)
                                 for _ in range(n_fd)]
    if "shared_attn" in cfg.blocks:
        params["shared_attn"] = _init_layer(cfg, device, gen, "attn",
                                            moe=False)
    if not cfg.tie_embeddings:
        params["head"] = normal((cfg.d_model, cfg.vocab_size),
                                (1.0 / cfg.d_model) ** 0.5, dt, device, gen)
    if cfg.encoder_layers:
        params["encoder"] = {
            "layers": [_init_layer(cfg, device, gen, "enc_attn", moe=False)
                       for _ in range(cfg.encoder_layers)],
            "final_norm": init_norm(cfg, device)}
    return params


def _head_weight(params: Params) -> torch.Tensor:
    return params["head"] if "head" in params else params["embed"].t()


# ---------------------------------------------------------------------------
# train forward
# ---------------------------------------------------------------------------
def _dots_policy(ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if op in _DOTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _remat(f: Callable, cfg: ModelConfig) -> Callable:
    """Per-layer activation checkpointing with the configured policy:
    ``"full"`` keeps only the layer's input, ``"dots"`` also its
    matmuls' outputs. No RNG state is kept (the LM has no dropout), so a
    captured step never reads a generator's state."""
    if not cfg.remat:
        return f
    kwargs = dict(use_reentrant=False, preserve_rng_state=False)
    if cfg.remat_policy == "dots":
        kwargs["context_fn"] = functools.partial(
            create_selective_checkpoint_contexts, _dots_policy)
    return functools.partial(checkpoint, f, **kwargs)


def _cross(p: Dict, cfg: ModelConfig, x: torch.Tensor,
           memory: Optional[torch.Tensor]) -> torch.Tensor:
    """``x`` plus the layer's cross-attention over ``memory`` where the
    layer has one (an enc-dec decoder layer) and memory is given."""
    if "cross" not in p or memory is None:
        return x
    return x + cross_attention_train(p["cross"], cfg,
                                     apply_norm(p["ln_cross"], x), memory)


def _apply_layer_train(p: Dict, cfg: ModelConfig, kind: str, moe: bool,
                       x: torch.Tensor, positions: torch.Tensor,
                       memory: Optional[torch.Tensor] = None
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One layer over the whole sequence; returns ``(x, aux_loss)``: a
    decoder attention layer (causal; its cross-attention over ``memory``
    in an enc-dec model), an encoder layer (``enc_attn``: bidirectional),
    dense (aux loss 0) or MoE (its router's aux loss), or a block of
    :mod:`repro_torch.models.ssm` (aux loss 0)."""
    if kind in BLOCKS:
        out, _ = BLOCKS[kind].forward(p[kind], cfg, apply_norm(p["ln1"], x))
        return x + out, torch.zeros((), dtype=torch.float32,
                                    device=x.device)
    if kind not in ("attn", "enc_attn"):
        raise ValueError(kind)
    h = apply_norm(p["ln1"], x)
    if cfg.mla and kind == "attn":
        x = x + mla_train(p["attn"], cfg, h, positions)
    else:
        x = x + attention_train(p["attn"], cfg, h, positions,
                                causal=kind == "attn")
    x = _cross(p, cfg, x, memory)
    h = apply_norm(p["ln2"], x)
    if moe:
        out, aux = moe_forward(p["ffn"], cfg, h)
        return x + out, aux
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return x + ffn_forward(p["ffn"], cfg, h), aux


def _with_patches(x: torch.Tensor,
                  patch_embeds: Optional[torch.Tensor]) -> torch.Tensor:
    """The embedded prompt ``x [B, S, d]`` with a VLM's ``patch_embeds
    [B, P, d]`` (cast to x's dtype) in place of its first ``P``
    positions. ``S < P`` raises ``ValueError``: the reference's
    concatenation would lengthen the hidden states past the positions
    (it fails on a broadcast)."""
    if patch_embeds is None:
        return x
    n = patch_embeds.shape[1]
    if x.shape[1] < n:
        raise ValueError(
            f"a prompt of {x.shape[1]} tokens is shorter than its {n} "
            f"image patch tokens (num_patch_tokens): a VLM prompt holds "
            f"at least num_patch_tokens positions")
    return torch.cat([patch_embeds.to(x.dtype), x[:, n:]], dim=1)


def _run_encoder(params: Params, cfg: ModelConfig,
                 frames: torch.Tensor) -> torch.Tensor:
    """The bidirectional encoder over the stub frame embeddings ``[B, Se,
    d]`` (each layer under :func:`_remat`), then its final norm: the
    decoder's ``memory [B, Se, d]``."""
    enc = params["encoder"]
    pos = torch.arange(frames.shape[1], device=frames.device)[None, :]
    x = frames
    for lp in enc["layers"]:
        f = _remat(functools.partial(_apply_layer_train, lp, cfg,
                                     "enc_attn", False), cfg)
        x, _ = f(x, pos)
    return apply_norm(enc["final_norm"], x)


def model_hidden_train(params: Params, cfg: ModelConfig,
                       tokens: torch.Tensor,
                       patch_embeds: Optional[torch.Tensor] = None,
                       frames: Optional[torch.Tensor] = None
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Token ids ``[B, S]`` (a VLM's ``patch_embeds`` in place of the
    first positions; an enc-dec model's encoder over ``frames``) ->
    ``(final hidden states [B, S, d], aux loss)``. The embedding lookup is
    ``F.embedding``, whose backward (the step's one scatter) is
    deterministic."""
    x = _with_patches(F.embedding(tokens.long(), params["embed"]),
                      patch_embeds)
    memory = _run_encoder(params, cfg, frames) if frames is not None \
        else None
    positions = torch.arange(tokens.shape[1], device=tokens.device)[None, :]
    aux_total = torch.zeros((), dtype=torch.float32, device=tokens.device)
    for lp, kind, moe in _layers(params, cfg):
        f = _remat(functools.partial(_apply_layer_train, lp, cfg, kind,
                                     moe), cfg)
        x, a = f(x, positions, memory)
        aux_total = aux_total + a
    return apply_norm(params["final_norm"], x), aux_total


def _chunk_nll(h: torch.Tensor, w_head: torch.Tensor, labels: torch.Tensor,
               mask: torch.Tensor) -> torch.Tensor:
    """The masked NLL sum of one chunk: ``h [B, c, d]``."""
    logits = (h @ w_head).float()                       # [B, c, V]
    logz = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, labels.long()[..., None])[..., 0]
    return ((logz - gold) * mask).sum()


def chunked_ce_loss(h: torch.Tensor, w_head: torch.Tensor,
                    labels: torch.Tensor, mask: torch.Tensor,
                    chunk: int = LOSS_CHUNK) -> torch.Tensor:
    """Next-token CE, the masked mean over ``[B, S]``, in chunks of
    ``chunk`` positions (the last padded, its padding masked), as the
    reference's scan. Each chunk is checkpointed when autograd records:
    its ``[B, c, V]`` logits are dropped after the forward and recomputed
    in the backward, one chunk at a time. The gold logit is a gather (the
    reference's one-hot sum keeps a vocab-sharded axis sharded; on one
    device both give the same number)."""
    b, s, _ = h.shape
    c = min(chunk, s)
    nc = -(-s // c)
    pad = nc * c - s
    if pad:
        h = F.pad(h, (0, 0, 0, pad))
        labels = F.pad(labels, (0, pad))
        mask = F.pad(mask, (0, pad))
    tot = torch.zeros((), dtype=torch.float32, device=h.device)
    cnt = torch.zeros((), dtype=torch.float32, device=h.device)
    for i in range(nc):
        sl = slice(i * c, (i + 1) * c)
        args = (h[:, sl], w_head, labels[:, sl], mask[:, sl])
        if torch.is_grad_enabled():
            nll = checkpoint(_chunk_nll, *args, use_reentrant=False,
                             preserve_rng_state=False)
        else:
            nll = _chunk_nll(*args)
        tot = tot + nll
        cnt = cnt + mask[:, sl].sum()
    return tot / torch.clamp(cnt, min=1.0)


def train_loss(params: Params, cfg: ModelConfig,
               batch: Dict[str, torch.Tensor]) -> torch.Tensor:
    """batch: ``tokens [B, S]``, ``loss_mask [B, S]`` (+ ``patch_embeds``
    / ``frames``). Position ``i`` predicts token ``i + 1``; the last
    position has no label and is masked."""
    tokens = batch["tokens"]
    h, aux = model_hidden_train(params, cfg, tokens,
                                batch.get("patch_embeds"),
                                batch.get("frames"))
    labels = F.pad(tokens[:, 1:], (0, 1))
    mask = F.pad(batch["loss_mask"][:, 1:], (0, 1)).float()
    loss = chunked_ce_loss(h, _head_weight(params), labels, mask)
    return loss + cfg.router_aux_weight * aux


# ---------------------------------------------------------------------------
# prefill
# ---------------------------------------------------------------------------
def _apply_layer_prefill(p: Dict, cfg: ModelConfig, kind: str, moe: bool,
                         x: torch.Tensor, positions: torch.Tensor,
                         memory: Optional[torch.Tensor] = None
                         ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One layer over the whole prompt; returns ``(x, cache entry)``: an
    attention layer's ``{"k", "v"}`` ``[B, S, Hkv, Dh]`` (its
    cross-attention over ``memory`` after self-attention, in an enc-dec
    model) or, for MLA, ``{"ckv" [B, S, kvr], "krope" [B, S, Dr]}`` (an
    MoE layer's aux loss is dropped, as in the reference), or a block's
    final state (mamba's with its conv tail)."""
    if kind in BLOCKS:
        fwd = BLOCKS[kind].forward
        h = apply_norm(p["ln1"], x)
        out, c = (fwd(p[kind], cfg, h, return_state=True) if kind == "mamba"
                  else fwd(p[kind], cfg, h))
        return x + out, c
    h = apply_norm(p["ln1"], x)
    if cfg.mla:
        out, ckv, krope = mla_train(p["attn"], cfg, h, positions,
                                    return_kv=True)
        entry = {"ckv": ckv, "krope": krope}
    else:
        out, k, v = attention_train(p["attn"], cfg, h, positions,
                                    return_kv=True)
        entry = {"k": k, "v": v}
    x = _cross(p, cfg, x + out, memory)
    h = apply_norm(p["ln2"], x)
    x = x + (moe_forward(p["ffn"], cfg, h)[0] if moe
             else ffn_forward(p["ffn"], cfg, h))
    return x, entry


def prefill_step(params: Params, cfg: ModelConfig,
                 batch: Dict[str, torch.Tensor]
                 ) -> Tuple[torch.Tensor, Cache, torch.Tensor]:
    """Process a full prompt; returns ``(last-token logits [B, V] f32,
    cache, lengths [B])``. The cache is sized exactly to the prompt:
    :func:`grow_cache` makes room for decode. ``batch`` holds ``tokens
    [B, S]`` and, for a VLM, ``patch_embeds [B, P, d]`` (``S < P``
    raises ``ValueError``), for an enc-dec model ``frames [B, Se, d]``,
    whose encoding the cache keeps as ``memory``."""
    tokens = batch["tokens"]
    b, s = tokens.shape
    x = _with_patches(params["embed"][tokens], batch.get("patch_embeds"))
    frames = batch.get("frames")
    memory = _run_encoder(params, cfg, frames) if frames is not None \
        else None
    positions = torch.arange(s, device=tokens.device)[None, :]
    entries: List[Dict[str, torch.Tensor]] = []
    for lp, kind, moe in _layers(params, cfg):
        x, c = _apply_layer_prefill(lp, cfg, kind, moe, x, positions,
                                    memory)
        entries.append(c)
    h = apply_norm(params["final_norm"], x)
    logits = (h[:, -1] @ _head_weight(params)).float()
    if per_layer(cfg):
        cache: Cache = {"layers": entries}
    else:
        n_fd = first_dense(cfg)
        stack = entries[n_fd:]
        cache = {"first_dense": entries[:n_fd],
                 "layers": {n: torch.stack([c[n] for c in stack])
                            for n in stack[0]}}
    if memory is not None:
        cache["memory"] = memory
    lengths = torch.full((b,), s, dtype=torch.int32, device=tokens.device)
    return logits, cache, lengths


def _grow(t: torch.Tensor, axis: int, target_len: int) -> torch.Tensor:
    """``t`` with ``axis`` grown to ``target_len``: allocated once at full
    length, ``t`` copied in, the rest zero."""
    s = t.shape[axis]
    if s >= target_len:
        return t
    shape = list(t.shape)
    shape[axis] = target_len
    grown = t.new_zeros(shape)
    grown.narrow(axis, 0, s).copy_(t)
    return grown


SEQ_LEAVES = ("k", "v", "ckv", "krope")


def _grow_entries(entries: List[Dict[str, torch.Tensor]], target_len: int
                  ) -> List[Dict[str, torch.Tensor]]:
    """Per-layer cache entries with their sequence axis (1) grown; a
    recurrent state keeps its shape and is copied."""
    return [{n: (_grow(t, 1, target_len) if n in SEQ_LEAVES else t.clone())
             for n, t in c.items()} for c in entries]


def grow_cache(cache: Cache, target_len: int) -> Cache:
    """The cache with its K/V (or ckv/krope) sequence axis grown to
    ``target_len``, the leading dense layers' entries too. A per-layer
    cache's recurrent states keep their shapes and are copied, so the
    grown cache owns every tensor that decode writes in place. An
    enc-dec cache's ``memory``, which decode only reads, is the same
    tensor in both."""
    out = dict(cache)
    if isinstance(cache["layers"], list):
        out["layers"] = _grow_entries(cache["layers"], target_len)
    else:
        if "first_dense" in cache:
            out["first_dense"] = _grow_entries(cache["first_dense"],
                                               target_len)
        out["layers"] = {n: _grow(t, 2, target_len)
                         for n, t in cache["layers"].items()}
    return out


# ---------------------------------------------------------------------------
# serving: cache init + single-token decode
# ---------------------------------------------------------------------------
def _attn_cache(cfg: ModelConfig, lead: Tuple[int, ...], batch: int,
                seq_len: int, device: torch.device) -> Dict[str, torch.Tensor]:
    """One attention cache entry of zeros, ``lead`` axes first: K/V
    ``[B, S, Hkv, Dh]`` (a sliding config's only ``cfg.window`` long) or
    MLA's ``ckv [B, S, kvr]`` and ``krope [B, S, Dr]``."""
    dt = torch_dtype(cfg)
    if cfg.mla:
        widths = {"ckv": (cfg.kv_lora_rank,),
                  "krope": (cfg.qk_rope_head_dim,)}
    else:
        widths = {"k": (cfg.num_kv_heads, cfg.head_dim),
                  "v": (cfg.num_kv_heads, cfg.head_dim)}
        if cfg.attention == "sliding":
            seq_len = min(seq_len, cfg.window)
    return {n: torch.zeros(lead + (batch, seq_len) + w, dtype=dt,
                           device=device) for n, w in widths.items()}


def init_cache(cfg: ModelConfig, batch: int, seq_len: int,
               device: DeviceLike = "cuda", enc_len: int = 0) -> Cache:
    """Zero cache: K/V ``[L, B, S, Hkv, Dh]`` (MLA: ckv/krope ``[L, B,
    S, R]``) for a homogeneous stack, a sliding-window config's only
    ``cfg.window`` long (a ring buffer), with a list entry for each
    leading dense layer; per layer for a block pattern, each block's zero
    state; an enc-dec model's ``memory [B, enc_len, d]``."""
    device = resolve_device(device)
    if not per_layer(cfg):
        n_fd = first_dense(cfg)
        cache = {"first_dense": [_attn_cache(cfg, (), batch, seq_len,
                                             device) for _ in range(n_fd)],
                 "layers": _attn_cache(cfg, (cfg.num_layers - n_fd,), batch,
                                       seq_len, device)}
    else:
        cache = {"layers": [
            BLOCKS[kind].zero_state(cfg, batch, device) if kind in BLOCKS
            else _attn_cache(cfg, (), batch, seq_len, device)
            for kind in cfg.blocks]}
    if cfg.encoder_layers:
        cache["memory"] = torch.zeros((batch, enc_len, cfg.d_model),
                                      dtype=torch_dtype(cfg), device=device)
    return cache


def _decode_attn_layer(lp: Dict, cfg: ModelConfig, x: torch.Tensor,
                       c: Dict[str, torch.Tensor], length: torch.Tensor,
                       memory: Optional[torch.Tensor] = None
                       ) -> torch.Tensor:
    """One attention layer's decode step over its cache entry ``c``
    (``{"k", "v"}``, or MLA's ``{"ckv", "krope"}``), written in place;
    an enc-dec decoder layer's cross-attention over ``memory`` after
    it."""
    h = apply_norm(lp["ln1"], x)
    if cfg.mla:
        out, _, _ = mla_decode(lp["attn"], cfg, h, c["ckv"], c["krope"],
                               length)
    else:
        out, _, _ = attention_decode(lp["attn"], cfg, h, c["k"], c["v"],
                                     length)
    x = _cross(lp, cfg, x + out, memory)
    h = apply_norm(lp["ln2"], x)
    if "router" in lp["ffn"]:
        return x + moe_decode(lp["ffn"], cfg, h)
    return x + ffn_forward(lp["ffn"], cfg, h)


def _decode_block(lp: Dict, cfg: ModelConfig, kind: str, x: torch.Tensor,
                  state: Dict[str, torch.Tensor]) -> torch.Tensor:
    """One block's decode step; its new state is copied into ``state``'s
    own tensors (each new value is a fresh tensor, never a view of the
    old state)."""
    out, new = BLOCKS[kind].decode(lp[kind], cfg,
                                   apply_norm(lp["ln1"], x), state)
    for name, t in new.items():
        state[name].copy_(t)
    return x + out


def serve_step(params: Params, cfg: ModelConfig, tokens: torch.Tensor,
               cache: Cache, lengths: torch.Tensor
               ) -> Tuple[torch.Tensor, Cache]:
    """Decode ONE token. tokens: ``[B, 1]``; lengths: ``[B]`` int32 (the
    current cache fill). Returns ``(logits [B, V] f32, cache)``: the same
    cache object, with this token's K/V rows and every block's new state
    written in place (an enc-dec cache's ``memory`` is read, not
    written)."""
    x = params["embed"][tokens]                      # [B, 1, d]
    memory = cache.get("memory") if cfg.encoder_layers else None
    if per_layer(cfg):
        for i, kind in enumerate(cfg.blocks):
            lp, kind = _layer(params, i, kind)
            c = cache["layers"][i]
            if kind in BLOCKS:
                x = _decode_block(lp, cfg, kind, x, c)
            else:
                x = _decode_attn_layer(lp, cfg, x, c, lengths, memory)
    else:
        for lp, c in zip(params.get("first_dense", []),
                         cache["first_dense"], strict=True):
            x = _decode_attn_layer(lp, cfg, x, c, lengths, memory)
        stacked = cache["layers"]
        for i, lp in enumerate(params["layers"]):
            x = _decode_attn_layer(lp, cfg, x,
                                   {n: t[i] for n, t in stacked.items()},
                                   lengths, memory)
    h = apply_norm(params["final_norm"], x)
    logits = (h[:, 0] @ _head_weight(params)).float()
    return logits, cache
