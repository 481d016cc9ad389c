"""Mixture-of-experts layers: the reference's ``repro.models.moe`` on
PyTorch tensors.

Prefill and training (:func:`moe_forward`) dispatch as the reference
does, with one-hot products and no data-dependent shapes: each batch row
is a group, each (row, expert) has ``cap`` slots, tokens take slots in
routing-priority order (the top choice of every token first, then the
second, ...; within one choice in sequence order), and a token that finds
its expert's slots full is dropped from that expert. The ``[B, E, C, d]``
buffer runs through every expert's FFN as one batched product. Decode
(:func:`moe_decode`) has no capacity: each token runs its top-k experts,
whose weights are gathered per (row, choice).

Every shape is known before the run and nothing reads the device from the
host (no ``.item()``, ``nonzero`` or boolean-mask indexing): both
functions record into a CUDA graph, the captured decode step and the
captured train step. The one-hot masks are comparisons against an
``arange``, which, like ``jax.nn.one_hot``, give a zero row for a slot
index past the capacity.

Shared experts run densely on every token (:func:`ffn_forward`). The
router computes in f32 and adds the Switch load-balance loss,
``num_experts * sum_e mean(probs)_e * frac(top-1)_e`` over the padded E.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from .config import ModelConfig
from .layers import ffn_forward, init_ffn, normal, torch_dtype


def _padded_e(cfg: ModelConfig) -> int:
    return max(cfg.experts_pad_to, cfg.num_experts)


def init_moe(cfg: ModelConfig, device: torch.device,
             gen: torch.Generator) -> Dict:
    """Router (f32), expert weights ``[E, d, f]`` / ``[E, f, d]`` and the
    shared experts, with the reference's scales."""
    d, e, f = cfg.d_model, _padded_e(cfg), cfg.moe_d_ff
    dt = torch_dtype(cfg)
    s_in, s_out = (2.0 / d) ** 0.5, (2.0 / f) ** 0.5
    p = {"router": normal((d, e), s_in, torch.float32, device, gen),
         "w_gate": normal((e, d, f), s_in, dt, device, gen),
         "w_up": normal((e, d, f), s_in, dt, device, gen),
         "w_out": normal((e, f, d), s_out, dt, device, gen)}
    if cfg.num_shared_experts:
        p["shared"] = [init_ffn(cfg, device, gen, d_ff=cfg.moe_d_ff)
                       for _ in range(cfg.num_shared_experts)]
    return p


def _one_hot(idx: torch.Tensor, n: int) -> torch.Tensor:
    """f32 one-hot of ``idx`` over ``n`` classes; an index outside
    ``[0, n)`` gives a zero row."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).float()


def _route(p: Dict, cfg: ModelConfig, x: torch.Tensor
           ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``x [..., d]`` -> (probs ``[..., E]``, renormalised top-k gates and
    their experts ``[..., K]``); padding experts are never routed."""
    logits = x.float() @ p["router"]
    e = logits.shape[-1]
    if e > cfg.num_experts:
        pad = torch.arange(e, device=x.device) >= cfg.num_experts
        logits = logits.masked_fill(pad, -1e30)
    probs = torch.softmax(logits, dim=-1)
    gate, idx = torch.topk(probs, cfg.top_k, dim=-1)
    gate = gate / gate.sum(-1, keepdim=True).clamp_min(1e-9)
    return probs, gate, idx


def _shared(p: Dict, cfg: ModelConfig, x: torch.Tensor,
            out: torch.Tensor) -> torch.Tensor:
    for sp in p.get("shared", []):
        out = out + ffn_forward(sp, cfg, x)
    return out


def moe_forward(p: Dict, cfg: ModelConfig, x: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``x [B, S, d]`` -> ``(out [B, S, d], aux loss f32 scalar)``.
    Capacity per (row, expert): ``int(capacity_factor * K * S / E_real) +
    1`` slots, of the padded length ``S``."""
    b, s, _ = x.shape
    e, k = _padded_e(cfg), cfg.top_k
    probs, gate, idx = _route(p, cfg, x)                     # [B, S, E/K]

    me = probs.reshape(-1, e).mean(dim=0)
    ce = _one_hot(idx[..., 0].reshape(-1), e).mean(dim=0)   # token fraction
    aux = cfg.num_experts * (me * ce).sum()

    cap = int(cfg.capacity_factor * k * s / cfg.num_experts) + 1
    dispatch = x.new_zeros((b, s, e, cap))                   # [B, S, E, C]
    combine = torch.zeros((b, s, e, cap), dtype=torch.float32,
                          device=x.device)
    offset = torch.zeros((b, 1, e), dtype=torch.float32, device=x.device)
    for kk in range(k):
        m = _one_hot(idx[..., kk], e)                        # [B, S, E]
        pos = torch.cumsum(m, dim=1) - m + offset            # slot before it
        valid = m * (pos < cap)
        slot = _one_hot(pos.long(), cap)                     # [B, S, E, C]
        dispatch = dispatch + (slot * valid[..., None]).to(x.dtype)
        combine = combine + slot * (valid * gate[..., kk:kk + 1])[..., None]
        offset = offset + m.sum(dim=1, keepdim=True)
    buf = torch.einsum("bsec,bsd->becd", dispatch, x)        # [B, E, C, d]
    if cfg.ffn_activation == "swiglu":
        h = F.silu(torch.einsum("becd,edf->becf", buf, p["w_gate"])) \
            * torch.einsum("becd,edf->becf", buf, p["w_up"])
    else:
        h = F.gelu(torch.einsum("becd,edf->becf", buf, p["w_up"]),
                   approximate="tanh")
    out_buf = torch.einsum("becf,efd->becd", h, p["w_out"])
    out = torch.einsum("bsec,becd->bsd", combine.to(x.dtype), out_buf)
    return _shared(p, cfg, x, out), aux


def moe_decode(p: Dict, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    """One token a row, ``x [B, 1, d]`` -> ``[B, 1, d]``: each row through
    its top-k experts, no capacity drop. The ``B * K`` chosen experts'
    weights are gathered by advanced indexing (a gather over the output's
    elements, which on the card outruns ``index_select`` for a handful of
    large rows: PERF.md) and applied as one batched product; the gates
    are cast to ``x.dtype`` before the weighted sum."""
    b, _, d = x.shape
    k = cfg.top_k
    xt = x[:, 0]
    _, gate, idx = _route(p, cfg, xt)                        # [B, K]
    flat = idx.reshape(-1)
    xk = xt[:, None, :].expand(b, k, d).reshape(b * k, 1, d)  # [B*K, 1, d]
    if cfg.ffn_activation == "swiglu":
        h = F.silu(torch.bmm(xk, p["w_gate"][flat])) \
            * torch.bmm(xk, p["w_up"][flat])
    else:
        h = F.gelu(torch.bmm(xk, p["w_up"][flat]), approximate="tanh")
    y = torch.bmm(h, p["w_out"][flat]).reshape(b, k, d)
    out = (y * gate.to(x.dtype)[..., None]).sum(dim=1)[:, None]
    return _shared(p, cfg, x, out)
