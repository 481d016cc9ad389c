"""Plain PyTorch versions of the kernels: the CPU path and the oracles the
CUDA kernels are held against on the card.

Padding contract (the reference's): padding arcs carry weight 0 and may
point at any in-range row; the zero weight is what makes them no-ops.
"""
from __future__ import annotations

from typing import Optional

import torch


def csr_aggregate_ref(h: torch.Tensor, edge_src: torch.Tensor,
                      edge_dst: torch.Tensor, edge_weight: torch.Tensor,
                      num_nodes: int,
                      inv_scale: Optional[torch.Tensor] = None
                      ) -> torch.Tensor:
    """``out[d] = inv[d] * sum_{e: dst[e]=d} w[e] * h[src[e]]`` (f32), as an
    ``index_add_`` segment sum; ``inv_scale=None`` means 1."""
    msgs = (h.index_select(0, edge_src.long()).float()
            * edge_weight.float()[:, None])
    out = torch.zeros(num_nodes, h.shape[1], dtype=torch.float32,
                      device=h.device)
    out.index_add_(0, edge_dst.long(), msgs)
    if inv_scale is not None:
        out = out * inv_scale.float()[:, None]
    return out


def fused_gcn_reference(h: torch.Tensor, edge_src: torch.Tensor,
                        edge_dst: torch.Tensor, edge_weight: torch.Tensor,
                        inv_scale: Optional[torch.Tensor], w: torch.Tensor,
                        b: torch.Tensor, activate: bool = True
                        ) -> torch.Tensor:
    """``act((inv ⊙ Σ_e w[e]·h[src[e]]→dst[e]) @ W + b)``.

    ``torch.relu``'s gradient at z == 0 is 0, the reference's convention
    (``jax.nn.relu``), which matters for zero-degree rows under zero bias.
    """
    agg = csr_aggregate_ref(h, edge_src, edge_dst, edge_weight, h.shape[0],
                            inv_scale)
    return gcn_epilogue(agg, w, b, activate)


def gcn_epilogue(agg: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 activate: bool) -> torch.Tensor:
    """``act(agg @ W + b)``, the dense half of the fused layer."""
    z = agg @ w.float() + b.float()[None, :]
    return torch.relu(z) if activate else z


def edge_dot_ref(h: torch.Tensor, g: torch.Tensor, edge_src: torch.Tensor,
                 edge_dst: torch.Tensor,
                 inv_scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``dw[e] = Σ_f h[src[e], f] · (inv ⊙ g)[dst[e], f]`` (f32), the
    aggregation's edge-weight gradient for the cotangent ``g``; as the
    reference does, ``g`` is scaled by ``inv`` before the two ``[E, F]``
    gathers. ``inv_scale=None`` means 1."""
    gs = g.float()
    if inv_scale is not None:
        gs = gs * inv_scale.float()[:, None]
    return (h.index_select(0, edge_src.long()).float()
            * gs.index_select(0, edge_dst.long())).sum(dim=1)


def flash_decode_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     lengths: torch.Tensor) -> torch.Tensor:
    """Single-token GQA decode attention, batched.

    q: ``[B, H, D]``; k, v: ``[B, S, Hkv, D]``; lengths: ``[B]`` valid prefix
    lengths. Query head ``h`` reads kv head ``h // (H // Hkv)``. Positions
    ``>= lengths[b]`` are masked to -1e30 before an f32 softmax; a row with
    length 0 is the mean of V, as the reference's oracle gives. Returns
    ``[B, H, D]`` in q's dtype. The grouped einsum reads each kv head once
    per group instead of repeating K and V ``H // Hkv`` times."""
    b, s, hkv, d = k.shape
    h = q.shape[1]
    qg = q.float().reshape(b, hkv, h // hkv, d)
    logits = torch.einsum("bhgd,bshd->bhgs", qg, k.float()) * d ** -0.5
    valid = torch.arange(s, device=k.device)[None, :] < lengths[:, None]
    logits = torch.where(valid[:, None, None, :], logits,
                         torch.full((), -1e30, device=k.device))
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhgs,bshd->bhgd", probs, v.float())
    return out.reshape(b, h, d).to(q.dtype)
