"""SSM and recurrent blocks: Mamba2 (SSD), xLSTM's mLSTM and sLSTM.

The shared core is **chunked linear attention**: within a chunk the
recurrence is unrolled into two products (masked intra-chunk attention
and the read of the carried state), and a Python loop over the chunks
carries the state::

    S_t = a_t * S_{t-1} + k_t v_t^T          (per head, a_t scalar decay)
    y_t = q_t^T S_t                           (+ normalizer for mLSTM)

This is Mamba2's SSD duality and GLA-style mLSTM. The sLSTM's
exponential gating with its max-stabilizer is sequential: a Python loop
over time, one cell a step.

mLSTM deviation, as in the reference: sigmoid input and forget gates (a
large forget bias) replace the paper's exponential input gate and
stabilizer, which do not commute with the chunked form.

The cast rules are the reference's: the core works in f32; outputs go
back to ``x.dtype`` where the reference casts them; the mLSTM scales
``q``/``k`` in ``x.dtype`` before the core's f32 cast. ``A_log``, ``D``,
``dt_bias``, the sLSTM's ``r`` and ``bias`` and the mLSTM's ``b_if`` are
f32 leaves inside a bf16 model. The decode steps return new state dicts;
the LM's ``serve_step`` copies them into its cache in place.

No TPU kernel exists here: the reference computes this module with its
einsums and scans, and the port with ``torch`` ops.
"""
from __future__ import annotations

from typing import Callable, Dict, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from .config import ModelConfig
from .layers import normal, torch_dtype

State = Dict[str, torch.Tensor]
MAMBA_HEAD_DIM = 64


# ---------------------------------------------------------------------------
# Chunked linear attention core
# ---------------------------------------------------------------------------
def chunked_linear_attention(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, log_decay: torch.Tensor,
                             state: Optional[torch.Tensor], chunk: int,
                             normalize: bool = False,
                             norm_state: Optional[torch.Tensor] = None
                             ) -> Tuple[torch.Tensor, torch.Tensor,
                                        torch.Tensor]:
    """q, k: ``[B, S, H, Dk]``; v: ``[B, S, H, Dv]``; log_decay:
    ``[B, S, H]`` (<= 0).

    Returns ``(y [B, S, H, Dv] f32, final state [B, H, Dk, Dv], final
    norm [B, H, Dk])``. ``S`` is padded to whole chunks with decay 0 and
    zero k/v, which leave the state as it is."""
    b, s, h, dk = q.shape
    dv = v.shape[-1]
    c = min(chunk, s)
    nc = -(-s // c)
    pad = nc * c - s
    f32 = torch.float32
    q_in = q
    if pad:
        q = F.pad(q, (0, 0, 0, 0, 0, pad))
        k = F.pad(k, (0, 0, 0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, 0, 0, pad))
        log_decay = F.pad(log_decay, (0, 0, 0, pad))
    qc = q.reshape(b, nc, c, h, dk).to(f32)
    kc = k.reshape(b, nc, c, h, dk).to(f32)
    vc = v.reshape(b, nc, c, h, dv).to(f32)
    lc = log_decay.reshape(b, nc, c, h).to(f32)
    if state is None:
        state = torch.zeros((b, h, dk, dv), dtype=f32, device=q.device)
    if norm_state is None:
        norm_state = torch.zeros((b, h, dk), dtype=f32, device=q.device)
    idx = torch.arange(c, device=q.device)
    tri = (idx[:, None] >= idx[None, :])[None, :, :, None]     # [1,i,j,1]
    S, n = state, norm_state
    ys, ns = [], []
    for i in range(nc):
        qi, ki, vi, li = qc[:, i], kc[:, i], vc[:, i], lc[:, i]
        cum = torch.cumsum(li, dim=1)                        # [B,c,H]
        total = cum[:, -1]                                   # [B,H]
        # D[i, j] = exp(cum_i - cum_j) for j <= i, else 0; the masked
        # entries take exp(-inf), so no overflow reaches a gradient
        diff = cum[:, :, None, :] - cum[:, None, :, :]       # [B,i,j,H]
        D = torch.exp(torch.where(tri, diff, float("-inf")))
        logits = torch.einsum("bihd,bjhd->bijh", qi, ki) * D
        y = torch.einsum("bijh,bjhv->bihv", logits, vi)
        decay_i = torch.exp(cum)                             # [B,c,H]
        y = y + torch.einsum("bihd,bhdv->bihv", qi * decay_i[..., None], S)
        ys.append(y)
        if normalize:
            nn = torch.einsum("bijh,bjhd->bihd", D, ki)
            ns.append(nn + decay_i[..., None] * n[:, None])
        w = torch.exp(total[:, None] - cum)                  # [B,c,H]
        kw = ki * w[..., None]
        S = torch.exp(total)[..., None, None] * S + torch.einsum(
            "bjhd,bjhv->bhdv", kw, vi)
        n = torch.exp(total)[..., None] * n + kw.sum(dim=1)
    y = torch.stack(ys, dim=1).reshape(b, nc * c, h, dv)[:, :s]
    if normalize:
        n_full = torch.stack(ns, dim=1).reshape(b, nc * c, h, dk)[:, :s]
        denom = torch.einsum("bshd,bshd->bsh", q_in.to(f32), n_full).abs()
        y = y / torch.clamp(denom, min=1.0)[..., None]
    return y, S, n


def linear_attention_step(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          log_decay: torch.Tensor, state: torch.Tensor,
                          norm_state: torch.Tensor
                          ) -> Tuple[torch.Tensor, torch.Tensor,
                                     torch.Tensor]:
    """One token's recurrent step. q, k: ``[B, H, Dk]``; v: ``[B, H, Dv]``;
    log_decay: ``[B, H]``. Returns ``(y [B, H, Dv] f32, state, norm)``."""
    f32 = torch.float32
    a = torch.exp(log_decay.to(f32))[..., None, None]
    state = a * state + torch.einsum("bhd,bhv->bhdv", k.to(f32), v.to(f32))
    norm_state = a[..., 0] * norm_state + k.to(f32)
    y = torch.einsum("bhd,bhdv->bhv", q.to(f32), state)
    return y, state, norm_state


# ---------------------------------------------------------------------------
# Mamba2 block
# ---------------------------------------------------------------------------
def _mamba_dims(cfg: ModelConfig) -> Tuple[int, int, int]:
    """(inner width, heads, state width): expand 2, head dim 64."""
    di = 2 * cfg.d_model
    return di, di // MAMBA_HEAD_DIM, cfg.ssm_state_dim


def init_mamba(cfg: ModelConfig, device: torch.device,
               gen: torch.Generator) -> Dict[str, torch.Tensor]:
    d = cfg.d_model
    di, nh, dstate = _mamba_dims(cfg)
    dt = torch_dtype(cfg)
    f32 = dict(dtype=torch.float32, device=device)
    return {
        # in_proj -> [z (di), x (di), B (dstate), C (dstate), dt (nh)]
        "w_in": normal((d, 2 * di + 2 * dstate + nh), (1.0 / d) ** 0.5, dt,
                       device, gen),
        "conv": normal((cfg.conv_kernel, di + 2 * dstate), 0.1, dt, device,
                       gen),
        "A_log": torch.zeros((nh,), **f32),          # A = -exp(A_log)
        "D": torch.ones((nh,), **f32),
        "dt_bias": torch.full((nh,), -2.0, **f32),
        "w_out": normal((di, d), (1.0 / di) ** 0.5, dt, device, gen),
    }


def _causal_conv(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Per-channel causal conv. x: ``[B, S, C]``; w: ``[K, C]``. The ``K``
    shifted products are summed in the reference's order, tap 0 first."""
    k, s = w.shape[0], x.shape[1]
    xp = F.pad(x, (0, 0, k - 1, 0))
    out = xp[:, 0:s] * w[0]
    for i in range(1, k):
        out = out + xp[:, i:i + s] * w[i]
    return out


def _skip(p: Dict[str, torch.Tensor], x: torch.Tensor) -> torch.Tensor:
    """``D`` repeated over each head's 64 channels (``jnp.repeat``), in
    ``x.dtype``."""
    return p["D"][:, None].expand(-1, MAMBA_HEAD_DIM).reshape(-1).to(x.dtype)


def mamba_forward(p: Dict[str, torch.Tensor], cfg: ModelConfig,
                  x: torch.Tensor, state: Optional[State] = None,
                  return_state: bool = False
                  ) -> Tuple[torch.Tensor, State]:
    """x: ``[B, S, d]``. Returns ``(y, state)``: with ``return_state`` the
    decode handoff, the final SSM state and the last ``K - 1`` pre-conv
    rows (left-padded with zeros when ``S < K - 1``); else ``{}``."""
    b, s, _ = x.shape
    di, nh, dstate = _mamba_dims(cfg)
    proj = x @ p["w_in"]
    z = proj[..., :di]
    raw_xbc = proj[..., di:2 * di + 2 * dstate]
    dt_raw = proj[..., 2 * di + 2 * dstate:]
    xbc = F.silu(_causal_conv(raw_xbc, p["conv"]))
    xs, bm, cm = xbc[..., :di], xbc[..., di:di + dstate], \
        xbc[..., di + dstate:]
    dt_act = F.softplus(dt_raw.float() + p["dt_bias"])       # [B,S,nh]
    a = -torch.exp(p["A_log"])
    log_a = (dt_act * a).reshape(b, s, nh)
    v = xs.reshape(b, s, nh, MAMBA_HEAD_DIM) \
        * dt_act.reshape(b, s, nh, 1).to(x.dtype)
    k = bm[:, :, None, :].expand(b, s, nh, dstate)
    q = cm[:, :, None, :].expand(b, s, nh, dstate)
    st = state["ssm"] if state else None
    y, st_new, _ = chunked_linear_attention(q, k, v, log_a, st,
                                            cfg.chunk_size)
    y = y.reshape(b, s, di).to(x.dtype) + xs * _skip(p, x)
    y = y * F.silu(z)
    out = y @ p["w_out"]
    if not return_state:
        return out, {}
    tail = F.pad(raw_xbc, (0, 0, cfg.conv_kernel - 1, 0))
    return out, {"ssm": st_new,
                 "conv": tail[:, -(cfg.conv_kernel - 1):].contiguous()}


def mamba_decode_step(p: Dict[str, torch.Tensor], cfg: ModelConfig,
                      x: torch.Tensor, state: State
                      ) -> Tuple[torch.Tensor, State]:
    """x: ``[B, 1, d]``; state: ``{"ssm": [B, H, Dk, Dv], "conv":
    [B, K-1, C]}``. The new conv window is a view of a fresh tensor (the
    old window and this row), never of ``state["conv"]``."""
    b = x.shape[0]
    di, nh, dstate = _mamba_dims(cfg)
    proj = x @ p["w_in"]                                     # [B,1,*]
    z = proj[..., :di]
    xbc = proj[..., di:2 * di + 2 * dstate]
    dt_raw = proj[..., 2 * di + 2 * dstate:]
    hist = torch.cat([state["conv"], xbc], dim=1)            # [B,K,C]
    xbc = F.silu((hist * p["conv"]).sum(dim=1, keepdim=True))
    xs, bm, cm = xbc[..., :di], xbc[..., di:di + dstate], \
        xbc[..., di + dstate:]
    dt_act = F.softplus(dt_raw[:, 0].float() + p["dt_bias"])  # [B,nh]
    log_a = dt_act * -torch.exp(p["A_log"])
    v = xs[:, 0].reshape(b, nh, MAMBA_HEAD_DIM) \
        * dt_act.reshape(b, nh, 1).to(x.dtype)
    k = bm[:, 0, None, :].expand(b, nh, dstate)
    q = cm[:, 0, None, :].expand(b, nh, dstate)
    y, ssm, _ = linear_attention_step(
        q, k, v, log_a, state["ssm"],
        torch.zeros((b, nh, dstate), dtype=torch.float32, device=x.device))
    y = y.reshape(b, 1, di).to(x.dtype) + xs * _skip(p, x)
    y = y * F.silu(z)
    return y @ p["w_out"], {"ssm": ssm, "conv": hist[:, 1:]}


def init_mamba_state(cfg: ModelConfig, batch: int,
                     device: torch.device) -> State:
    di, nh, dstate = _mamba_dims(cfg)
    return {"ssm": torch.zeros((batch, nh, dstate, MAMBA_HEAD_DIM),
                               dtype=torch.float32, device=device),
            "conv": torch.zeros((batch, cfg.conv_kernel - 1,
                                 di + 2 * dstate), dtype=torch_dtype(cfg),
                                device=device)}


# ---------------------------------------------------------------------------
# xLSTM: mLSTM block
# ---------------------------------------------------------------------------
def init_mlstm(cfg: ModelConfig, device: torch.device,
               gen: torch.Generator) -> Dict[str, torch.Tensor]:
    d, h = cfg.d_model, cfg.num_heads
    dt = torch_dtype(cfg)
    s = (1.0 / d) ** 0.5
    return {
        "wq": normal((d, d), s, dt, device, gen),
        "wk": normal((d, d), s, dt, device, gen),
        "wv": normal((d, d), s, dt, device, gen),
        "w_if": normal((d, 2 * h), s, dt, device, gen),
        "b_if": torch.cat([torch.zeros((h,), device=device),
                           torch.full((h,), 4.0, device=device)]),
        "wo_gate": normal((d, d), s, dt, device, gen),
        "w_out": normal((d, d), s, dt, device, gen),
    }


def _mlstm_gates(p: Dict[str, torch.Tensor], x: torch.Tensor, h: int
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(input gate, log forget gate), f32."""
    gates = (x @ p["w_if"]).float() + p["b_if"]
    return torch.sigmoid(gates[..., :h]), F.logsigmoid(gates[..., h:])


def mlstm_forward(p: Dict[str, torch.Tensor], cfg: ModelConfig,
                  x: torch.Tensor, state: Optional[State] = None
                  ) -> Tuple[torch.Tensor, State]:
    b, s, d = x.shape
    h = cfg.num_heads
    dh = d // h
    q = (x @ p["wq"]).reshape(b, s, h, dh) * dh ** -0.5
    k = (x @ p["wk"]).reshape(b, s, h, dh) * dh ** -0.5
    v = (x @ p["wv"]).reshape(b, s, h, dh)
    i_gate, log_f = _mlstm_gates(p, x, h)                     # [B,S,H]
    st = state["S"] if state else None
    ns = state["n"] if state else None
    y, S, n = chunked_linear_attention(q, k * i_gate[..., None], v, log_f,
                                       st, cfg.chunk_size, normalize=True,
                                       norm_state=ns)
    y = y.reshape(b, s, d).to(x.dtype)
    y = y * torch.sigmoid(x @ p["wo_gate"])
    return y @ p["w_out"], {"S": S, "n": n}


def mlstm_decode_step(p: Dict[str, torch.Tensor], cfg: ModelConfig,
                      x: torch.Tensor, state: State
                      ) -> Tuple[torch.Tensor, State]:
    b, _, d = x.shape
    h = cfg.num_heads
    dh = d // h
    x0 = x[:, 0]
    q = (x0 @ p["wq"]).reshape(b, h, dh) * dh ** -0.5
    k = (x0 @ p["wk"]).reshape(b, h, dh) * dh ** -0.5
    v = (x0 @ p["wv"]).reshape(b, h, dh)
    i_gate, log_f = _mlstm_gates(p, x0, h)
    y, S, n = linear_attention_step(q, k * i_gate[..., None], v, log_f,
                                    state["S"], state["n"])
    denom = torch.einsum("bhd,bhd->bh", q.float(), n).abs()
    y = (y / torch.clamp(denom, min=1.0)[..., None]).reshape(b, 1, d)
    y = y.to(x.dtype) * torch.sigmoid(x @ p["wo_gate"])
    return y @ p["w_out"], {"S": S, "n": n}


def init_mlstm_state(cfg: ModelConfig, batch: int,
                     device: torch.device) -> State:
    h = cfg.num_heads
    dh = cfg.d_model // h
    return {"S": torch.zeros((batch, h, dh, dh), dtype=torch.float32,
                             device=device),
            "n": torch.zeros((batch, h, dh), dtype=torch.float32,
                             device=device)}


# ---------------------------------------------------------------------------
# xLSTM: sLSTM block (a loop over time; exponential gating with a
# max-stabilizer state)
# ---------------------------------------------------------------------------
def init_slstm(cfg: ModelConfig, device: torch.device,
               gen: torch.Generator) -> Dict[str, torch.Tensor]:
    d, h = cfg.d_model, cfg.num_heads
    dh = d // h
    dt = torch_dtype(cfg)
    s = (1.0 / d) ** 0.5
    return {
        "w_in": normal((d, 4 * d), s, dt, device, gen),
        # block-diagonal recurrent weights, per head: [H, Dh, 4*Dh]
        "r": normal((h, dh, 4 * dh), (1.0 / dh) ** 0.5, torch.float32,
                    device, gen),
        "bias": torch.zeros((4 * d,), dtype=torch.float32, device=device),
        "w_out": normal((d, d), s, dt, device, gen),
    }


def _slstm_cell(p: Dict[str, torch.Tensor], cfg: ModelConfig,
                xt: torch.Tensor, carry: State) -> State:
    """One sLSTM step. xt: ``[B, 4d]`` (pre-projected); carry: ``h``,
    ``c``, ``n``, ``m``, each ``[B, H, Dh]`` f32."""
    b = xt.shape[0]
    nh = cfg.num_heads
    dh = cfg.d_model // nh
    rec = torch.einsum("bhd,hdk->bhk", carry["h"], p["r"])   # [B,H,4*Dh]
    pre = (xt.reshape(b, nh, 4 * dh).float() + rec
           + p["bias"].reshape(nh, 4 * dh))
    z, log_i, f_raw, o_raw = pre.split(dh, dim=-1)
    z = torch.tanh(z)
    o = torch.sigmoid(o_raw)
    log_f = F.logsigmoid(f_raw)
    m_new = torch.maximum(log_f + carry["m"], log_i)
    i_st = torch.exp(log_i - m_new)
    f_st = torch.exp(log_f + carry["m"] - m_new)
    c_new = f_st * carry["c"] + i_st * z
    n_new = f_st * carry["n"] + i_st
    h_new = o * c_new / torch.clamp(n_new, min=1.0)
    return {"h": h_new, "c": c_new, "n": n_new, "m": m_new}


def slstm_forward(p: Dict[str, torch.Tensor], cfg: ModelConfig,
                  x: torch.Tensor, state: Optional[State] = None
                  ) -> Tuple[torch.Tensor, State]:
    b, s, d = x.shape
    if state is None:
        state = init_slstm_state(cfg, b, x.device)
    xin = x @ p["w_in"]                                      # [B,S,4d]
    hs = []
    for t in range(s):
        state = _slstm_cell(p, cfg, xin[:, t], state)
        hs.append(state["h"])
    y = torch.stack(hs, dim=1).reshape(b, s, d).to(x.dtype)
    return y @ p["w_out"], state


def slstm_decode_step(p: Dict[str, torch.Tensor], cfg: ModelConfig,
                      x: torch.Tensor, state: State
                      ) -> Tuple[torch.Tensor, State]:
    new = _slstm_cell(p, cfg, x[:, 0] @ p["w_in"], state)
    y = new["h"].reshape(x.shape[0], 1, cfg.d_model).to(x.dtype)
    return y @ p["w_out"], new


def init_slstm_state(cfg: ModelConfig, batch: int,
                     device: torch.device) -> State:
    nh = cfg.num_heads
    shape = (batch, nh, cfg.d_model // nh)
    f32 = dict(dtype=torch.float32, device=device)
    return {"h": torch.zeros(shape, **f32), "c": torch.zeros(shape, **f32),
            "n": torch.zeros(shape, **f32),
            "m": torch.full(shape, -1e30, **f32)}


class Block(NamedTuple):
    """A block kind of a pattern: its init, its forward (train and
    prefill), its one-token decode step and its zero state."""
    init: Callable
    forward: Callable
    decode: Callable
    zero_state: Callable


BLOCKS = {
    "mamba": Block(init_mamba, mamba_forward, mamba_decode_step,
                   init_mamba_state),
    "mlstm": Block(init_mlstm, mlstm_forward, mlstm_decode_step,
                   init_mlstm_state),
    "slstm": Block(init_slstm, slstm_forward, slstm_decode_step,
                   init_slstm_state),
}
