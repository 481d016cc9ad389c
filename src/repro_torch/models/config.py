"""Model configuration for the architecture zoo: a copy of the reference's
``ModelConfig``, field for field, so that configs compare equal across the
two packages.

One frozen dataclass covers all six architecture families; family-specific
fields default to "off". Every config in :mod:`repro_torch.configs` cites its
source model card / paper. Some fields only steer the reference's JAX
lowering (``scan_layers``, ``remat``, ``remat_policy``, ``unroll``,
``use_flash_decode``); the port keeps them for equality and ignores them.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    arch_type: str                    # dense | moe | ssm | hybrid | vlm | audio
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                 # 0 -> d_model // num_heads

    # --- attention flavor ---------------------------------------------------
    qkv_bias: bool = False
    qk_norm: bool = False             # per-head RMSNorm on q,k (qwen3)
    rope_theta: float = 10_000.0
    rope_fraction: float = 1.0        # glm4 rotates half the head dim
    attention: str = "full"           # full | sliding
    window: int = 8192                # sliding-window size
    causal: bool = True

    # --- FFN -----------------------------------------------------------------
    ffn_activation: str = "swiglu"    # swiglu | squared_relu | gelu
    ffn_bias: bool = False

    # --- MoE -----------------------------------------------------------------
    num_experts: int = 0
    num_shared_experts: int = 0
    top_k: int = 0
    moe_d_ff: int = 0                 # per-expert hidden dim
    first_k_dense: int = 0            # leading dense layers (deepseek-v2)
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01
    # Pad the expert WEIGHT stacks to this count (0 = no padding). Dummy
    # experts get -inf router logits and are never routed; padding restores
    # mesh-divisibility so the E axis actually shards (qwen2-moe's 60
    # experts don't divide the 16-way model axis -> silently replicated
    # otherwise; §Perf iteration P3.1).
    experts_pad_to: int = 0

    # --- MLA (deepseek-v2) ---------------------------------------------------
    mla: bool = False
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    qk_nope_head_dim: int = 0
    qk_rope_head_dim: int = 0
    v_head_dim: int = 0

    # --- SSM / hybrid ---------------------------------------------------------
    # block pattern, repeated/truncated to num_layers:
    #   "attn" | "mlstm" | "slstm" | "mamba" | "shared_attn"
    block_pattern: Tuple[str, ...] = ()
    ssm_state_dim: int = 0
    conv_kernel: int = 4
    chunk_size: int = 128             # chunked linear-attention chunk

    # --- encoder-decoder ------------------------------------------------------
    encoder_layers: int = 0           # >0 -> enc-dec (seamless)
    enc_seq_divisor: int = 8          # encoder frames = seq/divisor

    # --- modality frontend stub -----------------------------------------------
    frontend: str = "none"            # none | audio | vision
    num_patch_tokens: int = 0         # vision tokens prepended (phi-3-v)

    # --- numerics / structure ---------------------------------------------------
    dtype: str = "bfloat16"
    norm: str = "rmsnorm"             # rmsnorm | layernorm
    scan_layers: bool = True          # reference: scan over stacked layers
    remat: bool = True                # activation checkpointing per layer
    # "full"  — recompute everything in backward (min memory, +1/3 flops)
    # "dots"  — save matmul outputs, recompute only elementwise chains
    #           (§Perf P2.2: trades HBM capacity for bandwidth+flops)
    remat_policy: str = "full"
    # the reference's switch between its flash-decode kernel and its plain
    # decode attention; both compute the same function, and the port's
    # decode takes the CUDA kernel on the card whatever its value
    use_flash_decode: bool = False
    # unroll inner chunk loops (attention/loss/linear-attention) instead of
    # lax.scan/map: XLA's HloCostAnalysis counts while bodies ONCE, so the
    # roofline dry-run lowers with unroll=True + scan_layers=False to get
    # trip-count-correct FLOP/byte numbers (see launch/dryrun.py).
    unroll: bool = False
    tie_embeddings: bool = False

    # long-context strategy for the long_500k shape:
    #   "native"  — SSM/linear blocks handle it as-is
    #   "sliding" — dense archs switch to sliding-window KV cache
    long_context: str = "sliding"

    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim",
                               self.d_model // max(self.num_heads, 1))

    @property
    def group_size(self) -> int:
        return self.num_heads // max(self.num_kv_heads, 1)

    @property
    def blocks(self) -> Tuple[str, ...]:
        """Per-layer block kinds, length num_layers."""
        if not self.block_pattern:
            return ("attn",) * self.num_layers
        reps = (self.num_layers + len(self.block_pattern) - 1) \
            // len(self.block_pattern)
        return (self.block_pattern * reps)[: self.num_layers]

    def is_moe_layer(self, idx: int) -> bool:
        return self.num_experts > 0 and idx >= self.first_k_dense

    def param_count(self) -> int:
        """Approximate parameter count (embeddings + blocks)."""
        d = self.d_model
        n = self.vocab_size * d * (1 if self.tie_embeddings else 2)
        for i, kind in enumerate(self.blocks):
            if kind in ("attn", "shared_attn"):
                if self.mla:
                    qd = self.q_lora_rank or d
                    n += d * qd + qd * self.num_heads * (
                        self.qk_nope_head_dim + self.qk_rope_head_dim)
                    n += d * (self.kv_lora_rank + self.qk_rope_head_dim)
                    n += self.kv_lora_rank * self.num_heads * (
                        self.qk_nope_head_dim + self.v_head_dim)
                    n += self.num_heads * self.v_head_dim * d
                else:
                    n += d * self.head_dim * (self.num_heads
                                              + 2 * self.num_kv_heads)
                    n += self.num_heads * self.head_dim * d
                    if self.encoder_layers:   # decoder cross-attention
                        n += d * self.head_dim * (self.num_heads
                                                  + 2 * self.num_kv_heads)
                        n += self.num_heads * self.head_dim * d
            elif kind == "mlstm":
                # wq,wk,wv,wo_gate,w_out (5 d^2) + gates
                n += 5 * d * d + 2 * d * self.num_heads
            elif kind == "slstm":
                # w_in (4d^2) + block-diag recurrent (4 d dh) + w_out
                dh = d // max(self.num_heads, 1)
                n += 4 * d * d + 4 * d * dh + d * d
            elif kind == "mamba":
                dinner = 2 * d
                n += d * dinner * 2 + dinner * self.ssm_state_dim * 2 \
                    + dinner * d
            # FFN
            if kind in ("attn",) or (kind in ("mlstm",) and self.d_ff):
                if self.is_moe_layer(i):
                    mult = 3 if self.ffn_activation == "swiglu" else 2
                    n += (self.num_experts + self.num_shared_experts) \
                        * mult * d * self.moe_d_ff
                    n += d * self.num_experts   # router
                elif self.d_ff:
                    mult = 3 if self.ffn_activation == "swiglu" else 2
                    n += mult * d * self.d_ff
        return n

    def active_param_count(self) -> int:
        """Active params per token (MoE: only routed top-k + shared)."""
        if self.num_experts == 0:
            return self.param_count()
        full = self.param_count()
        mult = 3 if self.ffn_activation == "swiglu" else 2
        moe_layers = sum(1 for i in range(self.num_layers)
                         if self.is_moe_layer(i))
        all_e = (self.num_experts + self.num_shared_experts) * mult \
            * self.d_model * self.moe_d_ff * moe_layers
        act_e = (self.top_k + self.num_shared_experts) * mult \
            * self.d_model * self.moe_d_ff * moe_layers
        return full - all_e + act_e

    def reduced(self, num_layers: int = 2, d_model: int = 256,
                num_experts: int = 4) -> "ModelConfig":
        """The smoke-test variant: same family, tiny dims (brief: <=2 layers,
        d_model<=512, <=4 experts)."""
        scale = d_model / self.d_model
        heads = max(2, min(self.num_heads, 4))
        kv = max(1, min(self.num_kv_heads, heads))
        changes = dict(
            num_layers=num_layers,
            d_model=d_model,
            num_heads=heads,
            num_kv_heads=kv,
            head_dim=max(16, d_model // heads),
            d_ff=max(32, int(self.d_ff * scale)) if self.d_ff else 0,
            vocab_size=512,
            scan_layers=self.scan_layers,
            remat=False,
            dtype="float32",
            encoder_layers=min(self.encoder_layers, 2),
            num_patch_tokens=min(self.num_patch_tokens, 8),
            window=64,
        )
        if self.num_experts:
            changes.update(
                num_experts=min(num_experts, self.num_experts),
                num_shared_experts=min(1, self.num_shared_experts),
                top_k=min(2, self.top_k),
                moe_d_ff=max(32, int(self.moe_d_ff * scale)),
                first_k_dense=min(self.first_k_dense, 1),
            )
        if self.mla:
            changes.update(q_lora_rank=64, kv_lora_rank=32,
                           qk_nope_head_dim=32, qk_rope_head_dim=16,
                           v_head_dim=32)
        if self.ssm_state_dim:
            changes.update(ssm_state_dim=min(16, self.ssm_state_dim))
        if self.block_pattern:
            changes.update(block_pattern=self.block_pattern)
        return dataclasses.replace(self, **changes)
