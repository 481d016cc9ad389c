"""qwen3-4b [dense] — qk_norm, GQA kv=8, explicit head_dim=128.

36L d_model=2560, 32 heads (kv=8), d_ff=9728, vocab=151936.
[hf:Qwen/Qwen3-8B family, 4B point]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-4b",
    arch_type="dense",
    num_layers=36,
    d_model=2560,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=9728,
    vocab_size=151936,
    qk_norm=True,
    ffn_activation="swiglu",
    rope_theta=1_000_000.0,
)
