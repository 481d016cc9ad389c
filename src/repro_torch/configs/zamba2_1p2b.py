"""zamba2-1.2b [hybrid] — Mamba2 backbone + shared attention block.

38L d_model=2048, 32 heads (kv=32) for the shared attn, d_ff=8192 (shared
block MLP), ssm_state=64, vocab=32000. The single shared attention+MLP block
is re-applied every 6th layer (weights shared). [arXiv:2411.15242]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-1.2b",
    arch_type="hybrid",
    num_layers=38,
    d_model=2048,
    num_heads=32,
    num_kv_heads=32,
    d_ff=8192,
    vocab_size=32000,
    block_pattern=("mamba", "mamba", "mamba", "mamba", "mamba",
                   "shared_attn"),
    ssm_state_dim=64,
    scan_layers=False,
    chunk_size=128,
    long_context="native",
)
