"""qwen2-moe-a2.7b [moe] — 4 shared + 60 routed experts, top-4.

24L d_model=2048, 16 heads (kv=16), per-expert d_ff=1408, vocab=151936.
[hf:Qwen/Qwen1.5-MoE-A2.7B]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-moe-a2.7b",
    arch_type="moe",
    num_layers=24,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    d_ff=0,
    vocab_size=151936,
    qkv_bias=True,
    ffn_activation="swiglu",
    num_experts=60,
    num_shared_experts=4,
    top_k=4,
    moe_d_ff=1408,
)
