"""glm4-9b [dense] — RoPE (half-dim partial rotary), GQA kv=2.

40L d_model=4096, 32 heads (kv=2), d_ff=13696, vocab=151552.
[hf:THUDM/glm-4-9b]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="glm4-9b",
    arch_type="dense",
    num_layers=40,
    d_model=4096,
    num_heads=32,
    num_kv_heads=2,
    d_ff=13696,
    vocab_size=151552,
    qkv_bias=True,                # glm4 uses qkv bias (add_qkv_bias)
    rope_fraction=0.5,
    ffn_activation="swiglu",
)
