"""deepseek-v2-236b [moe] — MLA (kv_lora=512), 2 shared + 160 routed top-6.

60L d_model=5120, 128 heads, per-expert d_ff=1536, vocab=102400; first layer
dense (d_ff=12288). [arXiv:2405.04434]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-v2-236b",
    arch_type="moe",
    num_layers=60,
    d_model=5120,
    num_heads=128,
    num_kv_heads=128,             # MLA: kv heads notional, cache is latent
    d_ff=12288,                   # dense layers (first_k_dense)
    vocab_size=102400,
    ffn_activation="swiglu",
    num_experts=160,
    num_shared_experts=2,
    top_k=6,
    moe_d_ff=1536,
    first_k_dense=1,
    mla=True,
    q_lora_rank=1536,
    kv_lora_rank=512,
    qk_nope_head_dim=128,
    qk_rope_head_dim=64,
    v_head_dim=128,
    head_dim=192,                 # qk_nope + qk_rope
)
