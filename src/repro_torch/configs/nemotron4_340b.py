"""nemotron-4-340b [dense] — GQA kv=8, squared-ReLU FFN.

96L d_model=18432, 96 heads (kv=8), d_ff=73728, vocab=256000.
[arXiv:2402.16819]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="nemotron-4-340b",
    arch_type="dense",
    num_layers=96,
    d_model=18432,
    num_heads=96,
    num_kv_heads=8,
    d_ff=73728,
    vocab_size=256000,
    ffn_activation="squared_relu",
    norm="layernorm",
    rope_theta=10_000.0,
)
