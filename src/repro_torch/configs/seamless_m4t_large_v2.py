"""seamless-m4t-large-v2 [audio] — enc-dec multimodal translation backbone.

24L decoder (+24L speech encoder) d_model=1024, 16 heads (kv=16), d_ff=8192,
vocab=256206. [arXiv:2308.11596] Frontend (mel + conformer feature extractor)
is a stub: input_specs provides precomputed frame embeddings."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-large-v2",
    arch_type="audio",
    num_layers=24,
    d_model=1024,
    num_heads=16,
    num_kv_heads=16,
    d_ff=8192,
    vocab_size=256206,
    ffn_activation="gelu",
    ffn_bias=True,
    norm="layernorm",
    encoder_layers=24,
    enc_seq_divisor=8,
    frontend="audio",
    causal=True,
)
