"""xlstm-125m [ssm] — alternating mLSTM + sLSTM blocks.

12L d_model=768, 4 heads, vocab=50304 (no separate FFN; projections live
inside the xLSTM blocks). [arXiv:2405.04517]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="xlstm-125m",
    arch_type="ssm",
    num_layers=12,
    d_model=768,
    num_heads=4,
    num_kv_heads=4,
    d_ff=0,
    vocab_size=50304,
    block_pattern=("mlstm", "slstm"),
    scan_layers=False,
    chunk_size=128,
    tie_embeddings=True,
    long_context="native",
)
