"""phi-3-vision-4.2b [vlm] — phi3-mini LM backbone + CLIP ViT-L/14 frontend.

32L d_model=3072, 32 heads (kv=32), d_ff=8192, vocab=32064.
[hf:microsoft/Phi-3-vision-128k-instruct] Vision encoder + projector are a
stub: input_specs provides projected patch embeddings (576 tokens/image)."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="phi-3-vision-4.2b",
    arch_type="vlm",
    num_layers=32,
    d_model=3072,
    num_heads=32,
    num_kv_heads=32,
    d_ff=8192,
    vocab_size=32064,
    ffn_activation="swiglu",
    frontend="vision",
    num_patch_tokens=576,
)
