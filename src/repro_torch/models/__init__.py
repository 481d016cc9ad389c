"""Dense decoder-only language model: config, layers, attention (decode on
kernel D), prefill/decode, inputs, and the reference's weights as the
port's."""
from .config import ModelConfig
from .inputs import SHAPES, InputShape, effective_config, make_batch
from .lm import init_cache, init_model, prefill_step, serve_step

__all__ = ["ModelConfig", "init_model", "init_cache", "prefill_step",
           "serve_step", "SHAPES", "InputShape", "effective_config",
           "make_batch"]
