"""Decoder-only language model (dense, MoE, SSM and hybrid): config,
layers, attention (decode on kernel D), mixture-of-experts layers, the SSM
and recurrent blocks (:mod:`.ssm`), prefill/decode, inputs, and the
reference's weights as the port's."""
from .config import ModelConfig
from .inputs import SHAPES, InputShape, effective_config, make_batch
from .lm import (init_cache, init_model, model_hidden_train, prefill_step,
                 serve_step, train_loss)
from .moe import init_moe, moe_decode, moe_forward

__all__ = ["ModelConfig", "init_model", "init_cache", "model_hidden_train",
           "train_loss", "prefill_step", "serve_step", "init_moe",
           "moe_forward", "moe_decode", "SHAPES", "InputShape",
           "effective_config", "make_batch"]
