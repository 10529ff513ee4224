"""Models of the PyTorch package.

``transformer``: the causal transformer LM (inference and the train
steps), counterpart of ``mxnet_tpu/models/transformer.py``.
"""
from .transformer import (TransformerLMConfig, TransformerLM,
                          init_transformer_params, params_from_jax,
                          transformer_forward, nll_from_logits,
                          lm_nll, make_train_step, make_train_step_zero1,
                          place_batch)

__all__ = ["TransformerLMConfig", "TransformerLM", "init_transformer_params",
           "params_from_jax", "transformer_forward", "nll_from_logits",
           "lm_nll", "make_train_step", "make_train_step_zero1",
           "place_batch"]
