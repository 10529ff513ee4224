"""Models of the PyTorch package.

``transformer``: the causal transformer LM (inference and the train
steps, on one device or a rank mesh), counterpart of
``mxnet_tpu/models/transformer.py``; ``moe``: the routed expert FFN with
expert parallelism, counterpart of ``mxnet_tpu/models/moe.py``.
"""
from .transformer import (TransformerLMConfig, TransformerLM,
                          init_transformer_params, params_from_jax,
                          transformer_forward, nll_from_logits,
                          lm_nll, make_train_step, make_train_step_zero1,
                          place_batch)
from .moe import init_moe_params, moe_ffn, moe_param_specs
from . import moe, transformer

__all__ = ["TransformerLMConfig", "TransformerLM", "init_transformer_params",
           "params_from_jax", "transformer_forward", "nll_from_logits",
           "lm_nll", "make_train_step", "make_train_step_zero1",
           "place_batch", "init_moe_params", "moe_ffn", "moe_param_specs",
           "moe", "transformer"]
