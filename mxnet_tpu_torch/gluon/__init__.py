"""Gluon: blocks, parameters, layers, losses, the Trainer and the model
zoo.

Counterpart of ``mxnet_tpu/gluon``: ``Parameter``/``ParameterDict``,
``Block``/``HybridBlock`` (``hybridize()`` runs a block through one
traced graph, its ``_CachedOp``) and ``SymbolBlock``, ``nn``, ``loss``,
``Trainer`` with its fused step, ``utils``, ``model_zoo.vision`` and
``rnn`` (the recurrent cells and layers) and ``data`` (datasets,
samplers, ``DataLoader``, the vision datasets).  ``CTCLoss`` is not
ported yet.
"""
from .parameter import (Parameter, ParameterDict,  # noqa: F401
                        DeferredInitializationError)
from .block import Block, HybridBlock, SymbolBlock  # noqa: F401
from .trainer import Trainer  # noqa: F401
from . import nn  # noqa: F401
from . import loss  # noqa: F401
from . import utils  # noqa: F401
from . import model_zoo  # noqa: F401
from . import rnn  # noqa: F401
from . import data  # noqa: F401
