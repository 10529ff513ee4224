"""Gluon: blocks, parameters, layers and the model zoo.

Counterpart of ``mxnet_tpu/gluon``, for what the ResNet path needs:
``Parameter``/``ParameterDict``, ``Block``/``HybridBlock``, ``nn`` and
``model_zoo.vision``.  ``Trainer``, the losses, the data loaders and the
recurrent layers are not ported yet.
"""
from .parameter import (Parameter, ParameterDict,  # noqa: F401
                        DeferredInitializationError)
from .block import Block, HybridBlock  # noqa: F401
from . import nn  # noqa: F401
from . import model_zoo  # noqa: F401
