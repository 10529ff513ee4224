"""The 2017 ``contrib.autograd`` API, over :mod:`mxnet_tpu_torch.autograd`.

Counterpart of ``mxnet_tpu/contrib/autograd.py:1-19``: ``train_section``
is ``record``, ``test_section`` is ``pause``, ``set_is_training`` is
``set_recording``, and ``compute_gradient`` is ``backward``.
"""
from ..autograd import (backward, grad, mark_variables, pause, record,
                        set_recording as set_is_training)
from ..autograd import record as train_section          # noqa: F401
from ..autograd import pause as test_section            # noqa: F401

__all__ = ["set_is_training", "mark_variables", "backward", "grad",
           "train_section", "test_section", "compute_gradient"]


def compute_gradient(outputs):
    """The gradients of ``outputs`` into the marked variables' buffers."""
    backward(outputs)
