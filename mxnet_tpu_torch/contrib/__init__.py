"""``contrib``: the old autograd API and the TensorBoard callback.

Counterpart of ``mxnet_tpu/contrib/__init__.py``.
"""
from . import autograd  # noqa: F401
from . import tensorboard  # noqa: F401
