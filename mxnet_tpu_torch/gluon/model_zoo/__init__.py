"""Gluon model zoo (counterpart of ``mxnet_tpu/gluon/model_zoo``)."""
from . import model_store  # noqa: F401
from . import vision  # noqa: F401
from .vision import get_model  # noqa: F401
