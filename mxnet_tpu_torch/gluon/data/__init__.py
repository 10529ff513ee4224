"""Gluon's data API (counterpart of ``mxnet_tpu/gluon/data``): datasets,
samplers, ``DataLoader`` and the vision datasets.  Batches are host
(``cpu()``) NDArrays; a training loop moves each to the card once
(``gluon.utils.split_and_load`` or ``as_in_context``)."""
from .dataset import *  # noqa: F401,F403
from .sampler import *  # noqa: F401,F403
from .dataloader import *  # noqa: F401,F403
from . import vision  # noqa: F401
