"""Image IO and augmentation (counterpart of ``mxnet_tpu/image``):
``imdecode`` and the resizes, crops and augmenters, ``ImageIter``, the
detection augmenters with ``ImageDetIter``, and ``ImageRecordIter``."""
from .image import *  # noqa: F401,F403
from . import image  # noqa: F401
from .detection import *  # noqa: F401,F403
from . import detection  # noqa: F401
from . import native_iter  # noqa: F401
from .native_iter import ImageRecordIter  # noqa: F401
