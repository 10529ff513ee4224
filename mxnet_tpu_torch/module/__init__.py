"""``mod`` namespace: ``Module``, ``BucketingModule`` and what they are
built from (counterpart of ``mxnet_tpu/module``, one context;
``SequentialModule`` and ``PythonModule`` are not ported yet)."""
from .base_module import BaseModule
from .module import Module, params_from_jax
from .executor_group import DataParallelExecutorGroup
from .cached_step import CachedTrainStep
from .bucketing_module import BucketingModule

__all__ = ["BaseModule", "Module", "params_from_jax",
           "DataParallelExecutorGroup", "CachedTrainStep", "BucketingModule"]
