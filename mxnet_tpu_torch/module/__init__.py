"""``mod`` namespace: ``Module``, ``BucketingModule``, ``SequentialModule``,
``PythonModule``/``PythonLossModule`` and what they are built from
(counterpart of ``mxnet_tpu/module``; ``fused_group.py`` waits for the
mesh, ROADMAP A.8)."""
from .base_module import BaseModule
from .module import Module, params_from_jax
from .executor_group import DataParallelExecutorGroup
from .cached_step import CachedTrainStep
from .bucketing_module import BucketingModule
from .sequential_module import SequentialModule
from .python_module import PythonModule, PythonLossModule

__all__ = ["BaseModule", "Module", "params_from_jax",
           "DataParallelExecutorGroup", "CachedTrainStep", "BucketingModule",
           "SequentialModule", "PythonModule", "PythonLossModule"]
