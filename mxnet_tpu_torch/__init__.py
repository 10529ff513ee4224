"""PyTorch/CUDA port of the MXNet-capability framework.

A second package beside ``mxnet_tpu`` (the JAX reference).  It imports
``torch`` and never ``jax`` or ``mxnet_tpu``.  Every Pallas kernel of the
JAX package becomes a kernel written by hand for Hopper (``sm_90a``),
built from the sources under ``ops/csrc`` at first use.

Ported so far: the transformer LM (``models.transformer``), inference and
the train steps (plain SGD, and SGD with momentum through the one-rank
ZeRO-1 update of ``parallel.zero``), through the flash-attention forward
and backward kernels (``ops.attention``); the MXNet
substrate -- ``nd`` (NDArray, op registry, ``autograd``), ``sym``
(Symbol) and bound executors, ``initializer``, ``optimizer`` (the
twelve update rules, each with a fused multi-tensor update) and
``lr_scheduler`` -- and user-kernel registration (``rtc``) with the
scale kernel (``ops.scale``); the ResNet training path -- ``gluon``
(blocks with ``hybridize()`` as a cached graph, layers, losses,
``Trainer`` with its fused step, the ResNet model zoo), ``io``
(``NDArrayIter``), ``metric`` and ``mod`` (``Module`` with its fused
train step).  On the card each training step replays CUDA graphs
captured once (``capture``, with the counters of ``profiler``).
"""
from __future__ import annotations

from .base import MXNetError
from .context import Context, cpu, gpu, current_context
from . import ops, parallel, models
from . import autograd, random, ndarray, symbol, executor, rtc
from . import capture, profiler
from . import initializer, optimizer, lr_scheduler, test_utils
from . import io, metric, gluon, module
from . import module as mod
from . import ndarray as nd
from . import symbol as sym
from . import initializer as init

__all__ = ["MXNetError", "Context", "cpu", "gpu", "current_context",
           "ops", "parallel", "models", "autograd", "random", "ndarray",
           "nd", "symbol", "sym", "executor", "rtc", "initializer", "init", "optimizer",
           "capture", "profiler",
           "lr_scheduler",
           "test_utils", "io", "metric", "gluon", "module", "mod"]
