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
Serialization reads and writes the JAX package's files: ``nd.save``/
``load`` over ``stream``, Symbol JSON, ``model`` checkpoints, optimizer
and ``Trainer`` states, with the epoch ``callback``s.  Recurrent nets:
the ``RNN`` op (cuDNN's RNN on the card), ``rnn`` (symbolic cells,
``BucketSentenceIter``), ``mod.BucketingModule`` (its buckets' captured
steps in one memory pool) and ``gluon.rnn``.  The data path: ``recordio``,
the rest of ``io`` (``CSVIter``, ``MNISTIter``, ``ResizeIter``,
``PrefetchingIter``), ``image`` (decode, augmenters, ``ImageIter``,
``ImageDetIter``, ``ImageRecordIter``: libjpeg on host threads, or
nvJPEG on a card) and ``gluon.data``.  Several contexts in one process:
``kvstore`` (``kv``), ``Module`` on a context list with its executor
group, and Gluon's ``Trainer`` and ``split_and_load`` over several
contexts.  The op long tail: the SSD trio (``nd.contrib``/
``sym.contrib``), with greedy NMS as a hand-written kernel (``ops.nms``),
the R-CNN and spatial ops, CTC (and ``gluon.loss.CTCLoss``), ``nd.linalg``,
fft, quantization and count sketch, ``Custom`` ops (``operator``) and the
tensor bridge ``torch``.  The API surface around a training script:
``AttrScope`` (``attribute``), ``cpu_pinned``, ``random.current_seed``,
``autograd.grad``/``get_symbol``, the Symbol's introspection,
``Monitor`` (``monitor``), ``model.FeedForward``, ``visualization``
(``viz``), ``log`` and ``contrib``.  The Module family: ``mod.
SequentialModule``, ``mod.PythonModule``/``PythonLossModule``, the
modules' ``state_names``, and ``Predictor`` (``predict``), the
predict-only entry; JPEG decoding on the card (nvJPEG) for ``imdecode``,
``ImageIter``, ``ImageDetIter`` and the record datasets.  The parallel
tier (``parallel``), one process a rank over ``torch.distributed``: the
rank mesh, the named collectives, ring attention, the ZeRO-1 update over
a data group, the GPipe pipeline, and the LM (``models.transformer``)
and MoE (``models.moe``) sharded over data, sequence and tensor
parallel axes.
"""
from __future__ import annotations

from .base import MXNetError
from .context import (Context, cpu, gpu, cpu_pinned, num_gpus,
                      current_context)
from . import ops, parallel, models
from . import autograd, random, ndarray, symbol, executor, rtc
from .random import seed
from . import attribute, name
from .attribute import AttrScope
from .name import NameManager
from .symbol import Symbol
from .executor import Executor
from . import capture, profiler
from . import initializer, optimizer, lr_scheduler, test_utils
from . import io, metric, gluon, module
from . import stream, model, callback, rnn
from . import recordio, image
from . import kvstore, operator
from . import kvstore as kv
from . import module as mod
from . import ndarray as nd
from . import symbol as sym
from . import initializer as init
from . import optimizer as opt
from .model import FeedForward
from . import monitor, visualization, log, contrib
from .monitor import Monitor
from . import predict
from .predict import Predictor
from . import visualization as viz

__all__ = ["MXNetError", "Context", "cpu", "gpu", "cpu_pinned", "num_gpus",
           "current_context", "seed", "attribute", "AttrScope", "name",
           "NameManager", "Symbol", "Executor", "opt", "FeedForward",
           "monitor", "Monitor", "visualization", "viz", "log", "contrib",
           "predict", "Predictor",
           "ops", "parallel", "models", "autograd", "random", "ndarray",
           "nd", "symbol", "sym", "executor", "rtc", "initializer", "init", "optimizer",
           "capture", "profiler",
           "lr_scheduler",
           "test_utils", "io", "metric", "gluon", "module", "mod",
           "stream", "model", "callback", "rnn", "recordio", "image",
           "kvstore", "kv", "operator", "torch"]

# last: ``mxnet_tpu_torch.torch`` is the tensor bridge (the JAX package's
# name for it), and from here on ``torch`` in this file is the bridge
from . import torch_bridge as torch  # noqa: E402,F401
