"""``PythonModule`` and ``PythonLossModule``: modules written in Python.

Counterpart of ``mxnet_tpu/module/python_module.py:22-141``
(``PythonModule`` :22, ``PythonLossModule`` :103): a module whose
computation is Python code, used to splice a hand-written loss or glue
into a ``SequentialModule`` chain.  No executor is bound and there are no
parameters.  ``PythonLossModule`` passes its input on as its output, and
its ``backward`` asks ``grad_func(scores, labels)`` for the input
gradient.  Both run on a context (default: the current one, so the
card): the scores and labels reach ``grad_func`` as NDArrays there, and
the gradient it returns is put there.
"""
from __future__ import annotations

import logging

import numpy as np

from .. import context as ctx_mod
from .. import ndarray as nd
from .base_module import BaseModule

__all__ = ["PythonModule", "PythonLossModule"]


class PythonModule(BaseModule):
    """Subclass and implement ``forward``/``backward`` (and
    ``_compute_output_shapes``) in Python; no parameters."""

    def __init__(self, data_names, label_names, output_names, logger=logging,
                 context=None):
        super().__init__(logger=logger)
        self._context = ctx_mod.as_context(context)
        self._data_names = list(data_names)
        self._label_names = list(label_names or [])
        self._output_names = list(output_names)
        self._data_shapes = self._label_shapes = None
        self._output_shapes = None

    data_names = property(lambda self: self._data_names)
    output_names = property(lambda self: self._output_names)
    data_shapes = property(lambda self: self._data_shapes)
    label_shapes = property(lambda self: self._label_shapes)
    output_shapes = property(lambda self: self._output_shapes)

    def get_params(self):
        return {}, {}

    def init_params(self, initializer=None, arg_params=None, aux_params=None,
                    allow_missing=False, force_init=False, allow_extra=False):
        self.params_initialized = True

    def update(self):
        pass

    def update_metric(self, eval_metric, labels):
        if self._label_shapes is not None:
            eval_metric.update(labels, self.get_outputs())

    def bind(self, data_shapes, label_shapes=None, for_training=True,
             inputs_need_grad=False, force_rebind=False, shared_module=None,
             grad_req="write"):
        if self.binded and not force_rebind:
            self.logger.warning("Already bound, ignoring bind()")
            return
        self.for_training = for_training
        self.inputs_need_grad = inputs_need_grad
        self._data_shapes = data_shapes
        self._label_shapes = label_shapes
        self._output_shapes = self._compute_output_shapes()
        self.binded = True

    def _compute_output_shapes(self):
        """The (name, shape) of each output, from the bound input shapes."""
        raise NotImplementedError()

    def init_optimizer(self, kvstore="local", optimizer="sgd",
                       optimizer_params=(("learning_rate", 0.01),),
                       force_init=False):
        self.optimizer_initialized = True

    def install_monitor(self, mon):
        pass


class PythonLossModule(PythonModule):
    """A last stage that passes its input on as its output; ``backward``
    takes the input gradient from ``grad_func(scores, labels)``."""

    def __init__(self, name="pyloss", data_names=("data",),
                 label_names=("softmax_label",), logger=logging,
                 grad_func=None, context=None):
        super().__init__(data_names, label_names, (name + "_output",),
                         logger=logger, context=context)
        self._name = name
        self._scores = self._labels = self._scores_grad = None
        if grad_func is not None and not callable(grad_func):
            raise TypeError("grad_func must be callable")
        self._grad_func = grad_func

    def _compute_output_shapes(self):
        return [(self._name + "_output", self._data_shapes[0].shape)]

    def forward(self, data_batch, is_train=None):
        self._scores = data_batch.data[0].as_in_context(self._context)
        if data_batch.label:
            self._labels = data_batch.label[0].as_in_context(
                self._context)

    def get_outputs(self, merge_multi_context=True):
        return [self._scores]

    def backward(self, out_grads=None):
        if self._grad_func is None:
            raise NotImplementedError(
                "PythonLossModule requires grad_func (or override backward)")
        grad = self._grad_func(self._scores, self._labels)
        if isinstance(grad, nd.NDArray):
            grad = grad.as_in_context(self._context)
        else:
            grad = nd.array(np.asarray(grad), ctx=self._context)
        self._scores_grad = grad

    def get_input_grads(self, merge_multi_context=True):
        return [self._scores_grad]
