"""Predict-only inference: a ``-symbol.json`` + ``.params`` checkpoint
bound for forward passes, nothing else.

Counterpart of ``mxnet_tpu/predict.py:27-91`` (``Predictor``, the
reference's ``c_predict_api``: MXPredCreate, MXPredSetInput,
MXPredForward, MXPredGetOutput)::

    pred = Predictor.load("model-prefix", 3,
                          input_shapes={"data": (1, 3, 224, 224)})
    probs = pred.forward(data=batch)[0]

The executor is bound on ``ctx`` (default: the current context, so the
card) with no gradients, and ``forward`` is its captured
``forward(is_train=False)``: one capture for the input shapes, then
replays (``executor``).  Inputs are copied into the bound arrays in
place.  An argument named ``*_label`` (a loss head's label, unused at
inference) is bound to zeros; any other argument or aux state missing
from the checkpoint raises ``MXNetError``.  The JAX package binds the
inputs at float32; here they take the dtype the floating parameters
share (float32 where they share none), so an fp64 checkpoint runs in
fp64 (the JAX package promotes its float32 inputs there).

The JAX package's ``_EmbeddedPredictor`` (the native C predict API's
shim) comes with ``c_api_shim`` (ROADMAP A.10) and its
``tracecheck_programs`` with the lint tier (A.11).
"""
from __future__ import annotations

import numpy as np

from . import ndarray as nd
from .base import MXNetError
from .context import as_context
from .executor import load_into

__all__ = ["Predictor"]


def _input_dtype(arg_params):
    """The dtype the floating parameters share, else float32."""
    dtypes = {a._data.dtype for a in arg_params.values()
              if a._data.is_floating_point()}
    return dtypes.pop() if len(dtypes) == 1 else np.float32


class Predictor(object):
    """A bound inference-only executor over a saved checkpoint."""

    def __init__(self, symbol, arg_params, aux_params, input_shapes,
                 ctx=None):
        ctx = as_context(ctx)
        self._ctx = ctx
        self._input_names = list(input_shapes)
        self._symbol = symbol
        self._input_shapes = {n: tuple(s) for n, s in input_shapes.items()}
        dtype = _input_dtype(arg_params)
        arg_shapes, _, aux_shapes = symbol.infer_shape(**self._input_shapes)
        if arg_shapes is None:
            raise MXNetError("cannot infer the argument shapes from the "
                             "input shapes %s" % self._input_shapes)
        args = {}
        for name, shape in zip(symbol.list_arguments(), arg_shapes):
            if name in self._input_shapes:
                args[name] = nd.zeros(self._input_shapes[name], ctx=ctx,
                                      dtype=dtype)
            elif name in arg_params:
                args[name] = arg_params[name].as_in_context(ctx)
            elif name.endswith("_label"):
                args[name] = nd.zeros(shape, ctx=ctx, dtype=dtype)
            else:
                raise MXNetError("checkpoint is missing parameter %r" % name)
        auxs = {}
        for name in symbol.list_auxiliary_states():
            if name not in aux_params:
                raise MXNetError("checkpoint is missing aux state %r" % name)
            auxs[name] = aux_params[name].as_in_context(ctx)
        self._exe = symbol.bind(ctx, args, aux_states=auxs, grad_req="null")
        self.output_names = symbol.list_outputs()

    @classmethod
    def load(cls, prefix, epoch, input_shapes, ctx=None):
        """A predictor from ``prefix-symbol.json`` and
        ``prefix-{epoch:04d}.params`` (MXPredCreate)."""
        from .model import load_checkpoint
        symbol, arg_params, aux_params = load_checkpoint(prefix, epoch)
        return cls(symbol, arg_params, aux_params, input_shapes, ctx=ctx)

    def set_input(self, **inputs):
        """Copy inputs into the bound arrays by name (MXPredSetInput)."""
        for name, value in inputs.items():
            if name not in self._input_names:
                raise MXNetError("unknown input %r (have %s)"
                                 % (name, self._input_names))
            arr = self._exe.arg_dict[name]
            shape = tuple(getattr(value, "shape", None) or np.shape(value))
            if shape != tuple(arr.shape):
                raise MXNetError("input %r is %s, the predictor is bound at "
                                 "%s" % (name, shape, tuple(arr.shape)))
            load_into(arr, value)

    def forward(self, **inputs):
        """Set ``inputs`` (optional) and run inference; the outputs
        (MXPredForward + MXPredGetOutput)."""
        if inputs:
            self.set_input(**inputs)
        return self._exe.forward(is_train=False)

    def get_output(self, index=0):
        return self._exe.outputs[index]
