"""User-defined operators: ``CustomOp``, ``CustomOpProp``, ``register``.

Counterpart of ``mxnet_tpu/operator.py:45-133`` (the CustomOp protocol
behind the ``Custom`` graph op, ``ops/custom.py``).  The callbacks run
eagerly on the op's context with this package's NDArrays; a program that
holds a ``Custom`` node runs eagerly on the card, never captured.  An
op that should run inside a captured program is registered as a PyTorch
function (``ops.registry.register``) or a kernel (``rtc.register``)
instead.

Usage (as in MXNet)::

    import mxnet_tpu_torch as mt

    class Sigmoid(mt.operator.CustomOp):
        def forward(self, is_train, req, in_data, out_data, aux):
            y = 1.0 / (1.0 + mt.nd.exp(-in_data[0]))
            self.assign(out_data[0], req[0], y)

        def backward(self, req, out_grad, in_data, out_data, in_grad, aux):
            y = out_data[0]
            self.assign(in_grad[0], req[0], out_grad[0] * y * (1 - y))

    @mt.operator.register("sigmoid")
    class SigmoidProp(mt.operator.CustomOpProp):
        def create_operator(self, ctx, shapes, dtypes):
            return Sigmoid()

    out = mt.nd.Custom(x, op_type="sigmoid")
"""
from __future__ import annotations

from .ops.custom import CUSTOM_PROP_REGISTRY, register_prop

__all__ = ["CustomOp", "CustomOpProp", "register",
           "get_all_registered_operators"]


class CustomOp(object):
    """The per-instance forward/backward callbacks."""

    def forward(self, is_train, req, in_data, out_data, aux):
        """Compute outputs from ``in_data`` into ``out_data``."""
        raise NotImplementedError()

    def backward(self, req, out_grad, in_data, out_data, in_grad, aux):
        """Compute input gradients into ``in_grad``."""
        raise NotImplementedError()

    def assign(self, dst, req, src):
        """Store ``src`` (an NDArray or a numpy array) into the NDArray
        ``dst`` as the write request says."""
        if req == "null":
            return
        if req in ("write", "inplace"):
            dst[:] = src
        elif req == "add":
            if not hasattr(src, "asnumpy"):
                from .ndarray import array
                src = array(src, ctx=dst.context, dtype=dst.dtype)
            dst[:] = dst + src
        else:
            raise ValueError("unknown req %r" % req)


class CustomOpProp(object):
    """A custom op's interface: names, shapes, dtypes and the operator
    factory.  ``need_top_grad`` says whether backward reads the output
    gradient (a loss layer sets it False); the output gradient is always
    passed."""

    def __init__(self, need_top_grad=True):
        self.need_top_grad_ = need_top_grad

    def infer_shape(self, in_shape):
        """Default: every output and aux state shaped as the first input."""
        n_out = len(self.list_outputs())
        n_aux = len(self.list_auxiliary_states())
        return (in_shape, [in_shape[0]] * n_out, [in_shape[0]] * n_aux)

    def infer_type(self, in_type):
        """Default: everything takes the first input's dtype."""
        lead = in_type[0]
        return (in_type, [lead] * len(self.list_outputs()),
                [lead] * len(self.list_auxiliary_states()))

    def list_arguments(self):
        return ["data"]

    def list_outputs(self):
        return ["output"]

    def list_auxiliary_states(self):
        return []

    def declare_backward_dependency(self, out_grad, in_data, out_data):
        """The arrays backward reads (informational here)."""
        deps = []
        if self.need_top_grad_:
            deps.extend(out_grad)
        deps.extend(in_data)
        deps.extend(out_data)
        return deps

    def create_operator(self, ctx, in_shapes, in_dtypes):
        return CustomOp()

    def need_top_grad(self):
        return self.need_top_grad_


def register(reg_name):
    """Class decorator registering a CustomOpProp under ``reg_name``, for
    ``nd.Custom(..., op_type=reg_name)`` and ``sym.Custom(...)``."""

    def do_register(prop_cls):
        if not issubclass(prop_cls, CustomOpProp):
            raise TypeError("register() expects a CustomOpProp subclass")
        register_prop(reg_name, prop_cls)
        return prop_cls

    return do_register


def get_all_registered_operators():
    return sorted(CUSTOM_PROP_REGISTRY)
