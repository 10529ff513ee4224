"""The ``Custom`` operator: user-defined Python ops inside the graph.

Counterpart of ``mxnet_tpu/ops/custom.py:30-222`` (the prop registry and
the graph op; the user-facing classes are in ``operator.py``).  The JAX
package runs the user's ``forward``/``backward`` on the host behind
``jax.pure_callback`` with numpy-backed arrays; here they run eagerly on
the op's context and receive this package's NDArrays there (a CUDA
tensor's ``asnumpy`` syncs with the card).  Shapes and dtypes come from
the prop's ``infer_shape``/``infer_type``, which is also all that shape
inference on ``meta`` tensors runs.  The gradient is a ``custom_vjp``
that calls the user's ``backward``; auxiliary states are passed read-only
(with the JAX package's warning) and get zero gradient.

A ``Custom`` op is a host callback (``Op.host_callback``): a program that
holds one cannot be captured as a CUDA graph, so ``capture.graph_for``
runs it eagerly (counted in ``host_op_programs``), decided from the
Symbol before any capture is tried.
"""
from __future__ import annotations

import warnings

import numpy as np
import torch

from ..base import MXNetError, torch_dtype
from .registry import register

__all__ = ["CUSTOM_PROP_REGISTRY", "register_prop", "instantiate"]

# op_type -> CustomOpProp subclass
CUSTOM_PROP_REGISTRY = {}


def register_prop(reg_name, prop_cls):
    CUSTOM_PROP_REGISTRY[reg_name] = prop_cls


def instantiate(attrs):
    """The user's CustomOpProp built from the op attrs (every kwarg but
    ``op_type`` handed over as a string, the reference contract)."""
    op_type = attrs.get("op_type")
    if not op_type:
        raise MXNetError("Custom op requires op_type=")
    if op_type not in CUSTOM_PROP_REGISTRY:
        raise MXNetError("Custom op type %r is not registered (use "
                         "mxnet_tpu_torch.operator.register)" % op_type)
    spec = {k: str(v) for k, v in attrs.items()
            if k != "op_type" and not (k.startswith("__") and
                                        k.endswith("__"))}
    return CUSTOM_PROP_REGISTRY[op_type](**spec)


def _resolve(prop, tensors):
    """(n_args, output shapes, output dtypes) from the prop's inference."""
    n_args = len(prop.list_arguments())
    shaped = prop.infer_shape([list(t.shape) for t in tensors[:n_args]])
    typed = prop.infer_type([np.dtype(str(t.dtype).replace("torch.", ""))
                             for t in tensors[:n_args]])
    out_types = [torch_dtype(np.dtype(t)) for t in typed[1]]
    return n_args, [tuple(int(d) for d in s) for s in shaped[1]], out_types


def _context(tensor):
    from ..context import Context
    dev = tensor.device
    return Context("gpu", dev.index or 0) if dev.type == "cuda" \
        else Context("cpu", 0)


def _wrap(tensors, ctx):
    from ..ndarray.ndarray import NDArray
    return [NDArray(t.detach(), ctx) for t in tensors]


def _zeros(shapes, dtypes, device, ctx):
    return _wrap([torch.zeros(s, dtype=d, device=device)
                  for s, d in zip(shapes, dtypes)], ctx)


def _n_outputs(attrs):
    return len(instantiate(attrs).list_outputs())


def _custom_forward(*tensors, train_mode=False, **attrs):
    from .. import autograd
    prop = instantiate(attrs)
    n_args, out_shapes, out_types = _resolve(prop, tensors)
    dev = tensors[0].device
    if dev.type == "meta":
        return tuple(torch.empty(s, dtype=d, device=dev)
                     for s, d in zip(out_shapes, out_types))
    if prop.list_auxiliary_states():
        warnings.warn(
            "Custom op %r declares auxiliary states; they are passed to the "
            "callbacks read-only: an in-place change to one does not reach "
            "the graph" % attrs.get("op_type"), stacklevel=2)
    ctx = _context(tensors[0])
    ins = _wrap(tensors[:n_args], ctx)
    auxs = _wrap([t.clone() for t in tensors[n_args:]], ctx)  # read-only
    outs = _zeros(out_shapes, out_types, dev, ctx)
    op = prop.create_operator(ctx, [list(a.shape) for a in ins],
                              [a.dtype for a in ins])
    with autograd.pause(train_mode=train_mode):
        op.forward(is_train=train_mode, req=["write"] * len(outs),
                   in_data=ins, out_data=outs, aux=auxs)
    return tuple(o._data.to(t) for o, t in zip(outs, out_types))


def _custom_backward(out_grads, inputs, outputs, attrs):
    from .. import autograd
    prop = instantiate(attrs)
    n_args = len(prop.list_arguments())
    ctx = _context(inputs[0])
    ins = _wrap(inputs[:n_args], ctx)
    auxs = _wrap([t.clone() for t in inputs[n_args:]], ctx)
    grads = [torch.zeros_like(t) for t in inputs[:n_args]]
    in_grads = _wrap(grads, ctx)
    op = prop.create_operator(ctx, [list(a.shape) for a in ins],
                              [a.dtype for a in ins])
    with autograd.pause():
        op.backward(req=["write"] * n_args,
                    out_grad=_wrap([g if g is not None else torch.zeros_like(o)
                                    for g, o in zip(out_grads, outputs)], ctx),
                    in_data=ins, out_data=_wrap(outputs, ctx),
                    in_grad=in_grads, aux=auxs)
    return [g._data for g in in_grads] + [torch.zeros_like(a)
                                          for a in inputs[n_args:]]


register("Custom", num_outputs=_n_outputs, takes_mode=True,
         custom_vjp=_custom_backward, host_callback=True)(_custom_forward)
