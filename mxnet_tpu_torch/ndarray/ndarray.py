"""NDArray: MXNet's mutable tensor handle over a ``torch.Tensor``.

Counterpart of ``mxnet_tpu/ndarray/ndarray.py:39-636``.  The JAX package
rebinds an immutable ``jax.Array`` on every "mutation"; here the tensor
is mutable, so a write (``x[:] = v``, ``out=``, an aux-state write-back,
a gradient written by backward) copies into the NDArray's own tensor in
place and never binds a new one: an optimizer or executor that holds the
NDArray sees the new values.  Work is asynchronous on the card as torch
makes it; ``asnumpy`` is the sync point.

Results are new arrays, never views: where ``invoke`` or an NDArray
method would wrap a torch result that shares storage with an input (an
index, a slice, ``reshape``, ``Reshape``, ``Flatten``, an ``astype`` to
the same type), the result is cloned (``_owned``), so writing into it
leaves its parent as it was.  Writes go only through ``__setitem__``,
``out=`` and the in-place operators.  This is the JAX package's rule
(its arrays are immutable); MXNet 0.12 itself returned views for
first-axis slices and reshapes (SURVEY.md §2.1), and the port follows
the JAX package it is held to.

``invoke`` runs a registered op on NDArrays (reference
``Imperative::Invoke``); inside ``autograd.record()`` it runs under
torch's grad mode so that ``backward`` can differentiate it.
"""
from __future__ import annotations

import numpy as np
import torch

from ..base import MXNetError, torch_dtype, np_dtype
from ..context import Context, as_context
from .. import autograd as ag
from .. import random as _random
from ..ops.registry import get_op

__all__ = ["NDArray", "array", "zeros", "ones", "full", "empty", "invoke",
           "concatenate"]


def _owned(t, sources):
    """``t``, cloned when it shares storage with one of the tensors
    ``sources`` (a view or the tensor itself), so that an NDArray result
    never aliases its inputs.  Shape inference's meta tensors have no
    storage and pass as they are."""
    if t.device.type == "meta":
        return t
    ptr = t.untyped_storage().data_ptr()
    if any(x.untyped_storage().data_ptr() == ptr for x in sources):
        return t.clone()
    return t


class NDArray:
    """A mutable n-dimensional array on a device context."""
    __slots__ = ("_data", "_ctx", "_grad", "_grad_req", "_marked",
                 "_fresh_grad", "name", "__weakref__")
    # numpy scalar priority, so  np_scalar * NDArray  dispatches to us
    __array_priority__ = 1000.0

    def __init__(self, data, ctx):
        self._data = data
        self._ctx = ctx
        self._grad = None
        self._grad_req = "null"
        self._marked = False
        self._fresh_grad = False  # gradient written by backward since a step
        self.name = None

    # -- core properties ---------------------------------------------------
    @property
    def shape(self):
        return tuple(self._data.shape)

    @property
    def dtype(self):
        """numpy dtype (``torch.bfloat16``, which numpy lacks, as is)."""
        return np_dtype(self._data.dtype)

    @property
    def size(self):
        return self._data.numel()

    @property
    def ndim(self):
        return self._data.ndim

    @property
    def context(self):
        return self._ctx

    ctx = context

    @property
    def grad(self):
        return self._grad

    def _set_data(self, tensor):
        """Copy ``tensor`` into this array's own tensor, in place."""
        with torch.no_grad():
            self._data.copy_(tensor)
        return self

    # -- host transfer -----------------------------------------------------
    def asnumpy(self):
        """A numpy copy; bfloat16, which numpy lacks, comes back as float32
        (exactly)."""
        t = self._data.detach().cpu()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()

    def __array__(self, dtype=None, copy=None):
        a = self.asnumpy()
        return a.astype(dtype) if dtype is not None else a

    def asscalar(self):
        if self.size != 1:
            raise ValueError("The current array is not a scalar")
        return self.asnumpy().reshape(-1)[0]

    def item(self):
        return self.asscalar()

    def __float__(self):
        return float(self.asscalar())

    def __int__(self):
        return int(self.asscalar())

    def __bool__(self):
        if self.size == 1:
            return bool(self.asscalar())
        raise ValueError("The truth value of an NDArray with multiple "
                         "elements is ambiguous.")

    def __len__(self):
        if not self.shape:
            raise TypeError("len() of unsized object")
        return self.shape[0]

    def __repr__(self):
        return "%s\n<NDArray %s @%s>" % (
            self.asnumpy(), "x".join(str(s) for s in self.shape), self._ctx)

    # -- conversion / copy -------------------------------------------------
    def _derive(self, fn):
        """``fn(tensor)`` as a new NDArray that owns its storage (a copy
        where ``fn`` gave a view); recorded for autograd inside
        ``record()``, cut from the graph outside it."""
        if ag.is_recording():
            with torch.enable_grad():
                out = _owned(fn(self._data), [self._data])
            ag._note_inputs([self], [0])
        else:
            with torch.no_grad():
                out = _owned(fn(self._data), [self._data])
        return NDArray(out, self._ctx)

    def astype(self, dtype):
        return self._derive(lambda t: t.to(torch_dtype(dtype)))

    def copy(self):
        return self._derive(torch.clone)

    def copyto(self, other):
        """Copy into another NDArray (in place) or to a Context."""
        if isinstance(other, Context):
            out = self._derive(lambda t: t.to(other.torch_device, copy=True))
            out._ctx = other
            return out
        if isinstance(other, NDArray):
            if other is not self:
                other._set_data(self._data)
            return other
        raise TypeError("copyto does not support type " + str(type(other)))

    def as_in_context(self, context):
        if context == self._ctx:
            return self
        return self.copyto(context)

    # -- autograd ----------------------------------------------------------
    def attach_grad(self, grad_req="write"):
        ag.mark_variables([self], [NDArray(torch.zeros_like(self._data),
                                           self._ctx)], grad_req)

    def detach(self):
        return NDArray(self._data.detach(), self._ctx)

    def backward(self, out_grad=None, retain_graph=False, train_mode=True):
        ag.backward([self], [out_grad] if out_grad is not None else None,
                    retain_graph=retain_graph, train_mode=train_mode)

    # -- shape ops and reductions (through the registry, so they record) --
    def reshape(self, *shape, **kwargs):
        if len(shape) == 1 and isinstance(shape[0], (tuple, list)):
            shape = tuple(shape[0])
        shape = kwargs.get("shape", shape)
        return invoke(get_op("Reshape"), [self], {"shape": tuple(shape)})[0]

    def flatten(self):
        return invoke(get_op("Flatten"), [self], {})[0]

    def relu(self):
        return invoke(get_op("relu"), [self], {})[0]

    def sum(self, axis=None, keepdims=False):
        return invoke(get_op("sum"), [self],
                      {"axis": axis, "keepdims": keepdims})[0]

    def mean(self, axis=None, keepdims=False):
        return invoke(get_op("mean"), [self],
                      {"axis": axis, "keepdims": keepdims})[0]

    # -- arithmetic --------------------------------------------------------
    _SCALAR_OPS = {
        "elemwise_add": ("_plus_scalar", "_plus_scalar"),
        "elemwise_sub": ("_minus_scalar", "_rminus_scalar"),
        "elemwise_mul": ("_mul_scalar", "_mul_scalar"),
        "elemwise_div": ("_div_scalar", "_rdiv_scalar"),
        "elemwise_mod": ("_mod_scalar", "_rmod_scalar"),
        "elemwise_power": ("_power_scalar", "_rpower_scalar"),
        "_equal": ("_equal_scalar", "_equal_scalar"),
        "_not_equal": ("_not_equal_scalar", "_not_equal_scalar"),
        "_greater": ("_greater_scalar", "_lesser_scalar"),
        "_greater_equal": ("_greater_equal_scalar", "_lesser_equal_scalar"),
        "_lesser": ("_lesser_scalar", "_greater_scalar"),
        "_lesser_equal": ("_lesser_equal_scalar", "_greater_equal_scalar"),
    }

    def _binary(self, opname, other, reverse=False):
        if isinstance(other, NDArray):
            a, b = (other, self) if reverse else (self, other)
            return invoke(get_op(opname), [a, b], {})[0]
        if isinstance(other, (int, float, np.generic, bool)):
            scalar_op = self._SCALAR_OPS[opname][1 if reverse else 0]
            return invoke(get_op(scalar_op), [self],
                          {"scalar": float(other)})[0]
        return NotImplemented

    def __add__(self, o): return self._binary("elemwise_add", o)
    def __radd__(self, o): return self._binary("elemwise_add", o, True)
    def __sub__(self, o): return self._binary("elemwise_sub", o)
    def __rsub__(self, o): return self._binary("elemwise_sub", o, True)
    def __mul__(self, o): return self._binary("elemwise_mul", o)
    def __rmul__(self, o): return self._binary("elemwise_mul", o, True)
    def __truediv__(self, o): return self._binary("elemwise_div", o)
    def __rtruediv__(self, o): return self._binary("elemwise_div", o, True)
    def __mod__(self, o): return self._binary("elemwise_mod", o)
    def __rmod__(self, o): return self._binary("elemwise_mod", o, True)
    def __pow__(self, o): return self._binary("elemwise_power", o)
    def __rpow__(self, o): return self._binary("elemwise_power", o, True)
    def __neg__(self): return invoke(get_op("negative"), [self], {})[0]

    def __eq__(self, o):
        if o is None:
            return False
        return self._binary("_equal", o)

    def __ne__(self, o):
        if o is None:
            return True
        return self._binary("_not_equal", o)

    def __gt__(self, o): return self._binary("_greater", o)
    def __ge__(self, o): return self._binary("_greater_equal", o)
    def __lt__(self, o): return self._binary("_lesser", o)
    def __le__(self, o): return self._binary("_lesser_equal", o)
    __hash__ = object.__hash__

    def __iadd__(self, o):
        return self._set_data((self + o)._data)

    def __isub__(self, o):
        return self._set_data((self - o)._data)

    def __imul__(self, o):
        return self._set_data((self * o)._data)

    def __itruediv__(self, o):
        return self._set_data((self / o)._data)

    # -- indexing ----------------------------------------------------------
    def __getitem__(self, key):
        if isinstance(key, NDArray):
            key = key._data.long()
        return self._derive(lambda t: t[key])

    def __setitem__(self, key, value):
        if isinstance(value, NDArray):
            v = value._data
        elif isinstance(value, (np.ndarray, list, tuple)):
            v = torch.from_numpy(np.array(value)).to(self._data.device)
        else:
            v = value
        with torch.no_grad():
            self._data[key] = v  # casts to this array's dtype


def invoke(op, inputs, attrs, out=None):
    """Run a registered op on NDArrays; record it for autograd inside
    ``record()``.  Returns the list of visible outputs (written into
    ``out`` in place when given).

    Counterpart of ``mxnet_tpu/ndarray/ndarray.py:472-557``.
    """
    if isinstance(op, str):
        op = get_op(op)
    attrs = dict(attrs)
    ctx = attrs.pop("ctx", None)
    ctx = inputs[0]._ctx if ctx is None and inputs else as_context(ctx)
    attrs.pop("name", None)
    tin = [x._data for x in inputs]
    rng = _random.generator(ctx) if op.needs_rng else None
    train = ag.is_training()
    diff_idx = [i for i in range(len(inputs)) if i not in op.nondiff_inputs]
    n_visible = op.n_visible_outputs(attrs)
    if ag.is_recording() and diff_idx:
        with torch.enable_grad():
            tin = [t if i in diff_idx else t.detach()
                   for i, t in enumerate(tin)]
            out_vals = op.traceable(attrs, train_mode=train, rng=rng)(*tin)
            if out is None:
                out_vals = [_owned(v, tin) if i < n_visible else v
                            for i, v in enumerate(out_vals)]
        ag._note_inputs(inputs, diff_idx)
    else:
        with torch.no_grad():
            out_vals = op.apply(tin, attrs, train_mode=train, rng=rng)
            if out is None:
                out_vals = [_owned(v, tin) if i < n_visible else v
                            for i, v in enumerate(out_vals)]

    # aux-state write-back (optimizer state slots, BatchNorm moving stats)
    for aux_in, out_idx in op.aux_updates.items():
        if aux_in < len(inputs):
            inputs[aux_in]._set_data(out_vals[out_idx])

    visible = [NDArray(v, ctx) for v in out_vals[:n_visible]]
    if out is not None:
        outs = out if isinstance(out, (list, tuple)) else [out]
        for dst, src in zip(outs, visible):
            dst._set_data(src._data)
        return list(outs)
    return visible


# --- creation API -----------------------------------------------------------
def array(source_array, ctx=None, dtype=None):
    """An NDArray on ``ctx`` (default: the current context; raises with no
    card).  dtype defaults to the source's for an NDArray, else float32."""
    ctx = as_context(ctx)
    if isinstance(source_array, NDArray):
        src = source_array._data.detach()
        dt = torch_dtype(dtype) if dtype is not None else src.dtype
        return NDArray(src.to(ctx.torch_device, dt, copy=True), ctx)
    src = torch.from_numpy(np.array(source_array))  # owns its memory
    return NDArray(src.to(ctx.torch_device, torch_dtype(dtype)), ctx)


def zeros(shape, ctx=None, dtype=None):
    ctx = as_context(ctx)
    return NDArray(torch.zeros(shape, dtype=torch_dtype(dtype),
                               device=ctx.torch_device), ctx)


def ones(shape, ctx=None, dtype=None):
    ctx = as_context(ctx)
    return NDArray(torch.ones(shape, dtype=torch_dtype(dtype),
                              device=ctx.torch_device), ctx)


def full(shape, val, ctx=None, dtype=None):
    ctx = as_context(ctx)
    return NDArray(torch.full(shape, val, dtype=torch_dtype(dtype),
                              device=ctx.torch_device), ctx)


def empty(shape, ctx=None, dtype=None):
    return zeros(shape, ctx, dtype)


def concatenate(arrays, axis=0, always_copy=True):
    """Join NDArrays along ``axis`` (the ``Concat`` op)."""
    return invoke(get_op("Concat"), list(arrays), {"dim": axis})[0]


def params_from_jax(np_params, executor):
    """The JAX package's ``{name: np.ndarray}`` (``exe.arg_dict[n].asnumpy()``)
    as NDArrays on ``executor``'s context, after checking each name,
    shape and dtype against ``executor.arg_dict``.  Copy them in with
    ``executor.copy_params_from``."""
    out = {}
    for name, value in np_params.items():
        if name not in executor.arg_dict:
            raise MXNetError("params_from_jax: %r is not an argument of the "
                             "executor (%s)" % (name, executor.arg_names))
        dst = executor.arg_dict[name]
        value = np.asarray(value)
        if tuple(value.shape) != dst.shape:
            raise MXNetError("params_from_jax: %s has shape %s, the executor "
                             "wants %s" % (name, value.shape, dst.shape))
        if value.dtype != dst.dtype:
            raise MXNetError("params_from_jax: %s has dtype %s, the executor "
                             "wants %s" % (name, value.dtype, dst.dtype))
        out[name] = array(value, ctx=executor._ctx, dtype=value.dtype)
    return out
