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
torch's grad mode so that ``backward`` can differentiate it.  A CSR
input reaches an op that takes one (the registry's ``csr_inputs``:
``dot``'s left operand) as its parts, and any other op as its dense view
(``ndarray.sparse``).

``stype`` is the storage tag: ``default`` here, ``row_sparse`` or
``csr`` on the arrays of ``ndarray.sparse``, and on a dense array that
``kvstore.row_sparse_pull`` wrote or a pickle restored, as in the JAX
package.
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
           "concatenate", "arange", "eye", "moveaxis", "onehot_encode",
           "waitall"]


def _owned(t, sources):
    """``t``, cloned when it shares storage with one of the tensors
    ``sources`` (a view or the tensor itself), so that an NDArray result
    never aliases its inputs.  Shape inference's meta tensors have no
    storage and pass as they are."""
    if t.device.type == "meta":
        return t
    ptr = t.untyped_storage().data_ptr()
    if any(isinstance(x, torch.Tensor)
           and x.untyped_storage().data_ptr() == ptr for x in sources):
        return t.clone()
    return t


class NDArray:
    """A mutable n-dimensional array on a device context."""
    __slots__ = ("_data", "_ctx", "_stype", "_grad", "_grad_req",
                 "_marked", "_fresh_grad", "_node", "_reading", "name",
                 "__weakref__")
    # numpy scalar priority, so  np_scalar * NDArray  dispatches to us
    __array_priority__ = 1000.0

    def __init__(self, data, ctx, stype="default"):
        self._data = data
        self._ctx = ctx
        self._stype = stype
        self._grad = None
        self._grad_req = "null"
        self._marked = False
        self._fresh_grad = False  # gradient written by backward since a step
        self._node = None  # what a recorded op keeps (``invoke``)
        self._reading = None  # event of an asynchronous copy from it
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
    def stype(self):
        """The storage tag: ``default``, ``row_sparse`` or ``csr``."""
        return self._stype

    @property
    def grad(self):
        return self._grad

    @property
    def T(self):
        """The transpose (the ``transpose`` op: all axes reversed)."""
        return invoke(get_op("transpose"), [self], {})[0]

    def wait_to_read(self):
        """Block until the work that writes this array has run."""
        if self._data.is_cuda:
            torch.cuda.current_stream(self._data.device).synchronize()

    def wait_to_write(self):
        """Block until the work that reads or writes this array has run."""
        self._await_readers()
        self.wait_to_read()

    def _await_readers(self):
        """Block until the asynchronous copies from this page-locked array
        to the card have read it, so that a host write cannot reach them
        (MXNet orders a write after the reads before it)."""
        if self._reading is not None:
            self._reading.synchronize()
            self._reading = None

    def _set_data(self, tensor):
        """Copy ``tensor`` into this array's own tensor, in place."""
        self._await_readers()
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

    def __iter__(self):
        for i in range(len(self)):
            yield self[i]

    def __repr__(self):
        return "%s\n<NDArray %s @%s>" % (
            self.asnumpy(), "x".join(str(s) for s in self.shape), self._ctx)

    def __reduce__(self):
        """A plain pickle of this package: the tensor on the host, the
        context and the storage tag, restored there as a dense array with
        the tag (a sparse array too, as the JAX package restores it).
        Optimizer-state files use the form that both packages read
        instead (``_pickle.dumps``)."""
        return (_nd_rebuild, (self._data.detach().cpu(),
                              self._ctx.device_type, self._ctx.device_id,
                              self._stype))

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
            # a page-locked source copies to the card asynchronously; its
            # next write waits for the copy (``_await_readers``)
            dev = other.torch_device
            early = self._data.is_pinned() and dev.type == "cuda"
            out = self._derive(lambda t: other.place(t.to(
                dev, copy=True, non_blocking=early)))
            if early:
                self._reading = torch.cuda.Event()
                self._reading.record(torch.cuda.current_stream(dev))
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

    def tostype(self, stype):
        """A copy in storage ``stype`` (``ndarray.sparse.cast_storage``)."""
        from .sparse import cast_storage
        return cast_storage(self, stype)

    def _operand(self):
        """What an op reads of this array: its tensor (a CSR its parts,
        which ``Op.operand`` turns into the dense view where the op takes
        no CSR)."""
        return self._data

    # -- autograd ----------------------------------------------------------
    def attach_grad(self, grad_req="write", stype=None):
        """A dense gradient buffer, whatever ``stype`` asks, as in the
        JAX package."""
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

    def _op(self, name, *others, **attrs):
        return invoke(get_op(name), [self, *others], attrs)[0]

    def reshape_like(self, other):
        return self._op("reshape_like", other)

    def expand_dims(self, axis):
        return self._op("expand_dims", axis=axis)

    def transpose(self, axes=None):
        return self._op("transpose", axes=axes)

    def swapaxes(self, dim1, dim2):
        return self._op("SwapAxis", dim1=dim1, dim2=dim2)

    def split(self, num_outputs, axis=1, squeeze_axis=False):
        return invoke(get_op("SliceChannel"), [self],
                      {"num_outputs": num_outputs, "axis": axis,
                       "squeeze_axis": squeeze_axis})

    def slice(self, begin, end, step=None):
        return self._op("slice", begin=begin, end=end, step=step)

    def slice_axis(self, axis, begin, end):
        return self._op("slice_axis", axis=axis, begin=begin, end=end)

    def take(self, indices, axis=0, mode="clip"):
        return self._op("take", indices, axis=axis, mode=mode)

    def pick(self, index, axis=-1, keepdims=False):
        return self._op("pick", index, axis=axis, keepdims=keepdims)

    def one_hot(self, depth, **kw):
        return self._op("one_hot", depth=depth, **kw)

    def broadcast_to(self, shape):
        return self._op("broadcast_to", shape=tuple(shape))

    def broadcast_axes(self, axis, size):
        return self._op("broadcast_axis", axis=axis, size=size)

    def tile(self, reps):
        return self._op("tile", reps=reps)

    def repeat(self, repeats, axis=None):
        return self._op("repeat", repeats=repeats, axis=axis)

    def pad(self, mode, pad_width, constant_value=0.0):
        return self._op("Pad", mode=mode, pad_width=pad_width,
                        constant_value=constant_value)

    def flip(self, axis):
        return self._op("reverse", axis=axis)

    def clip(self, a_min, a_max):
        return self._op("clip", a_min=a_min, a_max=a_max)

    def abs(self):
        return self._op("abs")

    def sign(self):
        return self._op("sign")

    def sqrt(self):
        return self._op("sqrt")

    def square(self):
        return self._op("square")

    def exp(self):
        return self._op("exp")

    def log(self):
        return self._op("log")

    def sigmoid(self):
        return self._op("sigmoid")

    def tanh(self):
        return self._op("tanh")

    def relu(self):
        return self._op("relu")

    def softmax(self, axis=-1):
        return self._op("softmax", axis=axis)

    def log_softmax(self, axis=-1):
        return self._op("log_softmax", axis=axis)

    def dot(self, other, **kw):
        return self._op("dot", other, **kw)

    def _reduce(self, opname, axis=None, keepdims=False, **kw):
        return self._op(opname, axis=axis, keepdims=keepdims, **kw)

    def sum(self, axis=None, keepdims=False):
        return self._reduce("sum", axis, keepdims)

    def mean(self, axis=None, keepdims=False):
        return self._reduce("mean", axis, keepdims)

    def prod(self, axis=None, keepdims=False):
        return self._reduce("prod", axis, keepdims)

    def max(self, axis=None, keepdims=False):
        return self._reduce("max", axis, keepdims)

    def min(self, axis=None, keepdims=False):
        return self._reduce("min", axis, keepdims)

    def nansum(self, axis=None, keepdims=False):
        return self._reduce("nansum", axis, keepdims)

    def nanprod(self, axis=None, keepdims=False):
        return self._reduce("nanprod", axis, keepdims)

    def argmax(self, axis=None, keepdims=False):
        return self._reduce("argmax", axis, keepdims)

    def argmin(self, axis=None, keepdims=False):
        return self._reduce("argmin", axis, keepdims)

    def norm(self, ord=2, axis=None, keepdims=False):
        return self._op("norm", ord=ord, axis=axis, keepdims=keepdims)

    def argsort(self, axis=-1, is_ascend=True):
        return self._op("argsort", axis=axis, is_ascend=is_ascend)

    def sort(self, axis=-1, is_ascend=True):
        return self._op("sort", axis=axis, is_ascend=is_ascend)

    def topk(self, axis=-1, k=1, ret_typ="indices", is_ascend=False):
        """The list of outputs (one, or two for ``ret_typ="both"``), as
        the JAX package's method returns them."""
        return invoke(get_op("topk"), [self],
                      {"axis": axis, "k": k, "ret_typ": ret_typ,
                       "is_ascend": is_ascend})

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
        "elemwise_maximum": ("_maximum_scalar", "_maximum_scalar"),
        "elemwise_minimum": ("_minimum_scalar", "_minimum_scalar"),
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
    def __matmul__(self, o): return self.dot(o)
    def __neg__(self): return invoke(get_op("negative"), [self], {})[0]
    def __abs__(self): return invoke(get_op("abs"), [self], {})[0]

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
        self._await_readers()
        with torch.no_grad():
            self._data[key] = v  # casts to this array's dtype


def _nd_rebuild(tensor, device_type, device_id, stype="default"):
    ctx = Context(device_type, device_id)
    return NDArray(ctx.place(tensor.to(ctx.torch_device)), ctx, stype)


def _nd_unpickle(npy, dev_type, dev_id, stype):
    """An NDArray from the JAX package's pickled form
    (``mxnet_tpu/ndarray/ndarray.py:462``), which ``_pickle.loads`` maps
    to this function: on ``cpu(0)`` whatever context the file names (an
    optimizer state moves to its weight's context at its next update).
    ``npy`` is a numpy array, or a ``_pickle.HostArray`` of raw bfloat16
    words.  A sparse array comes back dense with its storage tag, as the
    JAX package's ``_nd_unpickle`` gives it."""
    bf16 = getattr(npy, "bfloat16", False)
    host = np.array(npy, dtype=np.int16 if bf16 else None, order="C")
    try:
        tensor = torch.from_numpy(host)
    except TypeError as e:
        raise MXNetError("cannot load an NDArray of dtype %s" % host.dtype) \
            from e
    return NDArray(tensor.view(torch.bfloat16) if bf16 else tensor,
                   Context("cpu", 0), stype)


def invoke(op, inputs, attrs, out=None):
    """Run a registered op on NDArrays; record it for autograd inside
    ``record()``.  Returns the list of visible outputs (written into
    ``out`` in place when given).  A recorded op's outputs also keep
    (op, attrs, inputs, output index, visible outputs) in ``_node``,
    which ``autograd.get_symbol`` reads: an input that a recorded op made
    is kept as its ``_node``, any other as the array, so that no
    intermediate tensor outlives its use.  Nothing is kept outside
    ``record()``.

    Counterpart of ``mxnet_tpu/ndarray/ndarray.py:472-557``.
    """
    if isinstance(op, str):
        op = get_op(op)
    attrs = dict(attrs)
    ctx = attrs.pop("ctx", None)
    ctx = inputs[0]._ctx if ctx is None and inputs else as_context(ctx)
    attrs.pop("name", None)
    if op.no_inputs:  # a creation op makes its output on the context
        attrs["ctx"] = ctx.torch_device
    tin = [op.operand(i, x._operand()) for i, x in enumerate(inputs)]
    rng = _random.generator(ctx) if op.needs_rng else None
    train = ag.is_training()
    diff_idx = [i for i in range(len(inputs)) if i not in op.nondiff_inputs]
    n_visible = op.n_visible_outputs(attrs)
    recording = ag.is_recording() and bool(diff_idx)
    if recording:
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
    if recording and out is None:
        # what autograd.get_symbol rebuilds the recorded graph from; an
        # output keeps its index, not its siblings (no reference cycle)
        ins = [x._node or x for x in inputs]
        for i, o in enumerate(visible):
            o._node = (op, attrs, ins, i, len(visible))
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
        return NDArray(ctx.place(src.to(ctx.torch_device, dt, copy=True)),
                       ctx)
    src = torch.from_numpy(np.array(source_array))  # owns its memory
    return NDArray(ctx.place(src.to(ctx.torch_device, torch_dtype(dtype))),
                   ctx)


def zeros(shape, ctx=None, dtype=None, stype=None, **kwargs):
    """Dense zeros; ``stype`` is accepted and not read, as in the JAX
    package (``nd.sparse.zeros`` makes a sparse array)."""
    ctx = as_context(ctx)
    return NDArray(ctx.place(torch.zeros(shape, dtype=torch_dtype(dtype),
                                       device=ctx.torch_device)), ctx)


def ones(shape, ctx=None, dtype=None):
    ctx = as_context(ctx)
    return NDArray(ctx.place(torch.ones(shape, dtype=torch_dtype(dtype),
                                       device=ctx.torch_device)), ctx)


def full(shape, val, ctx=None, dtype=None):
    ctx = as_context(ctx)
    return NDArray(ctx.place(torch.full(shape, val, dtype=torch_dtype(dtype),
                                        device=ctx.torch_device)), ctx)


def empty(shape, ctx=None, dtype=None):
    return zeros(shape, ctx, dtype)


def concatenate(arrays, axis=0, always_copy=True):
    """Join NDArrays along ``axis`` (the ``Concat`` op)."""
    return invoke(get_op("Concat"), list(arrays), {"dim": axis})[0]


def arange(start, stop=None, step=1.0, repeat=1, ctx=None, dtype=None,
           infer_range=False):
    """``[start, stop)`` by ``step``, each value ``repeat`` times."""
    return invoke(get_op("_arange"), [],
                  {"start": start, "stop": stop, "step": step,
                   "repeat": repeat, "dtype": dtype or "float32",
                   "ctx": ctx})[0]


def eye(N, M=0, k=0, ctx=None, dtype=None):
    """An N x M (M 0: N) array with ones on the k-th diagonal."""
    return invoke(get_op("_eye"), [],
                  {"N": N, "M": M, "k": k, "dtype": dtype or "float32",
                   "ctx": ctx})[0]


def moveaxis(tensor, source, destination):
    """``tensor`` with axis ``source`` moved to ``destination``."""
    axes = list(range(tensor.ndim))
    axes.remove(source % tensor.ndim)
    axes.insert(destination % tensor.ndim, source % tensor.ndim)
    return tensor.transpose(axes)


def onehot_encode(indices, out):
    """One-hot rows of ``indices`` written into ``out`` (its second axis
    is the depth)."""
    return invoke(get_op("one_hot"), [indices], {"depth": out.shape[1]},
                  out=out)[0]


def waitall():
    """Block until all work queued on the card has run."""
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


def params_from_jax(np_params, executor):
    """The JAX package's ``{name: np.ndarray}`` (``exe.arg_dict[n].asnumpy()``)
    as NDArrays on ``executor``'s context, after checking each name,
    shape and dtype against ``executor.arg_dict``.  Copy them in with
    ``executor.copy_params_from``.  A value may also be the JAX package's
    NDArray itself: its storage tag is kept, and a CSR keeps its parts
    (``sparse.from_reference``)."""
    from .sparse import from_reference
    out = {}
    for name, value in np_params.items():
        if name not in executor.arg_dict:
            raise MXNetError("params_from_jax: %r is not an argument of the "
                             "executor (%s)" % (name, executor.arg_names))
        dst = executor.arg_dict[name]
        if hasattr(value, "asnumpy"):
            arr = from_reference(value, executor._ctx)
        else:
            value = np.asarray(value)
            arr = array(value, ctx=executor._ctx, dtype=value.dtype)
        if arr.shape != dst.shape:
            raise MXNetError("params_from_jax: %s has shape %s, the executor "
                             "wants %s" % (name, arr.shape, dst.shape))
        if arr.dtype != dst.dtype:
            raise MXNetError("params_from_jax: %s has dtype %s, the executor "
                             "wants %s" % (name, arr.dtype, dst.dtype))
        out[name] = arr
    return out
