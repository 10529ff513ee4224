"""User-kernel registration: counterpart of ``mxnet_tpu/pallas.py:54-162``.

MXNet's RTC (``python/mxnet/rtc.py``) lets a user hand the runtime a
kernel and call it on NDArrays.  Here the user hands :func:`register` a
function that launches a kernel (CUDA C++ built and bound by hand, as
``ops/scale.py`` does), and it becomes an operator usable like a
built-in from ``nd.<name>``, ``sym.<name>`` and bound executors:

    import mxnet_tpu_torch as mt
    from mxnet_tpu_torch.ops.scale import scale, scale_reference

    @mt.rtc.register("my_scale", grad=lambda og, ins, outs, attrs:
                     (og[0] * float(attrs.get("alpha", 1.0)),))
    def my_scale(x, alpha=2.0, interpret=False):
        return scale_reference(x, alpha) if interpret else scale(x, alpha)

    y = mt.nd.my_scale(mt.nd.ones((4, 4)), alpha=3.0)     # eager
    s = mt.sym.my_scale(mt.sym.Variable("d"), alpha=3.0)  # symbolic

``interpret`` keeps its name and role: a function that takes it has a
plain PyTorch body beside its kernel.  The registry fills it from the
inputs' device: ``False`` for CUDA tensors (launch the kernel), ``True``
for CPU tensors and for the ``meta`` tensors of shape inference (the
plain body).  A caller may pin it; pinning ``False`` on tensors that are
not on a card raises.  A function without ``interpret`` has no plain
body, so shape inference on it raises rather than hand its kernel a
tensor with no memory behind it.

Gradients: a pure-PyTorch body differentiates through torch's autograd;
a kernel launched by hand returns a tensor outside autograd, so such a
kernel passes ``grad=`` (a semantic backward
``bwd(out_grads, inputs, outputs, attrs) -> input_grads``).  Recording a
call that would silently lose its gradient raises instead.
"""
from __future__ import annotations

import inspect
import sys

import torch

from .base import MXNetError
from .ops.registry import OP_REGISTRY, Op

__all__ = ["register", "unregister", "registered_kernels"]

_USER_KERNELS = []
_SHADOWED = {}  # name -> Op it force-replaced, restored on unregister()


def _tensors(arrays):
    return [a for a in arrays if isinstance(a, torch.Tensor)]


def _on_card(arrays):
    return any(t.device.type == "cuda" for t in _tensors(arrays))


def _expose(name, op):
    """Install the nd/sym wrappers of a newly registered op (the import-
    time generation in ``ndarray/__init__`` and ``symbol/__init__`` has
    already run when a user registers a kernel)."""
    from . import ndarray as nd_mod
    from . import symbol as sym_mod
    from .ndarray import _make_op_func
    from .symbol import _make_sym_func

    nd_fn = _make_op_func(name, op)
    sym_fn = _make_sym_func(name, op)
    setattr(sys.modules[nd_mod.__name__ + "._internal"], name, nd_fn)
    setattr(sys.modules[sym_mod.__name__ + "._internal"], name, sym_fn)
    if not name.startswith("_"):
        setattr(nd_mod, name, nd_fn)
        setattr(sym_mod, name, sym_fn)
    return nd_fn


def _check_recorded(name, arrays, outs):
    """A call under grad mode whose inputs need a gradient must give
    outputs in autograd's graph; a hand-launched kernel's do not."""
    if not (torch.is_grad_enabled()
            and any(t.requires_grad for t in _tensors(arrays))):
        return
    outs = outs if isinstance(outs, (tuple, list)) else (outs,)
    if any(o.is_floating_point() and not o.requires_grad for o in outs):
        raise MXNetError(
            "kernel %r returned a tensor outside autograd, so its gradient "
            "would be lost; register it with grad=bwd(out_grads, inputs, "
            "outputs, attrs)" % name)


def register(name, fn=None, *, grad=None, num_outputs=1, takes_mode=False,
             needs_rng=False, interpret=None, force=False):
    """Register ``fn`` as operator ``name``, usable from nd, sym and bound
    executors.

    Parameters
    ----------
    fn : ``(*tensors, **attrs) -> tensor | tuple``, typically launching a
        hand-written kernel.  If it accepts an ``interpret`` keyword, the
        registry fills it from the inputs' device unless the call site
        pins it.
    grad : optional semantic backward
        ``bwd(out_grads, inputs, outputs, attrs) -> input_grads`` (one per
        input).  Without it, gradients flow through torch's autograd:
        fine for a pure-PyTorch body, unavailable for a kernel launched
        by hand.
    interpret : pin the plain body on (True) or off (False) for every
        call; default: chosen by the inputs' device at call time.
    force : allow replacing an existing registration.

    Returns the eager ``nd.<name>`` function (decorator-friendly).
    """
    if fn is None:  # decorator form
        def deco(f):
            return register(name, f, grad=grad, num_outputs=num_outputs,
                            takes_mode=takes_mode, needs_rng=needs_rng,
                            interpret=interpret, force=force)
        return deco
    if name in OP_REGISTRY:
        if not force:
            raise MXNetError(
                "operator %r already registered (pass force=True to replace)"
                % name)
        if name not in _SHADOWED and name not in _USER_KERNELS:
            # force=True over a built-in: keep it, so that unregister()
            # restores the core operator instead of deleting it
            _SHADOWED[name] = OP_REGISTRY[name]

    accepts_interpret = "interpret" in inspect.signature(fn).parameters

    def body(*arrays, **attrs):
        if accepts_interpret:
            mode = attrs.get("interpret")
            if mode is None:
                mode = interpret
            if mode is None:
                mode = not _on_card(arrays)
            elif not mode and not _on_card(arrays):
                raise MXNetError(
                    "kernel %r: interpret=False launches the kernel, which "
                    "needs CUDA tensors; its inputs are on %s" % (
                        name, sorted({str(t.device)
                                      for t in _tensors(arrays)})))
            attrs["interpret"] = bool(mode)
        elif any(t.device.type == "meta" for t in _tensors(arrays)):
            raise MXNetError(
                "kernel %r has no plain body (its function takes no "
                "'interpret' keyword), so its output shape cannot be "
                "inferred; give it one to use it in a symbol" % name)
        outs = fn(*arrays, **attrs)
        if grad is None:
            _check_recorded(name, arrays, outs)
        return outs
    body.__name__ = getattr(fn, "__name__", name)
    body.__doc__ = fn.__doc__

    op = Op(name, body, num_outputs=num_outputs, takes_mode=takes_mode,
            needs_rng=needs_rng, custom_vjp=grad,
            attr_defaults={"interpret": None} if accepts_interpret else None)
    OP_REGISTRY[name] = op
    if name not in _USER_KERNELS:
        _USER_KERNELS.append(name)
    return _expose(name, op)


def unregister(name):
    """Remove a user-registered kernel and its nd/sym wrappers (built-ins
    are protected; a built-in it replaced comes back)."""
    from . import ndarray as nd_mod
    from . import symbol as sym_mod
    if name not in _USER_KERNELS:
        raise MXNetError("%r is not a user-registered kernel" % name)
    _USER_KERNELS.remove(name)
    OP_REGISTRY.pop(name, None)
    for mod in (nd_mod, sym_mod,
                sys.modules.get(nd_mod.__name__ + "._internal"),
                sys.modules.get(sym_mod.__name__ + "._internal")):
        if mod is not None and hasattr(mod, name):
            delattr(mod, name)
    shadowed = _SHADOWED.pop(name, None)
    if shadowed is not None:
        OP_REGISTRY[name] = shadowed
        _expose(name, shadowed)


def registered_kernels():
    """Names of live user-registered kernels."""
    return list(_USER_KERNELS)
