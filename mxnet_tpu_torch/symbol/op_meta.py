"""Per-op metadata for symbolic composition.

Counterpart of ``mxnet_tpu/symbol/op_meta.py:22-176``, for the ops this
package registers (input and aux names ``:41-51``, parameter shapes
``:112``, ``:133``).  Forward shapes come from running each op on ``meta``
tensors; this module supplies what that cannot derive: (1) canonical
input/aux names, so ``sym.FullyConnected(data=d, ...)`` creates
``fc1_weight``/``fc1_bias`` variables, and (2) data -> parameter shape
inference, so ``simple_bind`` allocates parameters from the data shape.
"""
from __future__ import annotations

import math

import torch

__all__ = ["op_input_names", "infer_param_shapes", "HINTS"]

# name hints for auto-naming (reference: lowercase op name)
HINTS = {
    "FullyConnected": "fullyconnected", "Convolution": "convolution",
    "BatchNorm": "batchnorm", "Pooling": "pooling",
    "Activation": "activation",
    "SoftmaxOutput": "softmaxoutput", "Flatten": "flatten",
    "Reshape": "reshape", "elemwise_add": "_plus", "elemwise_sub": "_minus",
    "elemwise_mul": "_mul", "elemwise_div": "_div",
}


def op_input_names(op, attrs):
    """Return (input_names, aux_names); aux_names are the trailing inputs."""
    name = op.name
    if name in ("Convolution", "Convolution_v1"):
        return (["data", "weight"] if attrs.get("no_bias", False)
                else ["data", "weight", "bias"]), []
    if name in ("BatchNorm", "BatchNorm_v1", "CuDNNBatchNorm"):
        return ["data", "gamma", "beta"], ["moving_mean", "moving_var"]
    if name in ("add_n", "ElementWiseSum", "elemwise_sum", "Concat"):
        return ["arg%d" % i for i in range(int(attrs.get("num_args") or 1))], []
    if name == "FullyConnected":
        return (["data", "weight"] if attrs.get("no_bias", False)
                else ["data", "weight", "bias"]), []
    if name in ("SoftmaxOutput", "Softmax"):
        return ["data", "label"], []
    if name.startswith(("elemwise_", "broadcast_")) or name in (
            "_plus", "_minus", "_mul", "_div", "_maximum", "_minimum",
            "_power", "_mod"):
        return ["lhs", "rhs"], []
    return ["data"], []


def infer_param_shapes(node, in_structs):
    """Given a node whose data input (a ``meta`` tensor) is known, infer
    the missing parameter inputs.  Returns a list aligned to the inputs
    (``None`` where unknown), or ``None``."""
    name, a = node.op.name, node.attrs
    if not in_structs or in_structs[0] is None:
        return None
    data = in_structs[0]
    dshape = tuple(data.shape)

    def meta(shape):
        return torch.empty(shape, dtype=data.dtype, device="meta")

    out = [None] * len(in_structs)
    if name in ("Convolution", "Convolution_v1"):
        kernel = tuple(a.get("kernel", ()))
        g = int(a.get("num_group", 1))
        nf = int(a.get("num_filter", 1))
        out[1] = meta((nf, dshape[1] // g) + kernel)
        if len(in_structs) > 2:
            out[2] = meta((nf,))
    elif name in ("BatchNorm", "BatchNorm_v1", "CuDNNBatchNorm"):
        c = dshape[int(a.get("axis", 1)) % len(dshape)]
        for i in range(1, len(in_structs)):
            out[i] = meta((c,))
    elif name == "FullyConnected":
        nh = int(a.get("num_hidden", 1))
        in_dim = math.prod(dshape[1:]) if a.get("flatten", True) \
            else dshape[-1]
        out[1] = meta((nh, in_dim))
        if len(in_structs) > 2:
            out[2] = meta((nh,))
    elif name in ("SoftmaxOutput", "Softmax"):
        if a.get("multi_output", False):
            out[1] = meta((dshape[0],) + dshape[2:])
        else:
            out[1] = meta((dshape[0],))
    else:
        return None
    return out
