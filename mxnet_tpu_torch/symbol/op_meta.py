"""Per-op metadata for symbolic composition.

Counterpart of ``mxnet_tpu/symbol/op_meta.py:22-176``, with MXNet's input
names for the long tail's ops (the JAX package names their first input
only) and ``Custom``'s from its prop.  Forward shapes come from running
each op on
``meta`` tensors; this module supplies what that cannot derive: (1)
canonical input/aux names, so ``sym.FullyConnected(data=d, ...)``
creates ``fc1_weight``/``fc1_bias`` variables, and (2) data -> parameter
shape inference, so ``simple_bind`` allocates parameters from the data
shape.
"""
from __future__ import annotations

import math

import torch

__all__ = ["op_input_names", "infer_param_shapes", "HINTS"]

# name hints for auto-naming (reference: lowercase op name)
HINTS = {
    "FullyConnected": "fullyconnected", "Convolution": "convolution",
    "Deconvolution": "deconvolution", "BatchNorm": "batchnorm",
    "Pooling": "pooling", "Activation": "activation", "Dropout": "dropout",
    "SoftmaxOutput": "softmaxoutput", "Embedding": "embedding", "RNN": "rnn",
    "Concat": "concat", "Flatten": "flatten", "Reshape": "reshape",
    "LeakyReLU": "leakyrelu", "elemwise_add": "_plus",
    "elemwise_sub": "_minus", "elemwise_mul": "_mul", "elemwise_div": "_div",
}

_LABELLED = ("SoftmaxOutput", "Softmax", "LinearRegressionOutput",
             "LogisticRegressionOutput", "MAERegressionOutput", "SVMOutput",
             "softmax_cross_entropy")


# the inputs of the long tail's ops, by name (MXNet's)
_NAMED = {
    "ROIPooling": ("data", "rois"), "SpatialTransformer": ("data", "loc"),
    "BilinearSampler": ("data", "grid"), "Correlation": ("data1", "data2"),
    "_contrib_MultiBoxTarget": ("anchor", "label", "cls_pred"),
    "_contrib_MultiBoxDetection": ("cls_prob", "loc_pred", "anchor"),
    "_contrib_Proposal": ("cls_prob", "bbox_pred", "im_info"),
    "_contrib_MultiProposal": ("cls_prob", "bbox_pred", "im_info"),
    "_contrib_PSROIPooling": ("data", "rois"),
    "_contrib_quantize": ("data", "min_range", "max_range"),
    "_contrib_dequantize": ("data", "min_range", "max_range"),
    "_contrib_count_sketch": ("data", "h", "s"),
}
for _op in ("gemm2", "trsm", "trmm"):
    _NAMED["_linalg_" + _op] = _NAMED["linalg_" + _op] = ("A", "B")
for _op in ("potrf", "potri", "sumlogdiag", "syrk", "syevd", "gelqf"):
    _NAMED["_linalg_" + _op] = _NAMED["linalg_" + _op] = ("A",)
_NAMED["_linalg_gemm"] = _NAMED["linalg_gemm"] = ("A", "B", "C")


def op_input_names(op, attrs):
    """Return (input_names, aux_names); aux_names are the trailing inputs."""
    name, a = op.name, attrs
    if name in ("Convolution", "Convolution_v1", "Deconvolution"):
        base = ["data", "weight"]
        # MXNet's defaults: Convolution no_bias=False, Deconvolution True
        if not a.get("no_bias", name == "Deconvolution"):
            base.append("bias")
        return base, []
    if name == "FullyConnected":
        return (["data", "weight"] if a.get("no_bias", False)
                else ["data", "weight", "bias"]), []
    if name in ("BatchNorm", "BatchNorm_v1", "CuDNNBatchNorm"):
        return ["data", "gamma", "beta"], ["moving_mean", "moving_var"]
    if name in ("InstanceNorm", "LayerNorm"):
        return ["data", "gamma", "beta"], []
    if name == "Embedding":
        return ["data", "weight"], []
    if name == "RNN":
        ins = ["data", "parameters", "state"]
        if a.get("mode", "lstm") == "lstm":
            ins.append("state_cell")
        return ins, []
    if name == "LeakyReLU":
        if a.get("act_type", "leaky") == "prelu":
            return ["data", "gamma"], []
        return ["data"], []
    if name in _LABELLED:
        return ["data", "label"], []
    if name in ("dot", "batch_dot") or name.startswith(
            ("elemwise_", "broadcast_")) or name in (
                "_plus", "_minus", "_mul", "_div", "_grad_add", "_maximum",
                "_minimum", "_power", "_mod", "_hypot"):
        return ["lhs", "rhs"], []
    if name in ("Concat", "add_n", "stack", "elemwise_sum", "ElementWiseSum",
                "UpSampling"):
        return ["arg%d" % i for i in range(int(a.get("num_args") or 1))], []
    if name == "where":
        return ["condition", "x", "y"], []
    if name in ("take", "batch_take", "gather_nd", "scatter_nd"):
        return ["a", "indices"], []
    if name in ("SequenceMask", "SequenceLast", "SequenceReverse"):
        if a.get("use_sequence_length", False):
            return ["data", "sequence_length"], []
        return ["data"], []
    if name == "Crop":
        n = int(a.get("num_args", 1))
        return ["data"] + (["crop_like"] if n > 1 else []), []
    if name in _NAMED:
        return list(_NAMED[name]), []
    if name == "_contrib_DeformableConvolution":
        return (["data", "offset", "weight"]
                + ([] if a.get("no_bias", False) else ["bias"])), []
    if name == "_contrib_DeformablePSROIPooling":
        return ["data", "rois"] + ([] if a.get("no_trans", False)
                                   else ["trans"]), []
    if name in ("_contrib_CTCLoss", "CTCLoss", "ctc_loss"):
        return (["data", "label"]
                + (["data_lengths"] if a.get("use_data_lengths") else [])
                + (["label_lengths"] if a.get("use_label_lengths") else [])), []
    if name == "Custom":
        from ..ops.custom import instantiate
        prop = instantiate(a)
        return (list(prop.list_arguments()),
                list(prop.list_auxiliary_states()))
    if getattr(op, "no_inputs", False):
        return [], []
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
        return torch.empty(tuple(shape), dtype=data.dtype, device="meta")

    out = [None] * len(in_structs)
    if name in ("Convolution", "Convolution_v1"):
        kernel = tuple(a.get("kernel", ()))
        g = int(a.get("num_group", 1))
        nf = int(a.get("num_filter", 1))
        out[1] = meta((nf, dshape[1] // g) + kernel)
        if len(in_structs) > 2:
            out[2] = meta((nf,))
    elif name == "Deconvolution":
        kernel = tuple(a.get("kernel", ()))
        g = int(a.get("num_group", 1))
        nf = int(a.get("num_filter", 1))
        out[1] = meta((dshape[1], nf // g) + kernel)
        if len(in_structs) > 2:
            out[2] = meta((nf,))
    elif name in ("BatchNorm", "BatchNorm_v1", "CuDNNBatchNorm"):
        c = dshape[int(a.get("axis", 1)) % len(dshape)]
        for i in range(1, len(in_structs)):
            out[i] = meta((c,))
    elif name == "InstanceNorm":
        out[1] = out[2] = meta((dshape[1],))
    elif name == "LayerNorm":
        c = dshape[int(a.get("axis", -1)) % len(dshape)]
        out[1] = out[2] = meta((c,))
    elif name == "Embedding":
        out[1] = meta((int(a.get("input_dim")), int(a.get("output_dim"))))
    elif name == "LeakyReLU" and a.get("act_type") == "prelu":
        out[1] = meta((dshape[1],))
    elif name == "RNN":
        from ..ops.nn import rnn_param_size
        h, layers = int(a.get("state_size")), int(a.get("num_layers", 1))
        bi = bool(a.get("bidirectional", False))
        out[1] = meta((rnn_param_size(layers, dshape[2], h,
                                      a.get("mode", "lstm"), bi),))
        for i in range(2, len(in_structs)):
            out[i] = meta((layers * (2 if bi else 1), dshape[1], h))
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
    elif name in ("LinearRegressionOutput", "LogisticRegressionOutput",
                  "MAERegressionOutput"):
        out[1] = meta(dshape)
    elif name in ("SVMOutput", "softmax_cross_entropy"):
        out[1] = meta((dshape[0],))
    elif name == "_contrib_DeformableConvolution":
        kernel = tuple(a.get("kernel", (3, 3)))
        g = int(a.get("num_group", 1))
        nf = int(a.get("num_filter", 1))
        out[2] = meta((nf, dshape[1] // g) + kernel)
        if len(in_structs) > 3:
            out[3] = meta((nf,))
    else:
        return None
    return out
