"""Neural-network layer ops.

Counterpart of ``mxnet_tpu/ops/nn.py``: ``FullyConnected``:39,
``Convolution``:56, ``Deconvolution``:79, ``Pooling``:106,
``UpSampling``:153, ``BatchNorm``:174, ``InstanceNorm``,
``LayerNorm``, ``L2Normalization`` and ``LRN`` (:200-240),
``Activation``:243, ``LeakyReLU``:258, ``SoftmaxActivation`` and
``Dropout`` (:284-302), ``SoftmaxOutput``:363 with its semantic backward
``_softmax_output_bwd``:314, the regression and SVM heads,
``softmax_cross_entropy`` and ``MakeLoss`` (:377-448), the sequence ops
(:450-500), ``Crop``:666, the fused ``RNN`` (:491-607) and the spatial ops
``GridGenerator``:611, ``BilinearSampler``:653,
``SpatialTransformer``:658, ``ROIPooling``:682 and ``Correlation``:722
(the sampler is the JAX package's gather, the corners at -1 and 1 and
zeros outside, not ``F.grid_sample``).

The JAX package leaves these products and windows to XLA, outside any
Pallas kernel, so here they are ``torch.matmul`` and
``torch.nn.functional``'s convolutions and pools (cuBLAS and cuDNN on
the card).  Layout is MXNet's: NCHW data, OIHW weights; a
``Deconvolution`` weight is (C, F/g, *k), which is torch's
``conv_transpose`` layout, with ``adj`` as its ``output_padding``
(``target_shape`` and ``dilate`` are accepted and, as in the JAX
package, not used).  ``BatchNorm``, ``InstanceNorm`` and ``LayerNorm``
are the JAX formulas written in torch ops (the biased variance,
``(x - mean) * rsqrt(var + eps)``), not ``F.batch_norm`` or
``F.layer_norm``: MXNet's momentum weighs the old statistic.  The loss
heads keep MXNet's semantic gradients (``SoftmaxOutput``: ``(softmax -
onehot) * grad_scale / norm`` whatever the head gradient is, zeros for
the label).  ``Dropout`` and ``LeakyReLU(act_type="rrelu")`` draw from
the generator the caller passes (``needs_rng``): the mask is drawn as
uniforms below the keep probability, cast to the data's dtype and
divided by the keep probability in that dtype, then multiplied, as the
JAX package orders it.

``RNN`` runs torch's own recurrent functions (``torch._VF.lstm``,
``gru``, ``rnn_tanh``, ``rnn_relu``; cuDNN's RNN on the card) over views
into the packed parameter vector (per layer, per direction: ``i2h_W``,
``h2h_W``, ``i2h_b``, ``h2h_b``; gates i,f,g,o and r,z,n), which is
torch's weight list in its order.  cuDNN's own buffer puts every
layer's matrices before all the biases, so on the card torch copies the
weights into one at each call (the size of the weights; measured on the
H100 in ``chip_smoke.cudnn_layout_check``).  With ``p > 0`` in training
it runs one layer a call and draws the ``Dropout`` mask between layers
from the op's generator, as ``Dropout`` does; torch's dropout state is
never used.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..base import MXNetError
from .elemwise import _make_loss_bwd, _max0
from .registry import register


@register("FullyConnected")
def _fully_connected(data, weight, *maybe_bias, num_hidden=None, no_bias=False,
                     flatten=True, **kw):
    x = data.reshape((data.shape[0], -1)) if flatten else data
    out = torch.matmul(x, weight.t())
    if not no_bias and maybe_bias:
        out = out + maybe_bias[0]
    return out


def _tup(v, n):
    if isinstance(v, int):
        return (v,) * n
    return tuple(v)


_CONV = {1: F.conv1d, 2: F.conv2d, 3: F.conv3d}


@register("Convolution", aliases=["Convolution_v1"])
def _convolution(data, weight, *maybe_bias, kernel=(), stride=(), dilate=(),
                 pad=(), num_filter=1, num_group=1, no_bias=False, **kw):
    nd = len(kernel)
    bias = maybe_bias[0] if maybe_bias and not no_bias else None
    return _CONV[nd](data, weight, bias, _tup(stride or 1, nd),
                     _tup(pad or 0, nd), _tup(dilate or 1, nd),
                     int(num_group))


_DECONV = {1: F.conv_transpose1d, 2: F.conv_transpose2d,
           3: F.conv_transpose3d}


@register("Deconvolution")
def _deconvolution(data, weight, *maybe_bias, kernel=(), stride=(),
                   dilate=(), pad=(), adj=(), target_shape=(), num_filter=1,
                   num_group=1, no_bias=True, **kw):
    nd = len(kernel)
    bias = maybe_bias[0] if maybe_bias and not no_bias else None
    return _DECONV[nd](data, weight, bias, _tup(stride or 1, nd),
                       _tup(pad or 0, nd), _tup(adj or 0, nd),
                       int(num_group))


def _avg_pool1d(x, kernel, stride, pad, count_include_pad=True,
                divisor_override=None):
    """``avg_pool1d`` with ``divisor_override``, which torch's lacks: the
    2-D pool over a trailing axis of one."""
    return F.avg_pool2d(x.unsqueeze(-1), kernel + (1,), stride + (1,),
                        pad + (0,), count_include_pad=count_include_pad,
                        divisor_override=divisor_override).squeeze(-1)


_MAX_POOL = {1: F.max_pool1d, 2: F.max_pool2d, 3: F.max_pool3d}
_AVG_POOL = {1: _avg_pool1d, 2: F.avg_pool2d, 3: F.avg_pool3d}


def _window_sum(x, kernel, stride):
    """Sum over each window of an already padded ``x`` (no padding)."""
    return _AVG_POOL[len(kernel)](x, kernel, stride, (0,) * len(kernel),
                                  divisor_override=1)


@register("Pooling", aliases=["Pooling_v1"])
def _pooling(data, kernel=(), pool_type="max", global_pool=False, stride=(),
             pad=(), pooling_convention="valid", count_include_pad=True,
             p_value=2, **kw):
    nd = data.ndim - 2
    if global_pool:
        kernel, stride, pad = tuple(data.shape[2:]), (1,) * nd, (0,) * nd
    kernel = _tup(kernel, nd)
    stride = _tup(stride or 1, nd)
    pad = _tup(pad or 0, nd)
    if pool_type not in ("max", "avg", "sum", "lp"):
        raise ValueError("unknown pool_type %s" % pool_type)
    extra = [0] * nd
    if pooling_convention == "full":
        # the JAX package's ceil mode (ops/nn.py:120-133): pad the high
        # side so that the last partial window counts.  torch's ceil_mode
        # drops a window that would start in the right padding, so the
        # padding is made here and the pool itself runs unpadded
        for i in range(nd):
            size = data.shape[2 + i]
            out = math.ceil((size + 2 * pad[i] - kernel[i]) / stride[i]) + 1
            extra[i] = max(0, (out - 1) * stride[i] + kernel[i] - size
                           - 2 * pad[i])
    if pool_type != "lp" and not any(extra) \
            and all(2 * p <= k for p, k in zip(pad, kernel)):
        # torch pads these itself, as the JAX package does: -inf for max,
        # zeros counted (count_include_pad) or not for avg and sum
        if pool_type == "max":
            return _MAX_POOL[nd](data, kernel, stride, pad)
        return _AVG_POOL[nd](
            data, kernel, stride, pad,
            count_include_pad=bool(count_include_pad),
            divisor_override=1 if pool_type == "sum" else None)
    # F.pad takes (low, high) pairs from the last axis back
    widths = [w for i in reversed(range(nd))
              for w in (pad[i], pad[i] + extra[i])]
    if pool_type == "max":
        fill = -math.inf if data.is_floating_point() \
            else torch.iinfo(data.dtype).min
        return _MAX_POOL[nd](F.pad(data, widths, value=fill), kernel, stride)
    if pool_type == "lp":
        # (sum |x|^p)^(1/p) over each window, the padding counting zeros
        p = float(p_value)
        total = _window_sum(F.pad(data.abs() ** p, widths), kernel, stride)
        return total ** (1.0 / p)
    total = _window_sum(F.pad(data, widths), kernel, stride)
    if pool_type == "sum":
        return total
    if count_include_pad:
        return total / float(math.prod(kernel))
    ones = torch.ones((1, 1) + tuple(data.shape[2:]), dtype=data.dtype,
                      device=data.device)
    return total / _window_sum(F.pad(ones, widths), kernel, stride)


@register("BatchNorm", aliases=["BatchNorm_v1", "CuDNNBatchNorm"],
          num_outputs=3, num_visible_outputs=1, nondiff_inputs=(3, 4),
          aux_updates={3: 1, 4: 2}, takes_mode=True)
def _batch_norm(data, gamma, beta, moving_mean, moving_var, eps=1e-3,
                momentum=0.9, fix_gamma=True, use_global_stats=False,
                axis=1, train_mode=False, **kw):
    ax = axis % data.ndim
    red = tuple(i for i in range(data.ndim) if i != ax)
    shape = [1] * data.ndim
    shape[ax] = data.shape[ax]
    # fix_gamma: the op scales by ones, so gamma's gradient is zero
    g = torch.ones_like(gamma) if fix_gamma else gamma
    if train_mode and not use_global_stats:
        # the biased variance, as jnp.var; MXNet's momentum weighs the old
        # statistic (torch's F.batch_norm means the opposite by momentum)
        mean = data.mean(dim=red)
        var = data.var(dim=red, unbiased=False)
        new_mm = moving_mean * momentum + mean.detach() * (1 - momentum)
        new_mv = moving_var * momentum + var.detach() * (1 - momentum)
    else:
        mean, var = moving_mean, moving_var
        new_mm, new_mv = moving_mean, moving_var
    inv = torch.rsqrt(var + eps)
    out = (data - mean.reshape(shape)) * inv.reshape(shape) \
        * g.reshape(shape) + beta.reshape(shape)
    return out, new_mm, new_mv


_ACT = {
    "relu": _max0,
    "sigmoid": torch.sigmoid,
    "tanh": torch.tanh,
    "softrelu": torch.nn.functional.softplus,
    "softsign": torch.nn.functional.softsign,
}


@register("Activation")
def _activation(data, act_type="relu", **kw):
    if act_type not in _ACT:
        raise ValueError("unknown act_type %s" % act_type)
    return _ACT[act_type](data)


def _softmax_fwd(data, multi_output=False, preserve_shape=False):
    if multi_output:
        return torch.softmax(data, dim=1)
    if preserve_shape:
        return torch.softmax(data, dim=-1)
    return torch.softmax(data.reshape(data.shape[0], -1),
                         dim=-1).reshape(data.shape)


def _one_hot(label, c, dtype):
    lab = label.to(torch.int64)
    # jax.nn.one_hot gives an all-zero row for a class outside [0, c)
    valid = (lab >= 0) & (lab < c)
    oh = torch.nn.functional.one_hot(torch.where(valid, lab, 0), c)
    return (oh * valid[..., None]).to(dtype)


def _softmax_output_bwd(out_grads, inputs, outputs, attrs):
    data, label = inputs[0], inputs[1]
    out = outputs[0]
    grad_scale = attrs.get("grad_scale", 1.0)
    ignore_label = attrs.get("ignore_label", -1.0)
    use_ignore = attrs.get("use_ignore", False)
    multi_output = attrs.get("multi_output", False)
    normalization = attrs.get("normalization", "null")
    smooth_alpha = attrs.get("smooth_alpha", 0.0)
    if not multi_output and label.ndim == data.ndim:  # one-hot/dense label
        grad = out - label
        norm = float(data.shape[0]) if normalization == "batch" else 1.0
        return (grad * (grad_scale / norm), torch.zeros_like(label))
    c = data.shape[1] if multi_output else data.shape[-1]
    lab = label.to(torch.int64)
    oh = _one_hot(label, c, data.dtype)
    if multi_output:  # data (N, C, ...), label (N, ...)
        oh = torch.movedim(oh, -1, 1)
    if smooth_alpha:
        oh = oh * (1 - smooth_alpha) + smooth_alpha / (c - 1) * (1 - oh)
    grad = out - oh
    valid = torch.ones(lab.shape, dtype=data.dtype, device=data.device)
    if use_ignore:
        valid = (lab != int(ignore_label)).to(data.dtype)
        grad = grad * (valid[:, None] if multi_output else valid[..., None])
    norm = 1.0
    if normalization == "valid":
        norm = torch.clamp_min(valid.sum(), 1.0)
    elif normalization == "batch":
        norm = float(data.shape[0])
    return (grad * (grad_scale / norm), torch.zeros_like(label))


@register("SoftmaxOutput", aliases=["Softmax"], nondiff_inputs=(1,),
          custom_vjp=_softmax_output_bwd)
def _softmax_output(data, label, grad_scale=1.0, ignore_label=-1.0,
                    multi_output=False, use_ignore=False, preserve_shape=False,
                    normalization="null", out_grad=False, smooth_alpha=0.0,
                    **kw):
    return _softmax_fwd(data, multi_output, preserve_shape)


@register("UpSampling")
def _upsampling(*args, scale=1, sample_type="nearest", num_filter=0,
                multi_input_mode="concat", num_args=1, **kw):
    s = int(scale)
    if sample_type == "nearest":
        outs = [a.repeat_interleave(s, dim=2).repeat_interleave(s, dim=3)
                for a in args]
        if len(outs) == 1:
            return outs[0]
        if multi_input_mode == "sum":
            out = outs[0]
            for o in outs[1:]:
                out = out + o
            return out
        return torch.cat(outs, dim=1)
    # bilinear: jax.image.resize's half-pixel sampling, which ignores the
    # weight input; for an upsampling its edge rows are the input's
    data = args[0]
    return F.interpolate(data, scale_factor=s, mode="bilinear",
                         align_corners=False)


def _normalize(data, red, eps):
    """``(x - mean) * rsqrt(var + eps)`` over ``red`` with the biased
    variance, as ``jnp.var``."""
    mean = torch.mean(data, dim=red, keepdim=True)
    var = torch.mean(torch.square(torch.abs(data - mean)), dim=red,
                     keepdim=True)
    return (data - mean) * torch.rsqrt(var + eps)


@register("InstanceNorm")
def _instance_norm(data, gamma, beta, eps=1e-3, **kw):
    shape = (1, -1) + (1,) * (data.ndim - 2)
    return _normalize(data, tuple(range(2, data.ndim)), eps) \
        * gamma.reshape(shape) + beta.reshape(shape)


@register("LayerNorm")
def _layer_norm(data, gamma, beta, axis=-1, eps=1e-5, output_mean_var=False,
                **kw):
    ax = axis % data.ndim
    shape = [1] * data.ndim
    shape[ax] = data.shape[ax]
    return _normalize(data, (ax,), eps) * gamma.reshape(shape) \
        + beta.reshape(shape)


@register("L2Normalization")
def _l2_normalization(data, eps=1e-10, mode="instance", **kw):
    if mode == "instance":
        red = tuple(range(1, data.ndim))
    elif mode == "channel":
        red = (1,)
    else:  # spatial
        red = tuple(range(2, data.ndim))
    return data / torch.sqrt(torch.sum(torch.square(data), dim=red,
                                       keepdim=True) + eps)


@register("LRN")
def _lrn(data, alpha=1e-4, beta=0.75, knorm=2.0, nsize=5, **kw):
    n = int(nsize)
    half = n // 2
    padded = F.pad(torch.square(data), (0, 0, 0, 0, half, half))
    windows = padded[:, 0:data.shape[1]]
    for i in range(1, n):
        windows = windows + padded[:, i:i + data.shape[1]]
    return data / torch.pow(knorm + (alpha / nsize) * windows, beta)


_SELU_SCALE, _SELU_ALPHA = 1.0507009873554805, 1.6732632423543772


def _need_rng(rng, what):
    """A draw in training has the caller's generator; without one the
    wiring is at fault, and an identity would hide it."""
    if rng is None:
        raise MXNetError("%s draws in training but was given no generator"
                         % what)


@register("LeakyReLU", needs_rng=True, takes_mode=True)
def _leaky_relu(data, *maybe_gamma, act_type="leaky", slope=0.25,
                lower_bound=0.125, upper_bound=0.334, rng=None,
                train_mode=False, **kw):
    if act_type == "leaky":
        return torch.where(data >= 0, data, slope * data)
    if act_type == "elu":
        return torch.where(data >= 0, data, slope * (torch.exp(data) - 1))
    if act_type == "selu":
        return _SELU_SCALE * F.elu(data, _SELU_ALPHA)
    if act_type == "prelu":
        gamma = maybe_gamma[0]
        shape = [1] * data.ndim
        if gamma.numel() > 1 and data.ndim > 1:
            shape[1] = gamma.numel()
        return torch.where(data >= 0, data, gamma.reshape(shape) * data)
    if act_type == "rrelu":
        lo, hi = float(lower_bound), float(upper_bound)
        if train_mode:
            _need_rng(rng, "LeakyReLU(act_type='rrelu')")
            r = torch.rand(data.shape, generator=rng, device=data.device,
                           dtype=data.dtype) * (hi - lo) + lo
            return torch.where(data >= 0, data, r * data)
        return torch.where(data >= 0, data, (lo + hi) / 2.0 * data)
    raise ValueError("unknown act_type %s" % act_type)


@register("SoftmaxActivation")
def _softmax_activation(data, mode="instance", **kw):
    if mode == "channel":
        return torch.softmax(data, dim=1)
    return torch.softmax(data.reshape(data.shape[0], -1),
                         dim=-1).reshape(data.shape)


@register("Dropout", needs_rng=True, takes_mode=True)
def _dropout(data, p=0.5, mode="training", axes=(), rng=None,
             train_mode=False, **kw):
    if (not train_mode and mode != "always") or p <= 0:
        return data
    _need_rng(rng, "Dropout")
    shape = list(data.shape)
    for a in axes or ():
        shape[a] = 1
    keep = 1.0 - p
    draw = torch.rand(shape, generator=rng, device=data.device)
    return data * ((draw < keep).to(data.dtype) / keep)


def _linreg_bwd(out_grads, inputs, outputs, attrs):
    data, label = inputs
    gs = attrs.get("grad_scale", 1.0)
    return ((outputs[0] - label.reshape(data.shape)) * gs,
            torch.zeros_like(label))


@register("LinearRegressionOutput", nondiff_inputs=(1,),
          custom_vjp=_linreg_bwd)
def _lin_reg_output(data, label, grad_scale=1.0, **kw):
    return data


def _maereg_bwd(out_grads, inputs, outputs, attrs):
    data, label = inputs
    gs = attrs.get("grad_scale", 1.0)
    return (torch.sign(data - label.reshape(data.shape)) * gs,
            torch.zeros_like(label))


@register("MAERegressionOutput", nondiff_inputs=(1,), custom_vjp=_maereg_bwd)
def _mae_reg_output(data, label, grad_scale=1.0, **kw):
    return data


@register("LogisticRegressionOutput", nondiff_inputs=(1,),
          custom_vjp=_linreg_bwd)
def _log_reg_output(data, label, grad_scale=1.0, **kw):
    return torch.sigmoid(data)


def _svm_bwd(out_grads, inputs, outputs, attrs):
    data, label = inputs
    margin = attrs.get("margin", 1.0)
    reg = attrs.get("regularization_coefficient", 1.0)
    c = data.shape[-1]
    lab = label.to(torch.int64)
    oh = _one_hot(label, c, data.dtype)
    score_y = torch.gather(data, -1, lab[..., None])
    dist = (margin - (score_y - data)) * (1 - oh)
    if attrs.get("use_linear", False):
        viol = (margin - (score_y - data) > 0).to(data.dtype) * (1 - oh)
        grad = reg * (viol - oh * torch.sum(viol, dim=-1, keepdim=True))
    else:
        grad = reg * 2 * _max0(dist)
        grad = grad - oh * torch.sum(grad, dim=-1, keepdim=True)
    return (grad, torch.zeros_like(label))


@register("SVMOutput", nondiff_inputs=(1,), custom_vjp=_svm_bwd)
def _svm_output(data, label, margin=1.0, regularization_coefficient=1.0,
                use_linear=False, **kw):
    return data


@register("softmax_cross_entropy", nondiff_inputs=(1,))
def _softmax_cross_entropy(data, label, **kw):
    logp = torch.log_softmax(data, dim=-1)
    lab = label.to(torch.int64)
    return -torch.sum(torch.gather(logp, -1, lab[..., None]))


@register("MakeLoss", custom_vjp=_make_loss_bwd)
def _make_loss_layer(data, grad_scale=1.0, valid_thresh=0.0,
                     normalization="null", **kw):
    if normalization == "batch":
        return data / data.shape[0]
    if normalization == "valid":
        valid = torch.sum((data > valid_thresh).to(data.dtype))
        return data / torch.clamp_min(valid, 1.0)
    return data.clone()


@register("SequenceMask")
def _sequence_mask(data, *maybe_len, use_sequence_length=False, value=0.0,
                   axis=0, **kw):
    if not use_sequence_length or not maybe_len:
        return data
    lens = maybe_len[0].to(torch.int64)
    pos = torch.arange(data.shape[axis], device=data.device)
    mask = pos[:, None] < lens[None, :] if axis == 0 \
        else pos[None, :] < lens[:, None]
    mask = mask.reshape(mask.shape + (1,) * (data.ndim - 2))
    return torch.where(mask, data, data.new_full((), value))


@register("SequenceLast", nondiff_inputs=(1,))
def _sequence_last(data, *maybe_len, use_sequence_length=False, axis=0,
                   **kw):
    if not use_sequence_length or not maybe_len:
        return torch.select(data, axis, data.shape[axis] - 1)
    last = maybe_len[0].to(torch.int64) - 1
    if axis == 0:
        return data[last, torch.arange(data.shape[1], device=data.device)]
    return data[torch.arange(data.shape[0], device=data.device), last]


@register("SequenceReverse")
def _sequence_reverse(data, *maybe_len, use_sequence_length=False, axis=0,
                      **kw):
    if not use_sequence_length or not maybe_len:
        return torch.flip(data, (0,))
    lens = maybe_len[0].to(torch.int64)
    pos = torch.arange(data.shape[0], device=data.device)[:, None]
    rev = lens[None, :] - 1 - pos
    idx = torch.where(rev >= 0, rev, pos)
    idx = idx.reshape(idx.shape + (1,) * (data.ndim - 2)).expand(data.shape)
    return torch.gather(data, 0, idx)


@register("Crop", nondiff_inputs=(1,))
def _crop_op(*args, offset=(0, 0), h_w=(0, 0), center_crop=False,
             num_args=1, **kw):
    data = args[0]
    if len(args) > 1:
        th, tw = args[1].shape[2], args[1].shape[3]
    else:
        th, tw = int(h_w[0]), int(h_w[1])
    if center_crop:
        oy = (data.shape[2] - th) // 2
        ox = (data.shape[3] - tw) // 2
    else:
        oy, ox = int(offset[0]), int(offset[1])
    return data[:, :, oy:oy + th, ox:ox + tw]


# --- Spatial and geometry ops ---------------------------------------------------
@register("GridGenerator")
def _grid_generator(data, transform_type="affine", target_shape=(0, 0), **kw):
    """Affine: theta (N, 6) -> the sampling grid (N, 2, H, W) of (x, y) in
    [-1, 1]; "warp": the flow field itself."""
    h, w = int(target_shape[0]), int(target_shape[1])
    if transform_type != "affine":
        return data
    n = data.shape[0]
    theta = data.reshape(n, 2, 3)
    f64 = torch.float64
    ys = torch.linspace(-1, 1, h, dtype=f64, device=data.device)
    xs = torch.linspace(-1, 1, w, dtype=f64, device=data.device)
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    grid = torch.stack([gx, gy, torch.ones_like(gx)]).reshape(3, -1)
    return torch.matmul(theta, grid.to(data.dtype)).reshape(n, 2, h, w)


def _bilinear_sample(data, grid):
    """data (N, C, H, W) at grid (N, 2, Ho, Wo) of (x, y) in [-1, 1], the
    corners at -1 and 1; a neighbour outside the image counts as 0."""
    n, c, h, w = data.shape
    gx = (grid[:, 0] + 1) * (w - 1) / 2
    gy = (grid[:, 1] + 1) * (h - 1) / 2
    x0, y0 = gx.floor(), gy.floor()
    x1, y1 = x0 + 1, y0 + 1
    wx1, wy1 = gx - x0, gy - y0
    wx0, wy0 = 1 - wx1, 1 - wy1
    batch = torch.arange(n, device=data.device).reshape(n, 1, 1)

    def gather(yy, xx):
        yi = yy.clamp(0, h - 1).long()
        xi = xx.clamp(0, w - 1).long()
        valid = (yy >= 0) & (yy <= h - 1) & (xx >= 0) & (xx <= w - 1)
        vals = data[batch, :, yi, xi].permute(0, 3, 1, 2)  # (N, C, Ho, Wo)
        return vals * valid[:, None].to(data.dtype)

    return (gather(y0, x0) * (wy0 * wx0)[:, None]
            + gather(y0, x1) * (wy0 * wx1)[:, None]
            + gather(y1, x0) * (wy1 * wx0)[:, None]
            + gather(y1, x1) * (wy1 * wx1)[:, None])


@register("BilinearSampler")
def _bilinear_sampler(data, grid, cudnn_off=False, **kw):
    return _bilinear_sample(data, grid)


@register("SpatialTransformer")
def _spatial_transformer(data, loc, target_shape=(0, 0),
                         transform_type="affine", sampler_type="bilinear",
                         cudnn_off=False, **kw):
    return _bilinear_sample(data, _grid_generator(loc, transform_type,
                                                  target_shape))


@register("ROIPooling", nondiff_inputs=(1,))
def _roi_pooling(data, rois, pooled_size=(1, 1), spatial_scale=1.0, **kw):
    """ROI max pooling: data (N, C, H, W), rois (R, 5) [batch, x0, y0, x1,
    y1] -> (R, C, ph, pw); each bin the max of its cells (0 if empty), a
    max over rows of a max over columns."""
    h, w = data.shape[2], data.shape[3]
    ph, pw = int(pooled_size[0]), int(pooled_size[1])
    dt, dev = data.dtype, data.device
    x1 = torch.round(rois[:, 1] * spatial_scale)
    y1 = torch.round(rois[:, 2] * spatial_scale)
    x2 = torch.round(rois[:, 3] * spatial_scale)
    y2 = torch.round(rois[:, 4] * spatial_scale)
    bh = (y2 - y1 + 1).clamp(min=1.0) / ph
    bw = (x2 - x1 + 1).clamp(min=1.0) / pw

    def masks(lo, hi, size, n_bins, step):
        """(R, bins, size): the cells of each bin along one axis."""
        i = torch.arange(n_bins, dtype=dt, device=dev)[None, :]
        start = lo[:, None] + torch.floor(i * step[:, None])
        stop = lo[:, None] + torch.ceil((i + 1) * step[:, None])
        pos = torch.arange(size, dtype=dt, device=dev)[None, None, :]
        return ((pos >= start[..., None])
                & (pos < torch.maximum(stop, start + 1)[..., None])
                & (pos <= hi[:, None, None]))

    ymask, xmask = masks(y1, y2, h, ph, bh), masks(x1, x2, w, pw, bw)
    img = data[rois[:, 0].long()]                                 # (R,C,H,W)
    neg = torch.full((), -math.inf, dtype=dt, device=dev)
    cols = torch.where(xmask[:, None, None], img[:, :, :, None, :],
                       neg).amax(dim=-1)                          # (R,C,H,pw)
    v = torch.where(ymask[:, None, :, :, None], cols[:, :, None], neg) \
        .amax(dim=3)                                              # (R,C,ph,pw)
    return torch.where(torch.isfinite(v), v, torch.zeros((), dtype=dt,
                                                          device=dev))


@register("Correlation")
def _correlation(data1, data2, kernel_size=1, max_displacement=1, stride1=1,
                 stride2=1, pad_size=0, is_multiply=True, **kw):
    """The channel mean of data1 times (or minus) data2 shifted by each
    displacement in [-d, d]^2 (step stride2), one output channel each;
    kernel_size and stride1 are taken and not used, as in the JAX
    package."""
    pad = int(pad_size)
    d1 = F.pad(data1, (pad, pad, pad, pad))
    d2 = F.pad(data2, (pad, pad, pad, pad))
    md, s2 = int(max_displacement), int(stride2)
    outs = []
    for dy in range(-md, md + 1, s2):
        for dx in range(-md, md + 1, s2):
            shifted = torch.roll(d2, (-dy, -dx), (2, 3))
            outs.append((d1 * shifted).mean(dim=1) if is_multiply
                        else (d1 - shifted).abs().mean(dim=1))
    hh, ww = d1.shape[2], d1.shape[3]
    return torch.stack(outs, dim=1)[:, :, pad:hh - pad, pad:ww - pad]


# --- Fused RNN ---------------------------------------------------------------
_RNN_FN = {"lstm": torch._VF.lstm, "gru": torch._VF.gru,
           "rnn_tanh": torch._VF.rnn_tanh, "rnn_relu": torch._VF.rnn_relu}


def _gates(mode):
    return {"rnn_relu": 1, "rnn_tanh": 1, "lstm": 4, "gru": 3}[mode]


def rnn_param_size(num_layers, input_size, state_size, mode,
                   bidirectional=False):
    """Length of the packed parameter vector (layout: ``rnn_weights``)."""
    g, d, h = _gates(mode), 2 if bidirectional else 1, state_size
    size = 0
    for layer in range(num_layers):
        in_sz = input_size if layer == 0 else h * d
        size += d * (g * h * in_sz + g * h * h + 2 * g * h)
    return size


def rnn_weights(params, num_layers, input_size, state_size, mode,
                bidirectional):
    """Views into the packed vector, per layer and direction ``i2h_W (G*H,
    in)``, ``h2h_W (G*H, H)``, ``i2h_b``, ``h2h_b``: the weight list of
    torch's recurrent functions, in its order."""
    g, d, h = _gates(mode), 2 if bidirectional else 1, state_size
    shapes = []
    for layer in range(num_layers):
        in_sz = input_size if layer == 0 else h * d
        for _ in range(d):
            shapes += [(g * h, in_sz), (g * h, h), (g * h,), (g * h,)]
    sizes = [math.prod(s) for s in shapes]
    if sum(sizes) != params.shape[0]:
        raise MXNetError("RNN: %d parameters, the layout needs %d"
                         % (params.shape[0], sum(sizes)))
    return [w.view(s) for w, s in zip(params.split(sizes), shapes)]


def _rnn_nout(attrs):
    if not attrs.get("state_outputs", False):
        return 1
    return 3 if attrs.get("mode", "lstm") == "lstm" else 2


@register("RNN", num_outputs=_rnn_nout, needs_rng=True, takes_mode=True)
def _rnn(data, parameters, state, *maybe_cell, state_size=0, num_layers=1,
         bidirectional=False, mode="lstm", p=0.0, state_outputs=False,
         rng=None, train_mode=False, lstm_state_clip_min=None,
         lstm_state_clip_max=None, projection_size=None, **kw):
    """Fused multi-layer RNN. data: (T, N, C); state: (L*D, N, H)."""
    h, n_layers = int(state_size), int(num_layers)
    d = 2 if bidirectional else 1
    is_lstm = mode == "lstm"
    weights = rnn_weights(parameters, n_layers, data.shape[2], h, mode,
                          bidirectional)
    fn = _RNN_FN[mode]
    # cuDNN keeps what its backward needs only when told it trains
    keep = torch.is_grad_enabled() and any(
        t.requires_grad for t in (data, parameters, state) + maybe_cell)
    cell = maybe_cell[0] if is_lstm else None
    drop = p > 0 and train_mode
    if drop:
        _need_rng(rng, "RNN(p > 0)")
    per_call = 1 if drop else n_layers
    x, hs, cs = data, [], []
    for first in range(0, n_layers, per_call):
        rows = slice(first * d, (first + per_call) * d)
        hx = (state[rows], cell[rows]) if is_lstm else state[rows]
        res = fn(x, hx, weights[first * 4 * d:(first + per_call) * 4 * d],
                 True, per_call, 0.0, keep, bool(bidirectional), False)
        x = res[0]
        hs.append(res[1])
        if is_lstm:
            cs.append(res[2])
        if drop and first + per_call < n_layers:
            x = _dropout(x, p=p, rng=rng, train_mode=True)
    if not state_outputs:
        return x
    outs = [x, torch.cat(hs) if len(hs) > 1 else hs[0]]
    if is_lstm:
        outs.append(torch.cat(cs) if len(cs) > 1 else cs[0])
    return tuple(outs)
