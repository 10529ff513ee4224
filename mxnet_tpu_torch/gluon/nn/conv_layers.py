"""Gluon convolution and pooling layers.

Counterpart of ``mxnet_tpu/gluon/nn/conv_layers.py``: ``_Conv`` :27,
``Conv1D``/``2D``/``3D`` :92-137, the transposed convolutions
``Conv1D``/``2D``/``3DTranspose`` :138-196 (through the
``Deconvolution`` op, weight (in_channels, channels/groups, *k),
``output_padding`` as its ``adj``), ``_Pooling`` :197 and the max,
average and global pools in 1-3 D :221-316.  They lower to the
``Convolution``, ``Deconvolution`` and ``Pooling`` ops; ``ceil_mode`` is
the op's ``pooling_convention="full"``.
"""
from __future__ import annotations

from ..block import HybridBlock
from .basic_layers import Activation

__all__ = ["Conv1D", "Conv2D", "Conv3D",
           "Conv1DTranspose", "Conv2DTranspose", "Conv3DTranspose",
           "MaxPool1D", "MaxPool2D", "MaxPool3D",
           "AvgPool1D", "AvgPool2D", "AvgPool3D",
           "GlobalMaxPool1D", "GlobalMaxPool2D", "GlobalMaxPool3D",
           "GlobalAvgPool1D", "GlobalAvgPool2D", "GlobalAvgPool3D"]


def _to_tuple(x, n):
    if isinstance(x, int):
        return (x,) * n
    assert len(x) == n
    return tuple(x)


class _Conv(HybridBlock):
    """Convolution layer; weight (O, I/groups, *kernel) for ``Convolution``
    and (I, O/groups, *kernel) for ``Deconvolution``, I inferred from the
    first input when ``in_channels`` is 0."""

    def __init__(self, channels, kernel_size, strides, padding, dilation,
                 groups, layout, in_channels=0, activation=None,
                 use_bias=True, weight_initializer=None,
                 bias_initializer="zeros", op_name="Convolution", adj=None,
                 **kwargs):
        super().__init__(**kwargs)
        with self.name_scope():
            self._channels = channels
            self._in_channels = in_channels
            self._op_name = op_name
            self._kwargs = {
                "kernel": kernel_size, "stride": strides,
                "dilate": dilation, "pad": padding,
                "num_filter": channels, "num_group": groups,
                "no_bias": not use_bias, "layout": layout}
            if adj is not None:
                self._kwargs["adj"] = adj
            if op_name == "Convolution":
                wshape = (channels, in_channels // groups
                          if in_channels else 0) + tuple(kernel_size)
            else:
                wshape = (in_channels, channels // groups) \
                    + tuple(kernel_size)
            self.weight = self.params.get(
                "weight", shape=wshape, init=weight_initializer,
                allow_deferred_init=True)
            self.bias = self.params.get(
                "bias", shape=(channels,), init=bias_initializer,
                allow_deferred_init=True) if use_bias else None
            self.act = Activation(activation, prefix=activation + "_") \
                if activation is not None else None

    def hybrid_forward(self, F, x, weight, bias=None):
        op = getattr(F, self._op_name)
        if bias is None:
            out = op(x, weight, **self._kwargs)
        else:
            out = op(x, weight, bias, **self._kwargs)
        return self.act(out) if self.act is not None else out


class Conv1D(_Conv):
    def __init__(self, channels, kernel_size, strides=1, padding=0,
                 dilation=1, groups=1, layout="NCW", activation=None,
                 use_bias=True, weight_initializer=None,
                 bias_initializer="zeros", in_channels=0, **kwargs):
        super().__init__(
            channels, _to_tuple(kernel_size, 1), _to_tuple(strides, 1),
            _to_tuple(padding, 1), _to_tuple(dilation, 1), groups, layout,
            in_channels, activation, use_bias, weight_initializer,
            bias_initializer, **kwargs)


class Conv2D(_Conv):
    def __init__(self, channels, kernel_size, strides=(1, 1),
                 padding=(0, 0), dilation=(1, 1), groups=1, layout="NCHW",
                 activation=None, use_bias=True, weight_initializer=None,
                 bias_initializer="zeros", in_channels=0, **kwargs):
        super().__init__(
            channels, _to_tuple(kernel_size, 2), _to_tuple(strides, 2),
            _to_tuple(padding, 2), _to_tuple(dilation, 2), groups, layout,
            in_channels, activation, use_bias, weight_initializer,
            bias_initializer, **kwargs)


class Conv3D(_Conv):
    def __init__(self, channels, kernel_size, strides=(1, 1, 1),
                 padding=(0, 0, 0), dilation=(1, 1, 1), groups=1,
                 layout="NCDHW", activation=None, use_bias=True,
                 weight_initializer=None, bias_initializer="zeros",
                 in_channels=0, **kwargs):
        super().__init__(
            channels, _to_tuple(kernel_size, 3), _to_tuple(strides, 3),
            _to_tuple(padding, 3), _to_tuple(dilation, 3), groups, layout,
            in_channels, activation, use_bias, weight_initializer,
            bias_initializer, **kwargs)


class _ConvTranspose(_Conv):
    def __init__(self, channels, kernel_size, strides, padding,
                 output_padding, dilation, groups, layout, in_channels,
                 activation, use_bias, weight_initializer,
                 bias_initializer, **kwargs):
        super().__init__(
            channels, kernel_size, strides, padding, dilation, groups,
            layout, in_channels, activation, use_bias, weight_initializer,
            bias_initializer, op_name="Deconvolution", adj=output_padding,
            **kwargs)


class Conv1DTranspose(_ConvTranspose):
    def __init__(self, channels, kernel_size, strides=1, padding=0,
                 output_padding=0, dilation=1, groups=1, layout="NCW",
                 activation=None, use_bias=True, weight_initializer=None,
                 bias_initializer="zeros", in_channels=0, **kwargs):
        super().__init__(
            channels, _to_tuple(kernel_size, 1), _to_tuple(strides, 1),
            _to_tuple(padding, 1), _to_tuple(output_padding, 1),
            _to_tuple(dilation, 1), groups, layout, in_channels,
            activation, use_bias, weight_initializer, bias_initializer,
            **kwargs)


class Conv2DTranspose(_ConvTranspose):
    def __init__(self, channels, kernel_size, strides=(1, 1),
                 padding=(0, 0), output_padding=(0, 0), dilation=(1, 1),
                 groups=1, layout="NCHW", activation=None, use_bias=True,
                 weight_initializer=None, bias_initializer="zeros",
                 in_channels=0, **kwargs):
        super().__init__(
            channels, _to_tuple(kernel_size, 2), _to_tuple(strides, 2),
            _to_tuple(padding, 2), _to_tuple(output_padding, 2),
            _to_tuple(dilation, 2), groups, layout, in_channels,
            activation, use_bias, weight_initializer, bias_initializer,
            **kwargs)


class Conv3DTranspose(_ConvTranspose):
    def __init__(self, channels, kernel_size, strides=(1, 1, 1),
                 padding=(0, 0, 0), output_padding=(0, 0, 0),
                 dilation=(1, 1, 1), groups=1, layout="NCDHW",
                 activation=None, use_bias=True, weight_initializer=None,
                 bias_initializer="zeros", in_channels=0, **kwargs):
        super().__init__(
            channels, _to_tuple(kernel_size, 3), _to_tuple(strides, 3),
            _to_tuple(padding, 3), _to_tuple(output_padding, 3),
            _to_tuple(dilation, 3), groups, layout, in_channels,
            activation, use_bias, weight_initializer, bias_initializer,
            **kwargs)


class _Pooling(HybridBlock):
    """Pooling layer; ``ceil_mode`` is the op's ``pooling_convention``
    ``full``."""

    def __init__(self, pool_size, strides, padding, ceil_mode=False,
                 global_pool=False, pool_type="max", **kwargs):
        super().__init__(**kwargs)
        if strides is None:
            strides = pool_size
        self._kwargs = {
            "kernel": pool_size, "stride": strides, "pad": padding,
            "global_pool": global_pool, "pool_type": pool_type,
            "pooling_convention": "full" if ceil_mode else "valid"}

    def _alias(self):
        return "pool"

    def hybrid_forward(self, F, x):
        return F.Pooling(x, **self._kwargs)


_LAYOUTS = {1: "NCW", 2: "NCHW", 3: "NCDHW"}


def _pool_class(name, n, pool_type):
    """``MaxPool2D`` and its kin: a windowed pool over ``n`` spatial dims
    (window 2 and stride the window by default)."""
    def __init__(self, pool_size=(2,) * n, strides=None, padding=0,
                 layout=_LAYOUTS[n], ceil_mode=False, **kwargs):
        assert layout == _LAYOUTS[n]
        _Pooling.__init__(
            self, _to_tuple(pool_size, n),
            _to_tuple(strides, n) if strides is not None else None,
            _to_tuple(padding, n), ceil_mode, False, pool_type, **kwargs)
    return type(name, (_Pooling,), {"__init__": __init__})


def _global_pool_class(name, n, pool_type):
    """``GlobalAvgPool2D`` and its kin: a pool over all ``n`` spatial
    dims."""
    def __init__(self, layout=_LAYOUTS[n], **kwargs):
        _Pooling.__init__(self, (1,) * n, None, (0,) * n, True, True,
                          pool_type, **kwargs)
    return type(name, (_Pooling,), {"__init__": __init__})


for _n in _LAYOUTS:
    for _kind in ("Max", "Avg"):
        _cls = "%sPool%dD" % (_kind, _n)
        globals()[_cls] = _pool_class(_cls, _n, _kind.lower())
        _cls = "Global%sPool%dD" % (_kind, _n)
        globals()[_cls] = _global_pool_class(_cls, _n, _kind.lower())
del _n, _kind, _cls
