"""Gluon 2-D convolution and pooling layers.

Counterpart of ``mxnet_tpu/gluon/nn/conv_layers.py`` (``_Conv`` :27,
``Conv2D`` :107, ``_Pooling`` :197, ``MaxPool2D`` :231, ``AvgPool2D``
:261, ``GlobalAvgPool2D`` :305).  They lower to the ``Convolution`` and
``Pooling`` ops.  The 1-D and 3-D layers and the transposed convolutions
are not ported yet.
"""
from __future__ import annotations

from ..block import HybridBlock
from .basic_layers import Activation

__all__ = ["Conv2D", "MaxPool2D", "AvgPool2D", "GlobalAvgPool2D"]


def _to_tuple(x, n):
    if isinstance(x, int):
        return (x,) * n
    assert len(x) == n
    return tuple(x)


class _Conv(HybridBlock):
    """Convolution layer; weight (O, I/groups, *kernel), I inferred from
    the first input when ``in_channels`` is 0."""

    def __init__(self, channels, kernel_size, strides, padding, dilation,
                 groups, layout, in_channels=0, activation=None,
                 use_bias=True, weight_initializer=None,
                 bias_initializer="zeros", **kwargs):
        super().__init__(**kwargs)
        with self.name_scope():
            self._channels = channels
            self._in_channels = in_channels
            self._kwargs = {
                "kernel": kernel_size, "stride": strides,
                "dilate": dilation, "pad": padding,
                "num_filter": channels, "num_group": groups,
                "no_bias": not use_bias, "layout": layout}
            wshape = (channels, in_channels // groups if in_channels else 0) \
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
        if bias is None:
            out = F.Convolution(x, weight, **self._kwargs)
        else:
            out = F.Convolution(x, weight, bias, **self._kwargs)
        return self.act(out) if self.act is not None else out


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


class MaxPool2D(_Pooling):
    def __init__(self, pool_size=(2, 2), strides=None, padding=0,
                 layout="NCHW", ceil_mode=False, **kwargs):
        assert layout == "NCHW"
        super().__init__(
            _to_tuple(pool_size, 2),
            _to_tuple(strides, 2) if strides is not None else None,
            _to_tuple(padding, 2), ceil_mode, False, "max", **kwargs)


class AvgPool2D(_Pooling):
    def __init__(self, pool_size=(2, 2), strides=None, padding=0,
                 layout="NCHW", ceil_mode=False, **kwargs):
        assert layout == "NCHW"
        super().__init__(
            _to_tuple(pool_size, 2),
            _to_tuple(strides, 2) if strides is not None else None,
            _to_tuple(padding, 2), ceil_mode, False, "avg", **kwargs)


class GlobalAvgPool2D(_Pooling):
    def __init__(self, layout="NCHW", **kwargs):
        super().__init__((1, 1), None, (0, 0), True, True, "avg", **kwargs)
