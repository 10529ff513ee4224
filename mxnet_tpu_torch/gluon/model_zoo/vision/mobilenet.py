"""MobileNet v1 at width multipliers 0.25/0.5/0.75/1.0.

Counterpart of ``mxnet_tpu/gluon/model_zoo/vision/mobilenet.py``: the
depthwise-separable stack from one (output channels, stride) plan; a
depthwise convolution is a ``Convolution`` with ``num_group`` equal to
its channels (cuDNN's grouped convolution on the card).
``pretrained=True`` loads the
model's file (``model_store``), raising where there is none.
"""
from __future__ import annotations

from ...block import HybridBlock
from ... import nn
from ._store import build

__all__ = ["MobileNet", "mobilenet1_0", "mobilenet0_75", "mobilenet0_5",
           "mobilenet0_25", "get_mobilenet"]

# (pointwise output channels, depthwise stride) for the 13 separable blocks
_SEPARABLE_PLAN = [
    (64, 1), (128, 2), (128, 1), (256, 2), (256, 1), (512, 2),
    (512, 1), (512, 1), (512, 1), (512, 1), (512, 1), (1024, 2), (1024, 1),
]


def _conv_bn_relu(seq, channels, kernel=1, stride=1, pad=0, groups=1):
    seq.add(nn.Conv2D(channels, kernel, stride, pad, groups=groups,
                      use_bias=False))
    seq.add(nn.BatchNorm(scale=True))
    seq.add(nn.Activation("relu"))


class MobileNet(HybridBlock):
    r"""Depthwise-separable trunk."""

    def __init__(self, multiplier=1.0, classes=1000, **kwargs):
        super().__init__(**kwargs)
        scale = lambda ch: int(ch * multiplier)
        with self.name_scope():
            self.features = nn.HybridSequential(prefix="")
            with self.features.name_scope():
                _conv_bn_relu(self.features, scale(32), kernel=3, stride=2,
                              pad=1)
                width = scale(32)
                for out_ch, stride in _SEPARABLE_PLAN:
                    # depthwise 3x3 at current width, then pointwise 1x1
                    _conv_bn_relu(self.features, width, kernel=3,
                                  stride=stride, pad=1, groups=width)
                    width = scale(out_ch)
                    _conv_bn_relu(self.features, width)
                self.features.add(nn.GlobalAvgPool2D())
                self.features.add(nn.Flatten())
            self.output = nn.Dense(classes)

    def hybrid_forward(self, F, x):
        return self.output(self.features(x))


def get_mobilenet(multiplier, pretrained=False, ctx=None, **kwargs):
    """A MobileNet at width ``multiplier``."""
    return build(lambda: MobileNet(multiplier, **kwargs),
                 "mobilenet%s" % multiplier, pretrained, ctx)


def _make_constructor(multiplier, suffix):
    def ctor(**kwargs):
        return get_mobilenet(multiplier, **kwargs)
    ctor.__name__ = "mobilenet%s" % suffix
    ctor.__doc__ = "MobileNet with width multiplier %s." % multiplier
    return ctor


mobilenet1_0 = _make_constructor(1.0, "1_0")
mobilenet0_75 = _make_constructor(0.75, "0_75")
mobilenet0_5 = _make_constructor(0.5, "0_5")
mobilenet0_25 = _make_constructor(0.25, "0_25")
