"""SqueezeNet 1.0 / 1.1.

Counterpart of ``mxnet_tpu/gluon/model_zoo/vision/squeezenet.py``: the
feature stack follows a plan per version, where "P" is a ceil-mode max
pool and a tuple a fire module; ``Dropout(0.5)`` and a convolutional
classifier close it.  ``pretrained=True`` loads the
model's file (``model_store``), raising where there is none.
"""
from __future__ import annotations

from ...block import HybridBlock
from ... import nn
from ._store import build

__all__ = ["SqueezeNet", "squeezenet1_0", "squeezenet1_1"]


def _relu_conv(channels, kernel, padding=0):
    seq = nn.HybridSequential(prefix="")
    seq.add(nn.Conv2D(channels, kernel, padding=padding))
    seq.add(nn.Activation("relu"))
    return seq


class _Fire(HybridBlock):
    """Squeeze 1x1 → parallel 1x1/3x3 expands, channel-concatenated."""

    def __init__(self, squeeze, expand1, expand3, **kwargs):
        super().__init__(**kwargs)
        self.squeeze = _relu_conv(squeeze, 1)
        self.left = _relu_conv(expand1, 1)
        self.right = _relu_conv(expand3, 3, 1)

    def hybrid_forward(self, F, x):
        x = self.squeeze(x)
        return F.concat(self.left(x), self.right(x), dim=1)


def _pool():
    return nn.MaxPool2D(pool_size=3, strides=2, ceil_mode=True)


# Per-version plans after the stem conv: "P" = pool, tuple = fire module.
_PLANS = {
    "1.0": ["P", (16, 64, 64), (16, 64, 64), (32, 128, 128), "P",
            (32, 128, 128), (48, 192, 192), (48, 192, 192), (64, 256, 256),
            "P", (64, 256, 256)],
    "1.1": ["P", (16, 64, 64), (16, 64, 64), "P", (32, 128, 128),
            (32, 128, 128), "P", (48, 192, 192), (48, 192, 192),
            (64, 256, 256), (64, 256, 256)],
}
_STEMS = {"1.0": (96, 7), "1.1": (64, 3)}


class SqueezeNet(HybridBlock):
    r"""SqueezeNet: fire modules + conv classifier."""

    def __init__(self, version, classes=1000, **kwargs):
        super().__init__(**kwargs)
        if version not in _PLANS:
            raise ValueError("Unsupported SqueezeNet version %s: "
                             "1.0 or 1.1 expected" % version)
        stem_ch, stem_k = _STEMS[version]
        with self.name_scope():
            self.features = nn.HybridSequential(prefix="")
            self.features.add(nn.Conv2D(stem_ch, kernel_size=stem_k,
                                        strides=2))
            self.features.add(nn.Activation("relu"))
            for item in _PLANS[version]:
                self.features.add(_pool() if item == "P" else _Fire(*item))
            self.features.add(nn.Dropout(0.5))
            self.output = nn.HybridSequential(prefix="")
            self.output.add(nn.Conv2D(classes, kernel_size=1))
            self.output.add(nn.Activation("relu"))
            self.output.add(nn.GlobalAvgPool2D())
            self.output.add(nn.Flatten())

    def hybrid_forward(self, F, x):
        return self.output(self.features(x))


def get_squeezenet(version, pretrained=False, ctx=None, **kwargs):
    return build(lambda: SqueezeNet(version, **kwargs),
                 "squeezenet%s" % version, pretrained, ctx)


def squeezenet1_0(**kwargs):
    return get_squeezenet("1.0", **kwargs)


def squeezenet1_1(**kwargs):
    return get_squeezenet("1.1", **kwargs)
