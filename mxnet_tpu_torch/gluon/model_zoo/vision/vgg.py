"""VGG 11/13/16/19, plain and with BatchNorm.

Counterpart of ``mxnet_tpu/gluon/model_zoo/vision/vgg.py``: 3x3
convolution stages each closed by a stride-2 max pool, two 4096-wide
Dense layers with ``Dropout(0.5)``, and the classifier; the convolutions
take Xavier (gaussian, fan out, magnitude 2), the Dense layers normal.
``pretrained=True`` loads the
model's file (``model_store``), raising where there is none.
"""
from __future__ import annotations

from ....initializer import Xavier
from ...block import HybridBlock
from ... import nn
from ._store import build

__all__ = ["VGG", "vgg11", "vgg13", "vgg16", "vgg19", "vgg11_bn",
           "vgg13_bn", "vgg16_bn", "vgg19_bn", "get_vgg"]

_CONV_INIT = dict(weight_initializer=Xavier(rnd_type="gaussian",
                                            factor_type="out", magnitude=2),
                  bias_initializer="zeros")
_FC_INIT = dict(weight_initializer="normal", bias_initializer="zeros")


class VGG(HybridBlock):
    """Stacked 3x3-conv stages and two 4096-wide FC layers."""

    def __init__(self, layers, filters, classes=1000, batch_norm=False,
                 **kwargs):
        super().__init__(**kwargs)
        if len(layers) != len(filters):
            raise ValueError("layers and filters must pair up")
        with self.name_scope():
            self.features = nn.HybridSequential(prefix="")
            for repeat, width in zip(layers, filters):
                self._add_stage(repeat, width, batch_norm)
            for _ in range(2):
                self.features.add(nn.Dense(4096, activation="relu",
                                           **_FC_INIT))
                self.features.add(nn.Dropout(rate=0.5))
            self.output = nn.Dense(classes, **_FC_INIT)

    def _add_stage(self, repeat, width, batch_norm):
        """One resolution stage: ``repeat`` convs, then a stride-2 pool."""
        for _ in range(repeat):
            self.features.add(nn.Conv2D(width, kernel_size=3, padding=1,
                                        **_CONV_INIT))
            if batch_norm:
                self.features.add(nn.BatchNorm())
            self.features.add(nn.Activation("relu"))
        self.features.add(nn.MaxPool2D(strides=2))

    def hybrid_forward(self, F, x):
        return self.output(self.features(x))


vgg_spec = {11: ([1, 1, 2, 2, 2], [64, 128, 256, 512, 512]),
            13: ([2, 2, 2, 2, 2], [64, 128, 256, 512, 512]),
            16: ([2, 2, 3, 3, 3], [64, 128, 256, 512, 512]),
            19: ([2, 2, 4, 4, 4], [64, 128, 256, 512, 512])}


def get_vgg(num_layers, pretrained=False, ctx=None, **kwargs):
    """A VGG by depth."""
    layers, filters = vgg_spec[num_layers]
    return build(lambda: VGG(layers, filters, **kwargs),
                 "vgg%d%s" % (num_layers, "_bn" if kwargs.get("batch_norm")
                              else ""), pretrained, ctx)


def _make_constructor(depth, batch_norm):
    def ctor(**kwargs):
        if batch_norm:
            kwargs["batch_norm"] = True
        return get_vgg(depth, **kwargs)
    ctor.__name__ = "vgg%d%s" % (depth, "_bn" if batch_norm else "")
    ctor.__doc__ = "VGG-%d%s constructor." % (depth,
                                              " (BN)" if batch_norm else "")
    return ctor


for _d in sorted(vgg_spec):
    globals()["vgg%d" % _d] = _make_constructor(_d, False)
    globals()["vgg%d_bn" % _d] = _make_constructor(_d, True)
del _d
