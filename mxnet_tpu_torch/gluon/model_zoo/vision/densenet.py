"""DenseNet-BC 121/161/169/201.

Counterpart of ``mxnet_tpu/gluon/model_zoo/vision/densenet.py``: the
BN-relu-conv motif shared by the dense layers and the transitions, each
dense layer's output concatenated onto the running feature map, and the
constructors made from the depth table.  ``pretrained=True`` loads the
model's file (``model_store``), raising where there is none.
"""
from __future__ import annotations

from ...block import HybridBlock
from ... import nn
from ._store import build

__all__ = ["DenseNet", "densenet121", "densenet161", "densenet169",
           "densenet201"]


def _bn_relu_conv(seq, channels, kernel, padding=0):
    """Append the pre-activation conv motif to *seq*."""
    seq.add(nn.BatchNorm())
    seq.add(nn.Activation("relu"))
    seq.add(nn.Conv2D(channels, kernel_size=kernel, padding=padding,
                      use_bias=False))


class _GrowthUnit(HybridBlock):
    """One dense layer: 1x1 bottleneck → 3x3 conv, output concatenated
    onto the running feature map."""

    def __init__(self, growth_rate, bn_size, dropout, **kwargs):
        super().__init__(**kwargs)
        self.body = nn.HybridSequential(prefix="")
        _bn_relu_conv(self.body, bn_size * growth_rate, 1)
        _bn_relu_conv(self.body, growth_rate, 3, padding=1)
        if dropout:
            self.body.add(nn.Dropout(dropout))

    def hybrid_forward(self, F, x):
        return F.concat(x, self.body(x), dim=1)


def _dense_stage(count, bn_size, growth_rate, dropout, stage_index):
    stage = nn.HybridSequential(prefix="stage%d_" % stage_index)
    with stage.name_scope():
        for _ in range(count):
            stage.add(_GrowthUnit(growth_rate, bn_size, dropout))
    return stage


def _transition(channels):
    """Halve channels (1x1 conv) and resolution (2x2 avg pool)."""
    tr = nn.HybridSequential(prefix="")
    _bn_relu_conv(tr, channels, 1)
    tr.add(nn.AvgPool2D(pool_size=2, strides=2))
    return tr


class DenseNet(HybridBlock):
    r"""DenseNet-BC trunk."""

    def __init__(self, num_init_features, growth_rate, block_config,
                 bn_size=4, dropout=0, classes=1000, **kwargs):
        super().__init__(**kwargs)
        with self.name_scope():
            self.features = nn.HybridSequential(prefix="")
            self.features.add(nn.Conv2D(num_init_features, kernel_size=7,
                                        strides=2, padding=3, use_bias=False))
            self.features.add(nn.BatchNorm())
            self.features.add(nn.Activation("relu"))
            self.features.add(nn.MaxPool2D(pool_size=3, strides=2, padding=1))

            width = num_init_features
            last = len(block_config) - 1
            for stage, count in enumerate(block_config):
                self.features.add(_dense_stage(count, bn_size, growth_rate,
                                               dropout, stage + 1))
                width += count * growth_rate
                if stage != last:
                    width //= 2
                    self.features.add(_transition(width))

            self.features.add(nn.BatchNorm())
            self.features.add(nn.Activation("relu"))
            self.features.add(nn.AvgPool2D(pool_size=7))
            self.features.add(nn.Flatten())
            self.output = nn.Dense(classes)

    def hybrid_forward(self, F, x):
        return self.output(self.features(x))


# depth → (stem width, growth rate, per-stage layer counts)
densenet_spec = {121: (64, 32, [6, 12, 24, 16]),
                 161: (96, 48, [6, 12, 36, 24]),
                 169: (64, 32, [6, 12, 32, 32]),
                 201: (64, 32, [6, 12, 48, 32])}


def get_densenet(num_layers, pretrained=False, ctx=None, **kwargs):
    stem, growth, stages = densenet_spec[num_layers]
    return build(lambda: DenseNet(stem, growth, stages, **kwargs),
                 "densenet%d" % num_layers, pretrained, ctx)


def _make_constructor(depth):
    def ctor(**kwargs):
        return get_densenet(depth, **kwargs)
    ctor.__name__ = "densenet%d" % depth
    ctor.__doc__ = "DenseNet-%d constructor." % depth
    return ctor


for _d in sorted(densenet_spec):
    globals()["densenet%d" % _d] = _make_constructor(_d)
del _d
