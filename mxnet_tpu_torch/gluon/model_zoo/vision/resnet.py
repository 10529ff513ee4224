"""ResNet V1 (post-activation) and V2 (pre-activation), every depth.

Counterpart of ``mxnet_tpu/gluon/model_zoo/vision/resnet.py``: the
residual blocks V1 and V2 (``:38-131``), the stem (``:151``),
``ResNetV1`` (``:162``), ``ResNetV2`` (``:182``), ``resnet_spec``
(``:208``), ``get_resnet`` (``:221``) and the constructors
``resnet{18,34,50,101,152}_v{1,2}`` (``:240``).  The blocks are built in
the same order, so the same construction gives the same parameter
names.  ``pretrained=True`` loads the
model's file from disk (``model_store``), raising where there is none.
"""
from __future__ import annotations

from ...block import HybridBlock
from ... import nn
from ._store import build

__all__ = ["ResNetV1", "ResNetV2", "BasicBlockV1", "BasicBlockV2",
           "BottleneckV1", "BottleneckV2", "resnet18_v1", "resnet34_v1",
           "resnet50_v1", "resnet101_v1", "resnet152_v1", "resnet18_v2",
           "resnet34_v2", "resnet50_v2", "resnet101_v2", "resnet152_v2",
           "get_resnet"]


def _conv(channels, kernel, stride=1, pad=None, in_channels=0, bias=False):
    if pad is None:
        pad = kernel // 2
    return nn.Conv2D(channels, kernel_size=kernel, strides=stride,
                     padding=pad, use_bias=bias, in_channels=in_channels)


def _conv3x3(channels, stride, in_channels):
    return _conv(channels, 3, stride, 1, in_channels)


class _ResidualV1(HybridBlock):
    """V1 template: body(x) + shortcut, then relu. Subclasses define the
    body via ``conv_plan(channels, stride)`` → [(ch, kernel, stride), ...];
    BN follows every conv, relu all but the last."""

    def __init__(self, channels, stride, downsample=False, in_channels=0,
                 **kwargs):
        super().__init__(**kwargs)
        plan = self.conv_plan(channels, stride)
        self.body = nn.HybridSequential(prefix="")
        for pos, (ch, kernel, s) in enumerate(plan):
            # reference V1 keeps biases on the bottleneck 1x1 convs
            self.body.add(_conv(ch, kernel, s,
                                in_channels=in_channels if pos == 0 else 0,
                                bias=(kernel == 1)))
            self.body.add(nn.BatchNorm())
            if pos + 1 < len(plan):
                self.body.add(nn.Activation("relu"))
        if downsample:
            self.downsample = nn.HybridSequential(prefix="")
            self.downsample.add(_conv(channels, 1, stride, 0, in_channels))
            self.downsample.add(nn.BatchNorm())
        else:
            self.downsample = None

    def hybrid_forward(self, F, x):
        shortcut = x if self.downsample is None else self.downsample(x)
        return F.Activation(self.body(x) + shortcut, act_type="relu")


class BasicBlockV1(_ResidualV1):
    r"""Two 3x3 convs ("Deep Residual Learning", 18/34-layer nets)."""

    @staticmethod
    def conv_plan(channels, stride):
        return [(channels, 3, stride), (channels, 3, 1)]


class BottleneckV1(_ResidualV1):
    r"""1x1 → 3x3 → 1x1 bottleneck (50/101/152-layer nets)."""

    @staticmethod
    def conv_plan(channels, stride):
        return [(channels // 4, 1, stride), (channels // 4, 3, 1),
                (channels, 1, 1)]


class _ResidualV2(HybridBlock):
    """V2 template ("Identity Mappings"): BN-relu precedes each conv; the
    shortcut taps the pre-activated input when downsampling."""

    def __init__(self, channels, stride, downsample=False, in_channels=0,
                 **kwargs):
        super().__init__(**kwargs)
        plan = self.conv_plan(channels, stride)
        self._bns = []
        self._convs = []
        for pos, (ch, kernel, s) in enumerate(plan):
            bn = nn.BatchNorm()
            conv = _conv(ch, kernel, s,
                         in_channels=in_channels if pos == 0 else 0)
            setattr(self, "bn%d" % (pos + 1), bn)
            setattr(self, "conv%d" % (pos + 1), conv)
            self._bns.append(bn)
            self._convs.append(conv)
        self.downsample = _conv(channels, 1, stride, 0, in_channels) \
            if downsample else None

    def hybrid_forward(self, F, x):
        shortcut = x
        for pos, (bn, conv) in enumerate(zip(self._bns, self._convs)):
            x = F.Activation(bn(x), act_type="relu")
            if pos == 0 and self.downsample is not None:
                shortcut = self.downsample(x)
            x = conv(x)
        return x + shortcut


class BasicBlockV2(_ResidualV2):
    r"""Pre-activation basic block."""

    @staticmethod
    def conv_plan(channels, stride):
        return [(channels, 3, stride), (channels, 3, 1)]


class BottleneckV2(_ResidualV2):
    r"""Pre-activation bottleneck."""

    @staticmethod
    def conv_plan(channels, stride):
        return [(channels // 4, 1, 1), (channels // 4, 3, stride),
                (channels, 1, 1)]


def _stack_stages(features, block, layers, channels, make_prefix):
    """Append the four residual stages; returns the final channel count."""
    width_in = channels[0]
    for stage, count in enumerate(layers):
        width = channels[stage + 1]
        stride = 1 if stage == 0 else 2
        group = nn.HybridSequential(prefix=make_prefix(stage + 1))
        with group.name_scope():
            group.add(block(width, stride, width != width_in,
                            in_channels=width_in, prefix=""))
            for _ in range(count - 1):
                group.add(block(width, 1, False, in_channels=width,
                                prefix=""))
        features.add(group)
        width_in = width
    return width_in


def _stem(features, channels0, thumbnail):
    """7x7/pool ImageNet stem, or a bare 3x3 for 32x32 inputs."""
    if thumbnail:
        features.add(_conv3x3(channels0, 1, 0))
    else:
        features.add(nn.Conv2D(channels0, 7, 2, 3, use_bias=False))
        features.add(nn.BatchNorm())
        features.add(nn.Activation("relu"))
        features.add(nn.MaxPool2D(3, 2, 1))


class ResNetV1(HybridBlock):
    r"""Post-activation ResNet trunk (ref resnet.py:ResNetV1)."""

    def __init__(self, block, layers, channels, classes=1000,
                 thumbnail=False, **kwargs):
        super().__init__(**kwargs)
        if len(layers) != len(channels) - 1:
            raise ValueError("channels must have one more entry than layers")
        with self.name_scope():
            self.features = nn.HybridSequential(prefix="")
            _stem(self.features, channels[0], thumbnail)
            _stack_stages(self.features, block, layers, channels,
                          lambda i: "stage%d_" % i)
            self.features.add(nn.GlobalAvgPool2D())
            self.output = nn.Dense(classes, in_units=channels[-1])

    def hybrid_forward(self, F, x):
        return self.output(self.features(x))


class ResNetV2(HybridBlock):
    r"""Pre-activation ResNet trunk (ref resnet.py:ResNetV2): leading
    data BN, trailing BN-relu before pooling."""

    def __init__(self, block, layers, channels, classes=1000,
                 thumbnail=False, **kwargs):
        super().__init__(**kwargs)
        if len(layers) != len(channels) - 1:
            raise ValueError("channels must have one more entry than layers")
        with self.name_scope():
            self.features = nn.HybridSequential(prefix="")
            self.features.add(nn.BatchNorm(scale=False, center=False))
            _stem(self.features, channels[0], thumbnail)
            final = _stack_stages(self.features, block, layers, channels,
                                  lambda i: "stage%d_" % i)
            self.features.add(nn.BatchNorm())
            self.features.add(nn.Activation("relu"))
            self.features.add(nn.GlobalAvgPool2D())
            self.features.add(nn.Flatten())
            self.output = nn.Dense(classes, in_units=final)

    def hybrid_forward(self, F, x):
        return self.output(self.features(x))


# depth → (block kind, per-stage counts, per-stage channels)
resnet_spec = {
    18: ("basic_block", [2, 2, 2, 2], [64, 64, 128, 256, 512]),
    34: ("basic_block", [3, 4, 6, 3], [64, 64, 128, 256, 512]),
    50: ("bottle_neck", [3, 4, 6, 3], [64, 256, 512, 1024, 2048]),
    101: ("bottle_neck", [3, 4, 23, 3], [64, 256, 512, 1024, 2048]),
    152: ("bottle_neck", [3, 8, 36, 3], [64, 256, 512, 1024, 2048])}

resnet_net_versions = [ResNetV1, ResNetV2]
resnet_block_versions = [
    {"basic_block": BasicBlockV1, "bottle_neck": BottleneckV1},
    {"basic_block": BasicBlockV2, "bottle_neck": BottleneckV2}]


def get_resnet(version, num_layers, pretrained=False, ctx=None, **kwargs):
    """Build a ResNet by (version, depth); its parameters are initialized
    later, by ``initialize`` or by ``Module``."""
    if num_layers not in resnet_spec:
        raise ValueError("Invalid number of layers: %d. Options are %s"
                         % (num_layers, sorted(resnet_spec)))
    if version not in (1, 2):
        raise ValueError("Invalid resnet version: %d. Options are 1 and 2."
                         % version)
    kind, layers, channels = resnet_spec[num_layers]
    trunk = resnet_net_versions[version - 1]
    block = resnet_block_versions[version - 1][kind]
    return build(lambda: trunk(block, layers, channels, **kwargs),
                 "resnet%d_v%d" % (num_layers, version), pretrained, ctx)


def _make_constructor(version, depth):
    def ctor(**kwargs):
        return get_resnet(version, depth, **kwargs)
    ctor.__name__ = "resnet%d_v%d" % (depth, version)
    ctor.__doc__ = "ResNet-%d V%d constructor." % (depth, version)
    return ctor


for _v in (1, 2):
    for _d in sorted(resnet_spec):
        globals()["resnet%d_v%d" % (_d, _v)] = _make_constructor(_v, _d)
del _v, _d
