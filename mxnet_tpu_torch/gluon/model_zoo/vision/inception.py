"""Inception V3.

Counterpart of ``mxnet_tpu/gluon/model_zoo/vision/inception.py``: the
stem, three A modules, B, four C modules, D and two E modules, an 8x8
average pool, ``Dropout(0.5)`` and the classifier.  Each module is a
``_Parallel`` of branches whose outputs are concatenated on the
channels; the E modules' 1x3/3x1 pairs are ``_Fork13``.  Built in the
same order, so the same construction gives the same parameter names.
``pretrained=True`` loads the
model's file (``model_store``), raising where there is none.
"""
from __future__ import annotations

from ...block import HybridBlock
from ... import nn
from ._store import build

__all__ = ["Inception3", "inception_v3"]


def _unit(channels, kernel, stride=1, pad=0):
    """conv-BN-relu unit with the inception BN epsilon."""
    seq = nn.HybridSequential(prefix="")
    seq.add(nn.Conv2D(channels, kernel_size=kernel, strides=stride,
                      padding=pad, use_bias=False))
    seq.add(nn.BatchNorm(epsilon=0.001))
    seq.add(nn.Activation("relu"))
    return seq


def _branch(pool=None, *convs):
    """A sequential branch: optional pool head, then conv units
    (each described by a kwargs dict for :func:`_unit`)."""
    seq = nn.HybridSequential(prefix="")
    if pool == "avg":
        seq.add(nn.AvgPool2D(pool_size=3, strides=1, padding=1))
    elif pool == "max":
        seq.add(nn.MaxPool2D(pool_size=3, strides=2))
    for kw in convs:
        seq.add(_unit(**kw))
    return seq


class _Parallel(HybridBlock):
    """Feed the same input to every child; concat outputs on channels
    (reference uses gluon.contrib HybridConcurrent)."""

    def add(self, block):
        self.register_child(block)

    def hybrid_forward(self, F, x):
        return F.concat(*[child(x) for child in self._children], dim=1)


def _parallel(prefix, *branches):
    box = _Parallel(prefix=prefix)
    with box.name_scope():
        for b in branches:
            box.add(b)
    return box


def _module_a(pool_features, prefix):
    return _parallel(
        prefix,
        _branch(None, dict(channels=64, kernel=1)),
        _branch(None, dict(channels=48, kernel=1),
                dict(channels=64, kernel=5, pad=2)),
        _branch(None, dict(channels=64, kernel=1),
                dict(channels=96, kernel=3, pad=1),
                dict(channels=96, kernel=3, pad=1)),
        _branch("avg", dict(channels=pool_features, kernel=1)))


def _module_b(prefix):
    return _parallel(
        prefix,
        _branch(None, dict(channels=384, kernel=3, stride=2)),
        _branch(None, dict(channels=64, kernel=1),
                dict(channels=96, kernel=3, pad=1),
                dict(channels=96, kernel=3, stride=2)),
        _branch("max"))


def _module_c(width, prefix):
    row = dict(kernel=(1, 7), pad=(0, 3))
    col = dict(kernel=(7, 1), pad=(3, 0))
    return _parallel(
        prefix,
        _branch(None, dict(channels=192, kernel=1)),
        _branch(None, dict(channels=width, kernel=1),
                dict(channels=width, **row),
                dict(channels=192, **col)),
        _branch(None, dict(channels=width, kernel=1),
                dict(channels=width, **col),
                dict(channels=width, **row),
                dict(channels=width, **col),
                dict(channels=192, **row)),
        _branch("avg", dict(channels=192, kernel=1)))


def _module_d(prefix):
    return _parallel(
        prefix,
        _branch(None, dict(channels=192, kernel=1),
                dict(channels=320, kernel=3, stride=2)),
        _branch(None, dict(channels=192, kernel=1),
                dict(channels=192, kernel=(1, 7), pad=(0, 3)),
                dict(channels=192, kernel=(7, 1), pad=(3, 0)),
                dict(channels=192, kernel=3, stride=2)),
        _branch("max"))


class _Fork13(HybridBlock):
    """1x3 / 3x1 conv pair over the same input, channel-concatenated."""

    def __init__(self, channels, **kwargs):
        super().__init__(**kwargs)
        self.row = _branch(None, dict(channels=channels, kernel=(1, 3),
                                      pad=(0, 1)))
        self.col = _branch(None, dict(channels=channels, kernel=(3, 1),
                                      pad=(1, 0)))

    def hybrid_forward(self, F, x):
        return F.concat(self.row(x), self.col(x), dim=1)


def _module_e(prefix):
    stem2 = nn.HybridSequential(prefix="")
    stem2.add(_unit(384, 1))
    stem2.add(_Fork13(384))
    stem3 = nn.HybridSequential(prefix="")
    stem3.add(_unit(448, 1))
    stem3.add(_unit(384, 3, pad=1))
    stem3.add(_Fork13(384))
    return _parallel(
        prefix,
        _branch(None, dict(channels=320, kernel=1)),
        stem2, stem3,
        _branch("avg", dict(channels=192, kernel=1)))


class Inception3(HybridBlock):
    r"""Inception v3 trunk."""

    def __init__(self, classes=1000, **kwargs):
        super().__init__(**kwargs)
        with self.name_scope():
            f = nn.HybridSequential(prefix="")
            f.add(_unit(32, 3, stride=2))
            f.add(_unit(32, 3))
            f.add(_unit(64, 3, pad=1))
            f.add(nn.MaxPool2D(pool_size=3, strides=2))
            f.add(_unit(80, 1))
            f.add(_unit(192, 3))
            f.add(nn.MaxPool2D(pool_size=3, strides=2))
            for i, pool_features in enumerate((32, 64, 64)):
                f.add(_module_a(pool_features, "A%d_" % (i + 1)))
            f.add(_module_b("B_"))
            for i, width in enumerate((128, 160, 160, 192)):
                f.add(_module_c(width, "C%d_" % (i + 1)))
            f.add(_module_d("D_"))
            f.add(_module_e("E1_"))
            f.add(_module_e("E2_"))
            f.add(nn.AvgPool2D(pool_size=8))
            f.add(nn.Dropout(0.5))
            self.features = f
            self.output = nn.Dense(classes)

    def hybrid_forward(self, F, x):
        return self.output(self.features(x))


def inception_v3(pretrained=False, ctx=None, **kwargs):
    """Inception V3; its parameters are initialized later."""
    return build(lambda: Inception3(**kwargs), "inceptionv3", pretrained, ctx)
