"""AlexNet ("One weird trick" variant).

Counterpart of ``mxnet_tpu/gluon/model_zoo/vision/alexnet.py``: five
convolution stages from the same table, then two 4096-wide Dense layers,
each followed by ``Dropout(0.5)``, and the classifier.  Built in the same
order, so the same construction gives the same parameter names.
``pretrained=True`` loads the
model's file (``model_store``), raising where there is none.
"""
from __future__ import annotations

from ...block import HybridBlock
from ... import nn
from ._store import build

__all__ = ["AlexNet", "alexnet"]

# (channels, kernel, stride, pad, max-pool after?)
_CONV_PLAN = [
    (64, 11, 4, 2, True),
    (192, 5, 1, 2, True),
    (384, 3, 1, 1, False),
    (256, 3, 1, 1, False),
    (256, 3, 1, 1, True),
]


class AlexNet(HybridBlock):
    """AlexNet: five conv stages and two dropout-regularised FC layers."""

    def __init__(self, classes=1000, **kwargs):
        super().__init__(**kwargs)
        with self.name_scope():
            self.features = nn.HybridSequential(prefix="")
            with self.features.name_scope():
                for ch, k, s, p, pool in _CONV_PLAN:
                    self.features.add(nn.Conv2D(ch, kernel_size=k, strides=s,
                                                padding=p, activation="relu"))
                    if pool:
                        self.features.add(nn.MaxPool2D(pool_size=3,
                                                       strides=2))
                self.features.add(nn.Flatten())
            self.classifier = nn.HybridSequential(prefix="")
            with self.classifier.name_scope():
                for _ in range(2):
                    self.classifier.add(nn.Dense(4096, activation="relu"))
                    self.classifier.add(nn.Dropout(0.5))
                self.classifier.add(nn.Dense(classes))

    def hybrid_forward(self, F, x):
        return self.classifier(self.features(x))


def alexnet(pretrained=False, ctx=None, **kwargs):
    """AlexNet; its parameters are initialized later."""
    return build(lambda: AlexNet(**kwargs), "alexnet", pretrained, ctx)
