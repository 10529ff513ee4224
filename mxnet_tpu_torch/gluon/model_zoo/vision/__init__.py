"""Vision model zoo (counterpart of
``mxnet_tpu/gluon/model_zoo/vision/__init__.py``): the ResNets, and
``get_model`` by name."""
from ....base import MXNetError
from .resnet import *  # noqa: F401,F403
from . import resnet

_MODELS = {"resnet%d_v%d" % (depth, version):
           getattr(resnet, "resnet%d_v%d" % (depth, version))
           for version in (1, 2) for depth in sorted(resnet.resnet_spec)}


def get_model(name, **kwargs):
    """A model of the zoo by name (``"resnet50_v1"``); the other models of
    the JAX package's zoo (VGG, AlexNet, DenseNet, SqueezeNet, Inception,
    MobileNet) are not ported yet and raise."""
    name = name.lower()
    if name not in _MODELS:
        raise MXNetError("Model %s is not supported by this package. "
                         "Available options are\n\t%s"
                         % (name, "\n\t".join(sorted(_MODELS))))
    return _MODELS[name](**kwargs)
