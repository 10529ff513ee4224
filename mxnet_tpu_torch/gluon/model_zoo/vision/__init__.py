"""Vision model zoo (counterpart of
``mxnet_tpu/gluon/model_zoo/vision/__init__.py:19-48``): the ResNets,
VGG, AlexNet, DenseNet, SqueezeNet, Inception V3 and MobileNet, and
``get_model`` by the names of the JAX package's table (``"resnet50_v1"``,
``"vgg16_bn"``, ``"inceptionv3"``, ``"squeezenet1.1"``,
``"mobilenet0.25"``).  ``pretrained=True`` loads the model's file from
disk in every constructor (``model_store``), raising where there is
none; an unknown name raises ``MXNetError``."""
from ....base import MXNetError
from .alexnet import *  # noqa: F401,F403
from .densenet import *  # noqa: F401,F403
from .inception import *  # noqa: F401,F403
from .resnet import *  # noqa: F401,F403
from .squeezenet import *  # noqa: F401,F403
from .vgg import *  # noqa: F401,F403
from .mobilenet import *  # noqa: F401,F403
from . import densenet, inception, mobilenet, resnet, squeezenet, vgg

_MODELS = {"resnet%d_v%d" % (depth, version):
           getattr(resnet, "resnet%d_v%d" % (depth, version))
           for version in (1, 2) for depth in sorted(resnet.resnet_spec)}
_MODELS.update({"vgg%d%s" % (depth, bn): getattr(vgg, "vgg%d%s" % (depth, bn))
                for depth in sorted(vgg.vgg_spec) for bn in ("", "_bn")})
_MODELS.update({"densenet%d" % depth: getattr(densenet, "densenet%d" % depth)
                for depth in sorted(densenet.densenet_spec)})
_MODELS.update({
    "alexnet": alexnet,  # noqa: F405 (the function; its module's name)
    "squeezenet1.0": squeezenet.squeezenet1_0,
    "squeezenet1.1": squeezenet.squeezenet1_1,
    "inceptionv3": inception.inception_v3,
    "mobilenet1.0": mobilenet.mobilenet1_0,
    "mobilenet0.75": mobilenet.mobilenet0_75,
    "mobilenet0.5": mobilenet.mobilenet0_5,
    "mobilenet0.25": mobilenet.mobilenet0_25})


def get_model(name, **kwargs):
    """A model of the zoo by name (``"resnet50_v1"``, ``"alexnet"``)."""
    name = name.lower()
    if name not in _MODELS:
        raise MXNetError("Model %s is not supported by this package. "
                         "Available options are\n\t%s"
                         % (name, "\n\t".join(sorted(_MODELS))))
    return _MODELS[name](**kwargs)
