"""Vision model zoo (the port of ``mxnet_tpu/gluon/model_zoo/vision/``):
ResNet v1/v2, VGG, AlexNet, DenseNet, SqueezeNet, Inception v3 and
MobileNet v1/v2, each with the JAX package's blocks and parameter names,
and :func:`get_model` over the JAX package's whole name table.
``pretrained=True`` raises in every family: the model store downloads
the weights."""
from ....base import MXNetError
from .alexnet import *  # noqa: F401,F403
from .densenet import *  # noqa: F401,F403
from .inception import *  # noqa: F401,F403
from .mobilenet import *  # noqa: F401,F403
from .resnet import *  # noqa: F401,F403
from .squeezenet import *  # noqa: F401,F403
from .vgg import *  # noqa: F401,F403
from .mobilenet import get_mobilenet, get_mobilenet_v2  # noqa: F401
from .resnet import get_resnet  # noqa: F401
from .vgg import get_vgg  # noqa: F401

_MODELS = {"resnet%d_v%d" % (depth, version):
           globals()["resnet%d_v%d" % (depth, version)]
           for version in (1, 2) for depth in (18, 34, 50, 101, 152)}
_MODELS.update({
    "vgg11": vgg11, "vgg13": vgg13, "vgg16": vgg16, "vgg19": vgg19,
    "vgg11_bn": vgg11_bn, "vgg13_bn": vgg13_bn, "vgg16_bn": vgg16_bn,
    "vgg19_bn": vgg19_bn,
    "alexnet": alexnet,
    "densenet121": densenet121, "densenet161": densenet161,
    "densenet169": densenet169, "densenet201": densenet201,
    "squeezenet1.0": squeezenet1_0, "squeezenet1.1": squeezenet1_1,
    "inceptionv3": inception_v3,
    "mobilenet1.0": mobilenet1_0, "mobilenet0.75": mobilenet0_75,
    "mobilenet0.5": mobilenet0_5, "mobilenet0.25": mobilenet0_25,
    "mobilenetv2_1.0": mobilenet_v2_1_0,
    "mobilenetv2_0.75": mobilenet_v2_0_75,
    "mobilenetv2_0.5": mobilenet_v2_0_5,
    "mobilenetv2_0.25": mobilenet_v2_0_25,
})


def get_model(name, **kwargs):
    """Create a model by name (reference model_zoo/__init__.py:get_model)."""
    name = name.lower()
    if name not in _MODELS:
        raise MXNetError(
            "Model %s is not supported. Available options are\n\t%s"
            % (name, "\n\t".join(sorted(_MODELS))))
    return _MODELS[name](**kwargs)
