"""Vision model zoo (the port of ``mxnet_tpu/gluon/model_zoo/vision/``):
the ResNet family and :func:`get_model` for its names. The other families
(VGG, AlexNet, DenseNet, SqueezeNet, Inception, MobileNet) are not ported
yet: ``get_model`` raises for their names."""
from ....base import MXNetError
from .resnet import *  # noqa: F401,F403
from .resnet import get_resnet  # noqa: F401

_RESNETS = {"resnet%d_v%d" % (depth, version):
            globals()["resnet%d_v%d" % (depth, version)]
            for version in (1, 2) for depth in (18, 34, 50, 101, 152)}

_NOT_PORTED = (
    "vgg11", "vgg13", "vgg16", "vgg19", "vgg11_bn", "vgg13_bn", "vgg16_bn",
    "vgg19_bn", "alexnet", "densenet121", "densenet161", "densenet169",
    "densenet201", "squeezenet1.0", "squeezenet1.1", "inceptionv3",
    "mobilenet1.0", "mobilenet0.75", "mobilenet0.5", "mobilenet0.25",
    "mobilenetv2_1.0", "mobilenetv2_0.75", "mobilenetv2_0.5",
    "mobilenetv2_0.25")


def get_model(name, **kwargs):
    """Create a model by name (reference model_zoo/__init__.py:get_model)."""
    name = name.lower()
    if name in _NOT_PORTED:
        raise MXNetError("model %s is not ported yet (the port's zoo has "
                         "the ResNets)" % name)
    if name not in _RESNETS:
        raise MXNetError(
            "Model %s is not supported. Available options are\n\t%s"
            % (name, "\n\t".join(sorted(_RESNETS))))
    return _RESNETS[name](**kwargs)
