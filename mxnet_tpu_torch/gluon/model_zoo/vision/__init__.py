"""Vision model zoo of the port (counterpart of
``mxnet_tpu/gluon/model_zoo/vision``): the JAX package's 34 names —
ResNet V1/V2, VGG, AlexNet, MobileNet v1/v2, SqueezeNet, DenseNet and
Inception V3.  Every network carries an ``_arch`` record that
:func:`build` rebuilds it from (what ``contrib.deploy`` stores)."""
from __future__ import annotations

from ....base import MXNetError
from .resnet import *  # noqa: F401,F403
from . import resnet
from .resnet import (BLOCKS, ResNetV1, ResNetV2, resnet18_v1, resnet34_v1,
                     resnet50_v1, resnet101_v1, resnet152_v1, resnet18_v2,
                     resnet34_v2, resnet50_v2, resnet101_v2, resnet152_v2)
from .alexnet import AlexNet, alexnet
from .vgg import (VGG, vgg11, vgg13, vgg16, vgg19, vgg11_bn, vgg13_bn,
                  vgg16_bn, vgg19_bn)
from .mobilenet import (MobileNet, MobileNetV2, mobilenet0_25, mobilenet0_5,
                        mobilenet0_75, mobilenet1_0, mobilenet_v2_0_25,
                        mobilenet_v2_0_5, mobilenet_v2_0_75, mobilenet_v2_1_0)
from .squeezenet import SqueezeNet, squeezenet1_0, squeezenet1_1
from .densenet import (DenseNet, densenet121, densenet161, densenet169,
                       densenet201)
from .inception import Inception3, inception_v3

_models = {
    "resnet18_v1": resnet18_v1, "resnet34_v1": resnet34_v1,
    "resnet50_v1": resnet50_v1, "resnet101_v1": resnet101_v1,
    "resnet152_v1": resnet152_v1, "resnet18_v2": resnet18_v2,
    "resnet34_v2": resnet34_v2, "resnet50_v2": resnet50_v2,
    "resnet101_v2": resnet101_v2, "resnet152_v2": resnet152_v2,
    "alexnet": alexnet,
    "vgg11": vgg11, "vgg13": vgg13, "vgg16": vgg16, "vgg19": vgg19,
    "vgg11_bn": vgg11_bn, "vgg13_bn": vgg13_bn, "vgg16_bn": vgg16_bn,
    "vgg19_bn": vgg19_bn,
    "mobilenet1.0": mobilenet1_0, "mobilenet0.75": mobilenet0_75,
    "mobilenet0.5": mobilenet0_5, "mobilenet0.25": mobilenet0_25,
    "mobilenetv2_1.0": mobilenet_v2_1_0, "mobilenetv2_0.75": mobilenet_v2_0_75,
    "mobilenetv2_0.5": mobilenet_v2_0_5, "mobilenetv2_0.25": mobilenet_v2_0_25,
    "squeezenet1.0": squeezenet1_0, "squeezenet1.1": squeezenet1_1,
    "densenet121": densenet121, "densenet161": densenet161,
    "densenet169": densenet169, "densenet201": densenet201,
    "inceptionv3": inception_v3,
}

# the classes an ``_arch`` record may name
_CLASSES = {c.__name__: c for c in (ResNetV1, ResNetV2, AlexNet, VGG,
                                    MobileNet, MobileNetV2, SqueezeNet,
                                    DenseNet, Inception3)}


def get_model(name, **kwargs):
    """ref: model_zoo/__init__.py::get_model."""
    name = name.lower()
    if name not in _models:
        raise MXNetError(f"model {name!r} is not in the port's model zoo; "
                         f"available: {sorted(_models)}")
    return _models[name](**kwargs)


def build(arch: dict):
    """Rebuild a network from the record ``{"name", "kwargs"}`` that a zoo
    network keeps in ``_arch``: a zoo name, or a class with its
    arguments (a ResNet's block by its class name)."""
    name, kwargs = arch["name"], dict(arch["kwargs"])
    cls = _CLASSES.get(name)
    if cls is None:
        return get_model(name, **kwargs)
    if name.startswith("ResNet"):
        block = BLOCKS.get(kwargs.pop("block"))
        if block is None:
            raise MXNetError(f"unknown {name} block in {arch}")
        return cls(block, **kwargs)
    return cls(**kwargs)
