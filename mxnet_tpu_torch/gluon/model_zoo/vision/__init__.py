"""Vision model zoo of the port (counterpart of
``mxnet_tpu/gluon/model_zoo/vision``): ResNet V1 and MobileNet v1/v2."""
from __future__ import annotations

from ....base import MXNetError
from .resnet import *  # noqa: F401,F403
from . import resnet
from .resnet import (BLOCKS, ResNetV1, resnet18_v1, resnet34_v1, resnet50_v1,
                     resnet101_v1, resnet152_v1)
from .mobilenet import (MobileNet, MobileNetV2, mobilenet0_25, mobilenet0_5,
                        mobilenet0_75, mobilenet1_0, mobilenet_v2_0_25,
                        mobilenet_v2_0_5, mobilenet_v2_0_75, mobilenet_v2_1_0)

_models = {
    "resnet18_v1": resnet18_v1, "resnet34_v1": resnet34_v1,
    "resnet50_v1": resnet50_v1, "resnet101_v1": resnet101_v1,
    "resnet152_v1": resnet152_v1,
    "mobilenet1.0": mobilenet1_0, "mobilenet0.75": mobilenet0_75,
    "mobilenet0.5": mobilenet0_5, "mobilenet0.25": mobilenet0_25,
    "mobilenetv2_1.0": mobilenet_v2_1_0, "mobilenetv2_0.75": mobilenet_v2_0_75,
    "mobilenetv2_0.5": mobilenet_v2_0_5, "mobilenetv2_0.25": mobilenet_v2_0_25,
}


def get_model(name, **kwargs):
    """ref: model_zoo/__init__.py::get_model."""
    name = name.lower()
    if name not in _models:
        raise MXNetError(f"model {name!r} is not in the port's model zoo; "
                         f"available: {sorted(_models)}")
    return _models[name](**kwargs)


def build(arch: dict):
    """Rebuild a network from the record ``{"name", "kwargs"}`` that a zoo
    network keeps in ``_arch`` (what ``contrib.deploy`` stores)."""
    name, kwargs = arch["name"], dict(arch["kwargs"])
    if name == "ResNetV1":
        block = BLOCKS.get(kwargs.pop("block"))
        if block is None:
            raise MXNetError(f"unknown ResNetV1 block in {arch}")
        return ResNetV1(block, **kwargs)
    return get_model(name, **kwargs)
