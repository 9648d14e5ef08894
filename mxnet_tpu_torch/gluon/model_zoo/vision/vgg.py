"""VGG 11/13/16/19 and their BatchNorm forms (counterpart of
``mxnet_tpu/gluon/model_zoo/vision/vgg.py``, ref:
python/mxnet/gluon/model_zoo/vision/vgg.py).  Child and parameter names
equal the JAX package's; the input widths are deferred to the first
forward, as there."""
from __future__ import annotations

from ....base import MXNetError
from ...block import HybridBlock
from ... import nn

__all__ = ["VGG", "vgg11", "vgg13", "vgg16", "vgg19", "vgg11_bn", "vgg13_bn",
           "vgg16_bn", "vgg19_bn", "get_vgg"]


class VGG(HybridBlock):
    def __init__(self, layers, filters, classes=1000, batch_norm=False,
                 **kwargs):
        super().__init__(**kwargs)
        assert len(layers) == len(filters)
        self._arch = {"name": "VGG", "kwargs": {
            "layers": list(layers), "filters": list(filters),
            "classes": classes, "batch_norm": batch_norm}}
        self.features = nn.HybridSequential(prefix="")
        for i, num in enumerate(layers):
            for _ in range(num):
                self.features.add(nn.Conv2D(filters[i], kernel_size=3,
                                            padding=1,
                                            weight_initializer="xavier"))
                if batch_norm:
                    self.features.add(nn.BatchNorm())
                self.features.add(nn.Activation("relu"))
            self.features.add(nn.MaxPool2D(strides=2))
        self.features.add(nn.Dense(4096, activation="relu",
                                   weight_initializer="normal"))
        self.features.add(nn.Dropout(rate=0.5))
        self.features.add(nn.Dense(4096, activation="relu",
                                   weight_initializer="normal"))
        self.features.add(nn.Dropout(rate=0.5))
        self.output = nn.Dense(classes, weight_initializer="normal")

    def hybrid_forward(self, F, x):
        return self.output(self.features(x))


vgg_spec = {11: ([1, 1, 2, 2, 2], [64, 128, 256, 512, 512]),
            13: ([2, 2, 2, 2, 2], [64, 128, 256, 512, 512]),
            16: ([2, 2, 3, 3, 3], [64, 128, 256, 512, 512]),
            19: ([2, 2, 4, 4, 4], [64, 128, 256, 512, 512])}


def get_vgg(num_layers, pretrained=False, ctx=None, root=None, **kwargs):
    if num_layers not in vgg_spec:
        raise MXNetError(f"invalid vgg depth {num_layers}")
    layers, filters = vgg_spec[num_layers]
    return VGG(layers, filters, **kwargs)


def vgg11(**kwargs):
    return get_vgg(11, **kwargs)


def vgg13(**kwargs):
    return get_vgg(13, **kwargs)


def vgg16(**kwargs):
    return get_vgg(16, **kwargs)


def vgg19(**kwargs):
    return get_vgg(19, **kwargs)


def vgg11_bn(**kwargs):
    return get_vgg(11, batch_norm=True, **kwargs)


def vgg13_bn(**kwargs):
    return get_vgg(13, batch_norm=True, **kwargs)


def vgg16_bn(**kwargs):
    return get_vgg(16, batch_norm=True, **kwargs)


def vgg19_bn(**kwargs):
    return get_vgg(19, batch_norm=True, **kwargs)
