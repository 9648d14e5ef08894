"""SqueezeNet 1.0/1.1 (counterpart of
``mxnet_tpu/gluon/model_zoo/vision/squeezenet.py``, ref:
python/mxnet/gluon/model_zoo/vision/squeezenet.py).

Its max pools use ``ceil_mode=True``: MXNet's ``pooling_convention=
"full"`` (``ops/nn.py``'s pooling), an output of ceil((H - k) / s) + 1
windows.  PyTorch's ``ceil_mode`` drops a last window that would start
in the padding; MXNet's keeps it (these pools have no padding, so the
two agree here).  Child and parameter names equal the JAX package's."""
from __future__ import annotations

from ....base import MXNetError
from ...block import HybridBlock
from ... import nn

__all__ = ["SqueezeNet", "squeezenet1_0", "squeezenet1_1"]


def _make_fire(squeeze_channels, expand1x1_channels, expand3x3_channels):
    out = nn.HybridSequential(prefix="")
    out.add(_make_fire_conv(squeeze_channels, 1))
    out.add(_FireExpand(expand1x1_channels, expand3x3_channels))
    return out


def _make_fire_conv(channels, kernel_size, padding=0):
    out = nn.HybridSequential(prefix="")
    out.add(nn.Conv2D(channels, kernel_size, padding=padding))
    out.add(nn.Activation("relu"))
    return out


class _FireExpand(HybridBlock):
    def __init__(self, e1, e3, **kwargs):
        super().__init__(**kwargs)
        self.p1 = _make_fire_conv(e1, 1)
        self.p3 = _make_fire_conv(e3, 3, 1)

    def hybrid_forward(self, F, x):
        return F.concat(self.p1(x), self.p3(x), dim=1)


# (stem conv (channels, kernel), then the fires and pools in order:
# a tuple is a fire's (squeeze, expand 1x1, expand 3x3), "pool" a pool)
_FIRES = {
    "1.0": ((96, 7), [(16, 64, 64), (16, 64, 64), (32, 128, 128), "pool",
                      (32, 128, 128), (48, 192, 192), (48, 192, 192),
                      (64, 256, 256), "pool", (64, 256, 256)]),
    "1.1": ((64, 3), [(16, 64, 64), (16, 64, 64), "pool", (32, 128, 128),
                      (32, 128, 128), "pool", (48, 192, 192),
                      (48, 192, 192), (64, 256, 256), (64, 256, 256)]),
}


class SqueezeNet(HybridBlock):
    def __init__(self, version, classes=1000, **kwargs):
        super().__init__(**kwargs)
        if version not in _FIRES:
            raise MXNetError("version must be 1.0 or 1.1")
        self._arch = {"name": "SqueezeNet",
                      "kwargs": {"version": version, "classes": classes}}
        (stem_c, stem_k), fires = _FIRES[version]
        self.features = nn.HybridSequential(prefix="")
        self.features.add(nn.Conv2D(stem_c, kernel_size=stem_k, strides=2))
        self.features.add(nn.Activation("relu"))
        self.features.add(nn.MaxPool2D(pool_size=3, strides=2,
                                       ceil_mode=True))
        for f in fires:
            if f == "pool":
                self.features.add(nn.MaxPool2D(pool_size=3, strides=2,
                                               ceil_mode=True))
            else:
                self.features.add(_make_fire(*f))
        self.features.add(nn.Dropout(0.5))
        self.output = nn.HybridSequential(prefix="")
        self.output.add(nn.Conv2D(classes, kernel_size=1))
        self.output.add(nn.Activation("relu"))
        self.output.add(nn.GlobalAvgPool2D())
        self.output.add(nn.Flatten())

    def hybrid_forward(self, F, x):
        return self.output(self.features(x))


def squeezenet1_0(**kwargs):
    return SqueezeNet("1.0", **kwargs)


def squeezenet1_1(**kwargs):
    return SqueezeNet("1.1", **kwargs)
