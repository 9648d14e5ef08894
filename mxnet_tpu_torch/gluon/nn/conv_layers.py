"""Convolution and pooling layers of the port: Conv2D, MaxPool2D,
GlobalAvgPool2D in NCHW and NHWC (counterpart of
``mxnet_tpu/gluon/nn/conv_layers.py``).  The conv weight is
(Co, Ci/g, kh, kw) in every layout."""
from __future__ import annotations

from ..block import HybridBlock

__all__ = ["Conv2D", "MaxPool2D", "GlobalAvgPool2D"]


def _tup(x, n):
    if isinstance(x, (list, tuple)):
        return tuple(x)
    return (x,) * n


class Conv2D(HybridBlock):
    def __init__(self, channels, kernel_size, strides=(1, 1), padding=(0, 0),
                 dilation=(1, 1), groups=1, layout="NCHW", use_bias=True,
                 weight_initializer=None, in_channels=0, prefix=None,
                 params=None):
        super().__init__(prefix, params)
        kernel_size = _tup(kernel_size, 2)
        self._kwargs = {
            "kernel": kernel_size, "stride": _tup(strides, 2),
            "dilate": _tup(dilation, 2), "pad": _tup(padding, 2),
            "num_filter": channels, "num_group": groups,
            "no_bias": not use_bias, "layout": layout}
        self.weight = self._param(
            "weight", (channels, in_channels // groups) + kernel_size,
            weight_initializer)
        self.bias = self._param("bias", (channels,), "zeros") \
            if use_bias else None

    def hybrid_forward(self, F, x):
        return F.convolution(x, self.weight, self.bias, **self._kwargs)


class MaxPool2D(HybridBlock):
    def __init__(self, pool_size=(2, 2), strides=None, padding=0,
                 layout="NCHW", prefix=None, params=None):
        super().__init__(prefix, params)
        pool_size = _tup(pool_size, 2)
        self._kwargs = {"kernel": pool_size,
                        "stride": _tup(strides, 2) if strides else pool_size,
                        "pad": _tup(padding, 2), "pool_type": "max",
                        "layout": layout}

    def hybrid_forward(self, F, x):
        return F.pooling(x, **self._kwargs)


class GlobalAvgPool2D(HybridBlock):
    def __init__(self, layout="NCHW", prefix=None, params=None):
        super().__init__(prefix, params)
        self._layout = layout

    def hybrid_forward(self, F, x):
        return F.pooling(x, pool_type="avg", global_pool=True,
                         layout=self._layout)
