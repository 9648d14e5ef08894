"""MobileNet v1/v2 (counterpart of
``mxnet_tpu/gluon/model_zoo/vision/mobilenet.py``, ref:
python/mxnet/gluon/model_zoo/vision/mobilenet.py).

The architecture and the child names equal the JAX package's, so
weights carry across through ``.params`` files.  Every layer is given
its input channels, so nothing is deferred; a
depthwise convolution is ``Conv2D(groups=channels)``.  ReLU6 is
``F.clip(x, 0, 6)``.
"""
from __future__ import annotations

from ...block import HybridBlock
from ... import nn

__all__ = ["MobileNet", "MobileNetV2", "mobilenet1_0", "mobilenet0_75",
           "mobilenet0_5", "mobilenet0_25", "mobilenet_v2_1_0",
           "mobilenet_v2_0_75", "mobilenet_v2_0_5", "mobilenet_v2_0_25"]


def _add_conv(out, in_channels, channels=1, kernel=1, stride=1, pad=0,
              num_group=1, active=True, relu6=False):
    out.add(nn.Conv2D(channels, kernel, stride, pad, groups=num_group,
                      use_bias=False, in_channels=in_channels))
    out.add(nn.BatchNorm(scale=True, in_channels=channels))
    if active:
        out.add(nn.Activation("relu") if not relu6 else _ReLU6())


class _ReLU6(HybridBlock):
    def hybrid_forward(self, F, x):
        return F.clip(x, a_min=0, a_max=6)


def _add_conv_dw(out, dw_channels, channels, stride, relu6=False):
    _add_conv(out, dw_channels, dw_channels, kernel=3, stride=stride, pad=1,
              num_group=dw_channels, relu6=relu6)
    _add_conv(out, dw_channels, channels, relu6=relu6)


class LinearBottleneck(HybridBlock):
    def __init__(self, in_channels, channels, t, stride, **kwargs):
        super().__init__(**kwargs)
        self.use_shortcut = stride == 1 and in_channels == channels
        mid = in_channels * t
        self.out = nn.HybridSequential()
        _add_conv(self.out, in_channels, mid, relu6=True)
        _add_conv(self.out, mid, mid, kernel=3, stride=stride, pad=1,
                  num_group=mid, relu6=True)
        _add_conv(self.out, mid, channels, active=False, relu6=True)

    def hybrid_forward(self, F, x):
        out = self.out(x)
        if self.use_shortcut:
            out = out + x
        return out


class MobileNet(HybridBlock):
    def __init__(self, multiplier=1.0, classes=1000, **kwargs):
        super().__init__(**kwargs)
        self._arch = {"name": "MobileNet", "kwargs": {
            "multiplier": multiplier, "classes": classes}}
        self.features = nn.HybridSequential(prefix="")
        first = int(32 * multiplier)
        _add_conv(self.features, 3, first, kernel=3, stride=2, pad=1)
        dw_channels = [int(x * multiplier) for x in
                       [32, 64] + [128] * 2 + [256] * 2 + [512] * 6 + [1024]]
        channels = [int(x * multiplier) for x in
                    [64] + [128] * 2 + [256] * 2 + [512] * 6 + [1024] * 2]
        strides = [1, 2, 1, 2, 1, 2, 1, 1, 1, 1, 1, 2, 1]
        for dwc, c, s in zip(dw_channels, channels, strides):
            _add_conv_dw(self.features, dwc, c, s)
        self.features.add(nn.GlobalAvgPool2D())
        self.features.add(nn.Flatten())
        self.output = nn.Dense(classes, in_units=channels[-1])

    def hybrid_forward(self, F, x):
        return self.output(self.features(x))


class MobileNetV2(HybridBlock):
    def __init__(self, multiplier=1.0, classes=1000, **kwargs):
        super().__init__(**kwargs)
        self._arch = {"name": "MobileNetV2", "kwargs": {
            "multiplier": multiplier, "classes": classes}}
        self.features = nn.HybridSequential(prefix="features_")
        first = int(32 * multiplier)
        _add_conv(self.features, 3, first, kernel=3, stride=2, pad=1,
                  relu6=True)
        in_channels_group = [int(x * multiplier) for x in
                             [32] + [16] + [24] * 2 + [32] * 3
                             + [64] * 4 + [96] * 3 + [160] * 3]
        channels_group = [int(x * multiplier) for x in
                          [16] + [24] * 2 + [32] * 3 + [64] * 4
                          + [96] * 3 + [160] * 3 + [320]]
        ts = [1] + [6] * 16
        strides = [1, 2, 1, 2, 1, 1, 2, 1, 1, 1, 1, 1, 1, 2, 1, 1, 1]
        for in_c, c, t, s in zip(in_channels_group, channels_group, ts,
                                 strides):
            self.features.add(LinearBottleneck(in_channels=in_c, channels=c,
                                               t=t, stride=s))
        last_channels = int(1280 * multiplier) if multiplier > 1.0 else 1280
        _add_conv(self.features, channels_group[-1], last_channels,
                  relu6=True)
        self.features.add(nn.GlobalAvgPool2D())
        self.output = nn.HybridSequential(prefix="output_")
        self.output.add(nn.Conv2D(classes, 1, use_bias=False,
                                  in_channels=last_channels, prefix="pred_"),
                        nn.Flatten())

    def hybrid_forward(self, F, x):
        return self.output(self.features(x))


def mobilenet1_0(**kwargs):
    return MobileNet(1.0, **kwargs)


def mobilenet0_75(**kwargs):
    return MobileNet(0.75, **kwargs)


def mobilenet0_5(**kwargs):
    return MobileNet(0.5, **kwargs)


def mobilenet0_25(**kwargs):
    return MobileNet(0.25, **kwargs)


def mobilenet_v2_1_0(**kwargs):
    return MobileNetV2(1.0, **kwargs)


def mobilenet_v2_0_75(**kwargs):
    return MobileNetV2(0.75, **kwargs)


def mobilenet_v2_0_5(**kwargs):
    return MobileNetV2(0.5, **kwargs)


def mobilenet_v2_0_25(**kwargs):
    return MobileNetV2(0.25, **kwargs)
