"""ResNet V1 and V2 (counterpart of
``mxnet_tpu/gluon/model_zoo/vision/resnet.py``, ref:
python/mxnet/gluon/model_zoo/vision/resnet.py).

The architecture, child names and parameter names equal the JAX
package's, so weights carry across through ``.params`` files.  Every
channel count is passed explicitly, so no parameter is deferred.

MXNET_FUSED_CONVBN=1 reroutes the V1 residual blocks, when they run
hybridized in NHWC, through the fused Conv+BN+ReLU unit
(``ops/fused_convbn.py``, a CUDA kernel on the card): each conv reads its
predecessor's RAW output and applies the BatchNorm affine + ReLU while
reading, and BN statistics come out of the conv epilogue.  The C-sized
BN algebra — with the conv1/conv3 bias quirk of the gluon zoo
bottleneck — is the JAX package's.  In training the unit's backward is
the fused backward kernel under MXNET_FUSED_CONVBN_BWD=1 (stride-1
units) and the dgrad/wgrad convolutions otherwise.  V2 (pre-activation)
blocks have no fused path, as in the JAX package: they run op-granular.
The V2 stem starts with ``BatchNorm(scale=False, center=False)``, whose
gamma and beta exist but are never trained (``requires_grad`` off, the
JAX package's ``grad_req="null"``).
"""
from __future__ import annotations

import torch

from ....base import MXNetError
from ....parallel.mesh import batch_shards
from ....util import env
from ...block import HybridBlock, current_trace
from ... import nn

__all__ = ["ResNetV1", "ResNetV2", "BasicBlockV1", "BasicBlockV2",
           "BottleneckV1", "BottleneckV2", "resnet18_v1", "resnet34_v1",
           "resnet50_v1", "resnet101_v1", "resnet152_v1", "resnet18_v2",
           "resnet34_v2", "resnet50_v2", "resnet101_v2", "resnet152_v2",
           "get_resnet"]


def _fused_convbn_active(layout):
    """The fused path is an opt-in NHWC path inside a trace scope
    (``hybridize()``); MXNET_BN_EXACT_VAR=1 keeps the op-granular path,
    whose exact two-pass variance the fused statistics cannot give."""
    return (layout == "NHWC"
            and env.get_bool("MXNET_FUSED_CONVBN")
            and not env.get_bool("MXNET_BN_EXACT_VAR")
            and current_trace() is not None)


def _fused_unit(F, ts, x, conv, bn, in_scale, in_bias, act_in, train):
    """One fused conv step + this BN's C-sized affine math.

    Returns (y_raw, scale, bias) where `scale`/`bias` map y_raw to the
    normalized activation (conv bias folded in: y_raw*scale + bias ==
    BN(conv_out + conv_bias)); updates the running statistics in place
    in training mode.
    """
    kw = conv._kwargs
    cb = None if kw.get("no_bias") else conv._value("bias")
    rm, rv = bn._value("running_mean"), bn._value("running_var")
    sdt = rm.dtype
    gamma = bn._value("gamma")
    g = gamma.to(sdt) if bn._scale else torch.ones_like(gamma, dtype=sdt)
    cbf = cb.to(sdt) if cb is not None else None
    want_stats = train and not bn._use_global_stats
    # shift stays exactly the running mean; the conv bias enters through
    # the C-sized algebra below, never through the kernel's shift.  In
    # training the kernel gets a snapshot: rm is updated in place below,
    # and the backward must fold dy_tot with the mean the forward used
    # (the JAX package applies the update after the step, spmd.py:514)
    shift = rm.clone() if want_stats else rm
    y, s1, s2 = F.fused_conv_unit(
        x, conv._value("weight"), in_scale, in_bias, shift,
        kernel=kw["kernel"], stride=kw["stride"], pad=kw["pad"],
        act_in=act_in, want_stats=want_stats)
    if want_stats:
        # s1/s2 are sums over the global batch (over every rank under a
        # data-parallel mesh), so n counts every rank's rows
        n = y.numel() // y.shape[-1] * batch_shards()
        mean = s1 / n + (cbf if cbf is not None else 0.0)  # mean of y_full
        dm = mean - rm
        raw = s2 / n
        if cbf is not None:
            # E[(y+cb-rm)^2] = E[(y-rm)^2] + 2cb·E[y-rm] + cb^2
            raw = raw + 2.0 * cbf * (s1 / n - rm) + cbf * cbf
        # same shifted single-pass variance + relative floor as batch_norm
        var = torch.maximum(raw - dm * dm, 1e-6 * raw)
        unbiased = var * (n / max(n - 1, 1))
        mom = bn._momentum
        with torch.no_grad():
            rm.copy_(mom * rm + (1 - mom) * mean)
            rv.copy_(mom * rv + (1 - mom) * unbiased)
    else:
        mean, var = rm, rv
    scale = g * torch.rsqrt(var + bn._epsilon)
    bias = bn._value("beta").to(sdt) + (
        (cbf if cbf is not None else 0.0) - mean) * scale
    return y, scale, bias


def _conv3x3(channels, stride, in_channels, layout="NCHW"):
    return nn.Conv2D(channels, kernel_size=3, strides=stride, padding=1,
                     use_bias=False, in_channels=in_channels, layout=layout)


def _bn(channels, layout, **kwargs):
    return nn.BatchNorm(axis=3 if layout == "NHWC" else 1,
                        in_channels=channels, **kwargs)


def _residual_out(y, scale, bias, shortcut, dtype):
    return torch.clamp_min(y.float() * scale + bias + shortcut,
                           0.0).to(dtype)


class BasicBlockV1(HybridBlock):
    def __init__(self, channels, stride, downsample=False, in_channels=0,
                 layout="NCHW", **kwargs):
        super().__init__(**kwargs)
        self._layout = layout
        self.body = nn.HybridSequential(prefix="")
        self.body.add(_conv3x3(channels, stride, in_channels, layout))
        self.body.add(_bn(channels, layout))
        self.body.add(nn.Activation("relu"))
        self.body.add(_conv3x3(channels, 1, channels, layout))
        self.body.add(_bn(channels, layout))
        if downsample:
            self.downsample = nn.HybridSequential(prefix="")
            self.downsample.add(nn.Conv2D(channels, kernel_size=1,
                                          strides=stride, use_bias=False,
                                          in_channels=in_channels,
                                          layout=layout))
            self.downsample.add(_bn(channels, layout))
        else:
            self.downsample = None

    def hybrid_forward(self, F, x):
        if _fused_convbn_active(self._layout):
            return self._fused_forward(F, x)
        residual = x
        x = self.body(x)
        if self.downsample is not None:
            residual = self.downsample(residual)
        return F.activation(residual + x, act_type="relu")

    def _fused_forward(self, F, x):
        ts = current_trace()
        train = ts.train
        b = self.body  # conv1, bn1, relu, conv2, bn2
        y1, sc1, bi1 = _fused_unit(F, ts, x, b[0], b[1], None, None,
                                   False, train)
        y2, sc2, bi2 = _fused_unit(F, ts, y1, b[3], b[4], sc1, bi1,
                                   True, train)
        if self.downsample is not None:
            yd, scd, bid = _fused_unit(F, ts, x, self.downsample[0],
                                       self.downsample[1], None, None,
                                       False, train)
            shortcut = yd.float() * scd + bid
        else:
            shortcut = x.float()
        return _residual_out(y2, sc2, bi2, shortcut, x.dtype)


class BottleneckV1(HybridBlock):
    def __init__(self, channels, stride, downsample=False, in_channels=0,
                 layout="NCHW", **kwargs):
        super().__init__(**kwargs)
        self._layout = layout
        mid = channels // 4
        self.body = nn.HybridSequential(prefix="")
        self.body.add(nn.Conv2D(mid, kernel_size=1, strides=stride,
                                in_channels=in_channels, layout=layout))
        self.body.add(_bn(mid, layout))
        self.body.add(nn.Activation("relu"))
        self.body.add(_conv3x3(mid, 1, mid, layout))
        self.body.add(_bn(mid, layout))
        self.body.add(nn.Activation("relu"))
        self.body.add(nn.Conv2D(channels, kernel_size=1, strides=1,
                                in_channels=mid, layout=layout))
        self.body.add(_bn(channels, layout))
        if downsample:
            self.downsample = nn.HybridSequential(prefix="")
            self.downsample.add(nn.Conv2D(channels, kernel_size=1,
                                          strides=stride, use_bias=False,
                                          in_channels=in_channels,
                                          layout=layout))
            self.downsample.add(_bn(channels, layout))
        else:
            self.downsample = None

    def hybrid_forward(self, F, x):
        if _fused_convbn_active(self._layout):
            return self._fused_forward(F, x)
        residual = x
        x = self.body(x)
        if self.downsample is not None:
            residual = self.downsample(residual)
        return F.activation(x + residual, act_type="relu")

    def _fused_forward(self, F, x):
        ts = current_trace()
        train = ts.train
        b = self.body  # conv1, bn1, relu, conv2, bn2, relu, conv3, bn3
        y1, sc1, bi1 = _fused_unit(F, ts, x, b[0], b[1], None, None,
                                   False, train)
        y2, sc2, bi2 = _fused_unit(F, ts, y1, b[3], b[4], sc1, bi1,
                                   True, train)
        y3, sc3, bi3 = _fused_unit(F, ts, y2, b[6], b[7], sc2, bi2,
                                   True, train)
        if self.downsample is not None:
            yd, scd, bid = _fused_unit(F, ts, x, self.downsample[0],
                                       self.downsample[1], None, None,
                                       False, train)
            shortcut = yd.float() * scd + bid
        else:
            shortcut = x.float()
        return _residual_out(y3, sc3, bi3, shortcut, x.dtype)


class BasicBlockV2(HybridBlock):
    def __init__(self, channels, stride, downsample=False, in_channels=0,
                 layout="NCHW", **kwargs):
        super().__init__(**kwargs)
        self.bn1 = _bn(in_channels, layout)
        self.conv1 = _conv3x3(channels, stride, in_channels, layout)
        self.bn2 = _bn(channels, layout)
        self.conv2 = _conv3x3(channels, 1, channels, layout)
        if downsample:
            self.downsample = nn.Conv2D(channels, 1, stride, use_bias=False,
                                        in_channels=in_channels,
                                        layout=layout)
        else:
            self.downsample = None

    def hybrid_forward(self, F, x):
        residual = x
        x = F.activation(self.bn1(x), act_type="relu")
        if self.downsample is not None:
            residual = self.downsample(x)
        x = self.conv1(x)
        x = F.activation(self.bn2(x), act_type="relu")
        x = self.conv2(x)
        return x + residual


class BottleneckV2(HybridBlock):
    def __init__(self, channels, stride, downsample=False, in_channels=0,
                 layout="NCHW", **kwargs):
        super().__init__(**kwargs)
        mid = channels // 4
        self.bn1 = _bn(in_channels, layout)
        self.conv1 = nn.Conv2D(mid, kernel_size=1, strides=1, use_bias=False,
                               in_channels=in_channels, layout=layout)
        self.bn2 = _bn(mid, layout)
        self.conv2 = _conv3x3(mid, stride, mid, layout)
        self.bn3 = _bn(mid, layout)
        self.conv3 = nn.Conv2D(channels, kernel_size=1, strides=1,
                               use_bias=False, in_channels=mid,
                               layout=layout)
        if downsample:
            self.downsample = nn.Conv2D(channels, 1, stride, use_bias=False,
                                        in_channels=in_channels,
                                        layout=layout)
        else:
            self.downsample = None

    def hybrid_forward(self, F, x):
        residual = x
        x = F.activation(self.bn1(x), act_type="relu")
        if self.downsample is not None:
            residual = self.downsample(x)
        x = self.conv1(x)
        x = F.activation(self.bn2(x), act_type="relu")
        x = self.conv2(x)
        x = F.activation(self.bn3(x), act_type="relu")
        x = self.conv3(x)
        return x + residual


class ResNetV1(HybridBlock):
    def __init__(self, block, layers, channels, classes=1000, thumbnail=False,
                 layout="NCHW", **kwargs):
        super().__init__(**kwargs)
        assert len(layers) == len(channels) - 1
        self._layout = layout
        # what contrib.deploy records to rebuild this network
        self._arch = {"name": "ResNetV1", "kwargs": {
            "block": block.__name__, "layers": list(layers),
            "channels": list(channels), "classes": classes,
            "thumbnail": thumbnail, "layout": layout}}
        self.features = nn.HybridSequential(prefix="")
        if thumbnail:
            self.features.add(_conv3x3(channels[0], 1, 3, layout))
        else:
            self.features.add(nn.Conv2D(channels[0], 7, 2, 3, use_bias=False,
                                        in_channels=3, layout=layout))
            self.features.add(_bn(channels[0], layout))
            self.features.add(nn.Activation("relu"))
            self.features.add(nn.MaxPool2D(3, 2, 1, layout=layout))
        for i, num_layer in enumerate(layers):
            stride = 1 if i == 0 else 2
            self.features.add(_make_layer(block, num_layer, channels[i + 1],
                                          stride, channels[i], layout))
        self.features.add(nn.GlobalAvgPool2D(layout=layout))
        self.output = nn.Dense(classes, in_units=channels[-1])

    def hybrid_forward(self, F, x):
        x = self.features(x)
        x = self.output(x)
        return x


def _make_layer(block, layers, channels, stride, in_channels, layout):
    layer = nn.HybridSequential(prefix="")
    layer.add(block(channels, stride, channels != in_channels,
                    in_channels=in_channels, layout=layout, prefix=""))
    for _ in range(layers - 1):
        layer.add(block(channels, 1, False, in_channels=channels,
                        layout=layout, prefix=""))
    return layer


class ResNetV2(HybridBlock):
    def __init__(self, block, layers, channels, classes=1000, thumbnail=False,
                 layout="NCHW", **kwargs):
        super().__init__(**kwargs)
        assert len(layers) == len(channels) - 1
        self._layout = layout
        self._arch = {"name": "ResNetV2", "kwargs": {
            "block": block.__name__, "layers": list(layers),
            "channels": list(channels), "classes": classes,
            "thumbnail": thumbnail, "layout": layout}}
        self.features = nn.HybridSequential(prefix="")
        self.features.add(_bn(3, layout, scale=False, center=False))
        if thumbnail:
            self.features.add(_conv3x3(channels[0], 1, 3, layout))
        else:
            self.features.add(nn.Conv2D(channels[0], 7, 2, 3, use_bias=False,
                                        in_channels=3, layout=layout))
            self.features.add(_bn(channels[0], layout))
            self.features.add(nn.Activation("relu"))
            self.features.add(nn.MaxPool2D(3, 2, 1, layout=layout))
        in_channels = channels[0]
        for i, num_layer in enumerate(layers):
            stride = 1 if i == 0 else 2
            self.features.add(_make_layer(block, num_layer, channels[i + 1],
                                          stride, in_channels, layout))
            in_channels = channels[i + 1]
        self.features.add(_bn(in_channels, layout))
        self.features.add(nn.Activation("relu"))
        self.features.add(nn.GlobalAvgPool2D(layout=layout))
        self.features.add(nn.Flatten())
        self.output = nn.Dense(classes, in_units=in_channels)

    def hybrid_forward(self, F, x):
        return self.output(self.features(x))


resnet_spec = {
    18: ("basic_block", [2, 2, 2, 2], [64, 64, 128, 256, 512]),
    34: ("basic_block", [3, 4, 6, 3], [64, 64, 128, 256, 512]),
    50: ("bottle_neck", [3, 4, 6, 3], [64, 256, 512, 1024, 2048]),
    101: ("bottle_neck", [3, 4, 23, 3], [64, 256, 512, 1024, 2048]),
    152: ("bottle_neck", [3, 8, 36, 3], [64, 256, 512, 1024, 2048]),
}
BLOCKS = {"BasicBlockV1": BasicBlockV1, "BottleneckV1": BottleneckV1,
          "BasicBlockV2": BasicBlockV2, "BottleneckV2": BottleneckV2}
_VERSIONS = {1: (ResNetV1, {"basic_block": BasicBlockV1,
                            "bottle_neck": BottleneckV1}),
             2: (ResNetV2, {"basic_block": BasicBlockV2,
                            "bottle_neck": BottleneckV2})}


def get_resnet(version, num_layers, pretrained=False, ctx=None, root=None,
               **kwargs):
    if version not in _VERSIONS:
        raise MXNetError(f"invalid resnet version {version}; options: 1, 2")
    if num_layers not in resnet_spec:
        raise MXNetError(f"invalid resnet depth {num_layers}; "
                         f"options: {sorted(resnet_spec)}")
    if pretrained:
        raise MXNetError("pretrained weights are unavailable in this "
                         "offline build; load_parameters() from a local file")
    block_type, layers, channels = resnet_spec[num_layers]
    net_class, blocks = _VERSIONS[version]
    net = net_class(blocks[block_type], layers, channels, **kwargs)
    net._arch = {"name": f"resnet{num_layers}_v{version}",
                 "kwargs": dict(kwargs)}
    return net


def resnet18_v1(**kwargs):
    return get_resnet(1, 18, **kwargs)


def resnet34_v1(**kwargs):
    return get_resnet(1, 34, **kwargs)


def resnet50_v1(**kwargs):
    return get_resnet(1, 50, **kwargs)


def resnet101_v1(**kwargs):
    return get_resnet(1, 101, **kwargs)


def resnet152_v1(**kwargs):
    return get_resnet(1, 152, **kwargs)


def resnet18_v2(**kwargs):
    return get_resnet(2, 18, **kwargs)


def resnet34_v2(**kwargs):
    return get_resnet(2, 34, **kwargs)


def resnet50_v2(**kwargs):
    return get_resnet(2, 50, **kwargs)


def resnet101_v2(**kwargs):
    return get_resnet(2, 101, **kwargs)


def resnet152_v2(**kwargs):
    return get_resnet(2, 152, **kwargs)
