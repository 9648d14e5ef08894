"""Inception V3 (counterpart of
``mxnet_tpu/gluon/model_zoo/vision/inception.py``, ref:
python/mxnet/gluon/model_zoo/vision/inception.py), for 299x299 NCHW
inputs.  A mixed block runs its branches side by side and concatenates
them on the channels (``F.concat``); its average-pool branch counts the
padding (``count_include_pad``, the default).  Child and parameter names
equal the JAX package's; the input widths are deferred to the first
forward, as there."""
from __future__ import annotations

from ...block import HybridBlock
from ... import nn

__all__ = ["Inception3", "inception_v3"]


def _make_basic_conv(**kwargs):
    out = nn.HybridSequential(prefix="")
    out.add(nn.Conv2D(use_bias=False, **kwargs))
    out.add(nn.BatchNorm(epsilon=0.001))
    out.add(nn.Activation("relu"))
    return out


_SETTINGS = ("channels", "kernel_size", "strides", "padding")


def _make_branch(use_pool, *conv_settings):
    out = nn.HybridSequential(prefix="")
    if use_pool == "avg":
        out.add(nn.AvgPool2D(pool_size=3, strides=1, padding=1))
    elif use_pool == "max":
        out.add(nn.MaxPool2D(pool_size=3, strides=2))
    for setting in conv_settings:
        out.add(_make_basic_conv(**{n: v for n, v in zip(_SETTINGS, setting)
                                    if v is not None}))
    return out


class _Concurrent(HybridBlock):
    """Parallel branches concatenated on channels."""

    def add(self, block):
        self.register_child(block)

    def hybrid_forward(self, F, x):
        return F.concat(*[c(x) for c in self._modules.values()], dim=1)


def _concurrent(prefix, *branches):
    out = _Concurrent(prefix=prefix)
    for b in branches:
        out.add(b)
    return out


def _make_A(pool_features, prefix):
    return _concurrent(
        prefix,
        _make_branch(None, (64, 1, None, None)),
        _make_branch(None, (48, 1, None, None), (64, 5, None, 2)),
        _make_branch(None, (64, 1, None, None), (96, 3, None, 1),
                     (96, 3, None, 1)),
        _make_branch("avg", (pool_features, 1, None, None)))


def _make_B(prefix):
    return _concurrent(
        prefix,
        _make_branch(None, (384, 3, 2, None)),
        _make_branch(None, (64, 1, None, None), (96, 3, None, 1),
                     (96, 3, 2, None)),
        _make_branch("max"))


def _make_C(channels_7x7, prefix):
    c7 = channels_7x7
    return _concurrent(
        prefix,
        _make_branch(None, (192, 1, None, None)),
        _make_branch(None, (c7, 1, None, None), (c7, (1, 7), None, (0, 3)),
                     (192, (7, 1), None, (3, 0))),
        _make_branch(None, (c7, 1, None, None), (c7, (7, 1), None, (3, 0)),
                     (c7, (1, 7), None, (0, 3)), (c7, (7, 1), None, (3, 0)),
                     (192, (1, 7), None, (0, 3))),
        _make_branch("avg", (192, 1, None, None)))


def _make_D(prefix):
    return _concurrent(
        prefix,
        _make_branch(None, (192, 1, None, None), (320, 3, 2, None)),
        _make_branch(None, (192, 1, None, None), (192, (1, 7), None, (0, 3)),
                     (192, (7, 1), None, (3, 0)), (192, 3, 2, None)),
        _make_branch("max"))


class _SplitConcat(HybridBlock):
    def __init__(self, trunk, b1a, b1b, **kwargs):
        super().__init__(**kwargs)
        self.trunk = trunk
        self.b1a = b1a
        self.b1b = b1b

    def hybrid_forward(self, F, x):
        t = self.trunk(x)
        return F.concat(self.b1a(t), self.b1b(t), dim=1)


def _make_E(prefix):
    return _concurrent(
        prefix,
        _make_branch(None, (320, 1, None, None)),
        _SplitConcat(_make_branch(None, (384, 1, None, None)),
                     _make_branch(None, (384, (1, 3), None, (0, 1))),
                     _make_branch(None, (384, (3, 1), None, (1, 0)))),
        _SplitConcat(_make_branch(None, (448, 1, None, None),
                                  (384, 3, None, 1)),
                     _make_branch(None, (384, (1, 3), None, (0, 1))),
                     _make_branch(None, (384, (3, 1), None, (1, 0)))),
        _make_branch("avg", (192, 1, None, None)))


class Inception3(HybridBlock):
    def __init__(self, classes=1000, **kwargs):
        super().__init__(**kwargs)
        self._arch = {"name": "Inception3", "kwargs": {"classes": classes}}
        self.features = nn.HybridSequential(prefix="")
        self.features.add(_make_basic_conv(channels=32, kernel_size=3,
                                           strides=2))
        self.features.add(_make_basic_conv(channels=32, kernel_size=3))
        self.features.add(_make_basic_conv(channels=64, kernel_size=3,
                                           padding=1))
        self.features.add(nn.MaxPool2D(pool_size=3, strides=2))
        self.features.add(_make_basic_conv(channels=80, kernel_size=1))
        self.features.add(_make_basic_conv(channels=192, kernel_size=3))
        self.features.add(nn.MaxPool2D(pool_size=3, strides=2))
        self.features.add(_make_A(32, "A1_"))
        self.features.add(_make_A(64, "A2_"))
        self.features.add(_make_A(64, "A3_"))
        self.features.add(_make_B("B_"))
        self.features.add(_make_C(128, "C1_"))
        self.features.add(_make_C(160, "C2_"))
        self.features.add(_make_C(160, "C3_"))
        self.features.add(_make_C(192, "C4_"))
        self.features.add(_make_D("D_"))
        self.features.add(_make_E("E1_"))
        self.features.add(_make_E("E2_"))
        self.features.add(nn.AvgPool2D(pool_size=8))
        self.features.add(nn.Dropout(0.5))
        self.output = nn.Dense(classes)

    def hybrid_forward(self, F, x):
        return self.output(self.features(x))


def inception_v3(pretrained=False, ctx=None, root=None, **kwargs):
    return Inception3(**kwargs)
