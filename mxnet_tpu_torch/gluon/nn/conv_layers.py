"""Convolution, pooling and padding layers of the port (counterpart of
``mxnet_tpu/gluon/nn/conv_layers.py``): Conv1D/2D/3D, their Transpose
versions, Max/Avg/GlobalMax/GlobalAvg pooling in 1-3 D and
ReflectionPad2D.  The conv weight is (Co, Ci/g, *k), the transposed
conv's (Ci, Co/g, *k), in every layout; ``in_channels=0`` defers Ci to
the first forward."""
from __future__ import annotations

from ..block import HybridBlock
from .basic_layers import Activation

__all__ = ["Conv1D", "Conv2D", "Conv3D", "Conv1DTranspose", "Conv2DTranspose",
           "Conv3DTranspose", "MaxPool1D", "MaxPool2D", "MaxPool3D",
           "AvgPool1D", "AvgPool2D", "AvgPool3D", "GlobalMaxPool1D",
           "GlobalMaxPool2D", "GlobalMaxPool3D", "GlobalAvgPool1D",
           "GlobalAvgPool2D", "GlobalAvgPool3D", "ReflectionPad2D"]


def _tup(x, n):
    if isinstance(x, (list, tuple)):
        return tuple(x)
    return (x,) * n


class _Conv(HybridBlock):
    def __init__(self, channels, kernel_size, strides, padding, dilation,
                 groups, layout, in_channels=0, activation=None,
                 use_bias=True, weight_initializer=None,
                 bias_initializer="zeros", op_name="convolution", adj=None,
                 prefix=None, params=None):
        super().__init__(prefix, params)
        self._channels = channels
        self._op_name = op_name
        self._kwargs = {
            "kernel": kernel_size, "stride": strides, "dilate": dilation,
            "pad": padding, "num_filter": channels, "num_group": groups,
            "no_bias": not use_bias, "layout": layout}
        if adj is not None:
            self._kwargs["adj"] = adj
        if op_name == "convolution":
            wshape = (channels, in_channels // groups) + tuple(kernel_size)
        else:
            wshape = (in_channels, channels // groups) + tuple(kernel_size)
        self.weight = self._param("weight", wshape, weight_initializer,
                                  allow_deferred=True)
        self.bias = self._param("bias", (channels,), bias_initializer) \
            if use_bias else None
        self.act = Activation(activation) if activation is not None else None

    def _infer_param_shapes(self, x, *args):
        layout = self._kwargs["layout"]
        in_c = int(x.shape[1 if layout[1] == "C" else x.dim() - 1])
        w = list(self.weight.shape)
        groups = self._kwargs["num_group"]
        if self._op_name == "convolution":
            w[1] = in_c // groups
        else:
            w[0] = in_c
        self._set_shape("weight", tuple(w))

    def hybrid_forward(self, F, x):
        op = getattr(F, self._op_name)
        out = op(x, self.weight, self.bias, **self._kwargs)
        return self.act(out) if self.act is not None else out


def _conv_class(n, layout, transpose):
    default_k = (1,) * n if n > 1 else 1
    default_0 = (0,) * n if n > 1 else 0

    def __init__(self, channels, kernel_size, strides=default_k,
                 padding=default_0, *rest, **kw):
        # the JAX package's positional order: (output_padding,) dilation,
        # groups, layout, activation, use_bias, weight_initializer,
        # bias_initializer, in_channels, prefix, params
        names = (("output_padding",) if transpose else ()) + (
            "dilation", "groups", "layout", "activation", "use_bias",
            "weight_initializer", "bias_initializer", "in_channels",
            "prefix", "params")
        kw.update(zip(names, rest))
        adj = _tup(kw.pop("output_padding", default_0), n) if transpose \
            else None
        _Conv.__init__(
            self, channels, _tup(kernel_size, n), _tup(strides, n),
            _tup(padding, n), _tup(kw.pop("dilation", default_k), n),
            kw.pop("groups", 1), kw.pop("layout", layout),
            kw.pop("in_channels", 0), kw.pop("activation", None),
            kw.pop("use_bias", True), kw.pop("weight_initializer", None),
            kw.pop("bias_initializer", "zeros"),
            op_name="deconvolution" if transpose else "convolution",
            adj=adj, prefix=kw.pop("prefix", None),
            params=kw.pop("params", None), **kw)
    return __init__


class Conv1D(_Conv):
    __init__ = _conv_class(1, "NCW", False)


class Conv2D(_Conv):
    __init__ = _conv_class(2, "NCHW", False)


class Conv3D(_Conv):
    __init__ = _conv_class(3, "NCDHW", False)


class Conv1DTranspose(_Conv):
    __init__ = _conv_class(1, "NCW", True)


class Conv2DTranspose(_Conv):
    __init__ = _conv_class(2, "NCHW", True)


class Conv3DTranspose(_Conv):
    __init__ = _conv_class(3, "NCDHW", True)


class _Pooling(HybridBlock):
    def __init__(self, pool_size, strides, padding, ceil_mode, global_pool,
                 pool_type, layout, count_include_pad=None, prefix=None,
                 params=None):
        super().__init__(prefix, params)
        self._kwargs = {
            "kernel": pool_size,
            "stride": strides if strides is not None else pool_size,
            "pad": padding, "global_pool": global_pool,
            "pool_type": pool_type,
            "pooling_convention": "full" if ceil_mode else "valid",
            "layout": layout}
        if count_include_pad is not None:
            self._kwargs["count_include_pad"] = count_include_pad

    def hybrid_forward(self, F, x):
        return F.pooling(x, **self._kwargs)


def _pool_class(n, layout, pool_type):
    def __init__(self, pool_size=(2,) * n if n > 1 else 2, strides=None,
                 padding=0, layout=layout, ceil_mode=False,
                 count_include_pad=True, prefix=None, params=None):
        _Pooling.__init__(
            self, _tup(pool_size, n),
            _tup(strides, n) if strides is not None else None,
            _tup(padding, n), ceil_mode, False, pool_type, layout,
            count_include_pad if pool_type == "avg" else None,
            prefix=prefix, params=params)
    return __init__


def _global_class(n, layout, pool_type):
    def __init__(self, layout=layout, prefix=None, params=None):
        _Pooling.__init__(self, (1,) * n, None, (0,) * n, False, True,
                          pool_type, layout, prefix=prefix, params=params)
    return __init__


class MaxPool1D(_Pooling):
    __init__ = _pool_class(1, "NCW", "max")


class MaxPool2D(_Pooling):
    __init__ = _pool_class(2, "NCHW", "max")


class MaxPool3D(_Pooling):
    __init__ = _pool_class(3, "NCDHW", "max")


class AvgPool1D(_Pooling):
    __init__ = _pool_class(1, "NCW", "avg")


class AvgPool2D(_Pooling):
    __init__ = _pool_class(2, "NCHW", "avg")


class AvgPool3D(_Pooling):
    __init__ = _pool_class(3, "NCDHW", "avg")


class GlobalMaxPool1D(_Pooling):
    __init__ = _global_class(1, "NCW", "max")


class GlobalMaxPool2D(_Pooling):
    __init__ = _global_class(2, "NCHW", "max")


class GlobalMaxPool3D(_Pooling):
    __init__ = _global_class(3, "NCDHW", "max")


class GlobalAvgPool1D(_Pooling):
    __init__ = _global_class(1, "NCW", "avg")


class GlobalAvgPool2D(_Pooling):
    __init__ = _global_class(2, "NCHW", "avg")


class GlobalAvgPool3D(_Pooling):
    __init__ = _global_class(3, "NCDHW", "avg")


class ReflectionPad2D(HybridBlock):
    """Reflection padding of the last two axes of an NCHW input."""

    def __init__(self, padding=0, prefix=None, params=None):
        super().__init__(prefix, params)
        if isinstance(padding, int):
            padding = (0, 0, 0, 0, padding, padding, padding, padding)
        self._padding = tuple(padding)

    def hybrid_forward(self, F, x):
        return F.pad(x, mode="reflect", pad_width=self._padding)
