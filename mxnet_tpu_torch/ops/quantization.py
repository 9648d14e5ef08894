"""Quantization ops (counterpart of ``mxnet_tpu/ops/quantization.py``).

The JAX package's names and range conventions, copied exactly:

  * int8 is symmetric by absmax, [-127, 127], scale ``127 / max(absmax,
    1e-20)`` in float32; uint8 is affine over [min(lo, 0), max(hi, 0)];
  * ``round`` is half to even (``torch.round``, as ``jnp.round``);
  * an int32 accumulator of ``quantized_conv``/``_fully_connected``
    carries the range ``±(2^31 - 1) · (absmax_a / 127) · (absmax_b /
    127)`` (``_int32_range``), and ``dequantize`` of int32 scales by
    ``absmax / (2^31 - 1)``;
  * a calibrated range given as an attribute enters as a float32 scalar.

Ranges stay 0-d tensors on the data's device: nothing reads a value to
the host, so a quantized forward captures as a CUDA graph.  Constants
enter through ``torch.full`` (a fill on the device, no host copy), and a
division by a constant is by a 0-d tensor: the card divides by a Python
scalar as a product with its reciprocal, by a tensor exactly, as the CPU
and XLA do.

``quantized_conv`` and ``quantized_fully_connected`` compute through
``ops/quantized_conv.py``'s ``int8_conv`` (the CUDA kernel on the card,
the plain float64 version on the CPU); the fully connected layer is a 1x1
convolution over a 1x1 image.  ``quantized_pooling`` works on the integers
directly.  The quantized elementwise ops raise, as in the JAX package:
between ``dequantize`` and the next ``quantize`` elementwise math runs in
float32.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..base import MXNetError
from .quantized_conv import int8_conv
from .registry import register_op

__all__ = ["quantize", "quantize_v2", "dequantize", "requantize",
           "quantized_conv", "quantized_fully_connected",
           "quantized_pooling", "quantized_flatten"]

_INT32_MAX = float(2 ** 31 - 1)


def _const(v, ref):
    """Python number v as a 0-d float32 tensor on ref's device."""
    return torch.full((), float(v), dtype=torch.float32, device=ref.device)


def _div(a, v):
    return a / _const(v, a)


def _qrange(out_type: str):
    if out_type == "uint8":
        return 0.0, 255.0, torch.uint8
    if out_type == "int8":
        return -127.0, 127.0, torch.int8
    raise MXNetError(f"unsupported quantized type {out_type!r} "
                     "(uint8/int8)")


def _f32(data):
    """float32 for a half-precision input, as JAX promotes it against the
    float32 scale."""
    return data.float() if data.dtype in (torch.float16, torch.bfloat16) \
        else data


def _absmax(lo, hi):
    return torch.maximum(lo.reshape(()).abs(), hi.reshape(()).abs())


def quantize(data, min_range, max_range, out_type="uint8"):
    """Quantize float data into uint8/int8 over the given range; returns
    (q, out_min, out_max)."""
    qmin, qmax, qdt = _qrange(out_type)
    data = _f32(data)
    rmin = torch.clamp_max(min_range.reshape(()).float(), 0.0)
    rmax = torch.clamp_min(max_range.reshape(()).float(), 0.0)
    if out_type == "int8":
        absmax = torch.maximum(rmin.abs(), rmax.abs())
        scale = _const(qmax, absmax) / torch.clamp_min(absmax, 1e-20)
        q = torch.clamp(torch.round(data * scale), qmin, qmax).to(qdt)
        return q, -absmax, absmax
    scale = _const(qmax - qmin, rmax) / torch.clamp_min(rmax - rmin, 1e-20)
    q = torch.clamp(torch.round((data - rmin) * scale) + qmin, qmin,
                    qmax).to(qdt)
    return q, rmin, rmax


def quantize_v2(data, out_type="int8", min_calib_range=None,
                max_calib_range=None):
    """Quantize over the calibrated range, or over the data's own min and
    max when no range is given."""
    if min_calib_range is None or max_calib_range is None:
        rmin, rmax = data.min(), data.max()
    else:
        rmin = _const(min_calib_range, data)
        rmax = _const(max_calib_range, data)
    return quantize(data, rmin, rmax, out_type=out_type)


def _dequantize_int32(data, min_range, max_range):
    return data.to(torch.float32) * _div(_absmax(min_range, max_range),
                                         _INT32_MAX)


def dequantize(data, min_range, max_range, out_type="float32"):
    """Invert the quantization: int8 by absmax / 127, an int32
    accumulator by absmax / (2^31 - 1), uint8 affinely."""
    rmin = min_range.reshape(())
    rmax = max_range.reshape(())
    if data.dtype == torch.int8:
        return data.to(torch.float32) * _div(_absmax(rmin, rmax), 127.0)
    if data.dtype == torch.int32:
        return _dequantize_int32(data, rmin, rmax)
    scale = _div(rmax - rmin, 255.0)
    return data.to(torch.float32) * scale + rmin


def requantize(data, min_range, max_range, out_type="int8",
               min_calib_range=None, max_calib_range=None):
    """An int32 accumulator -> int8 over the calibrated range (or the
    dequantized values' own min and max)."""
    if data.dtype != torch.int32:
        raise MXNetError("requantize expects int32 input")
    f = _dequantize_int32(data, min_range, max_range)
    if min_calib_range is not None and max_calib_range is not None:
        rmin, rmax = _const(min_calib_range, f), _const(max_calib_range, f)
    else:
        rmin, rmax = f.min(), f.max()
    return quantize(f, rmin, rmax, out_type=out_type)


def _int32_range(min_a, max_a, min_b, max_b):
    """The float magnitude of the int32 extreme: accumulator V stands for
    V · (absmax_a / 127) · (absmax_b / 127), so dequantize's int32 branch
    round-trips."""
    scale = _div(_absmax(min_a, max_a), 127.0) * \
        _div(_absmax(min_b, max_b), 127.0)
    out = _const(_INT32_MAX, scale) * scale
    return -out, out


_DEFAULT_LAYOUT = {1: "NCW", 2: "NCHW", 3: "NCDHW"}


def quantized_conv(data, weight, min_data, max_data, min_weight, max_weight,
                   kernel=(), stride=(), dilate=(), pad=(), num_filter=0,
                   num_group=1, layout=None, no_bias=True, cudnn_tune=None,
                   cudnn_off=False, workspace=1024):
    """int8 convolution with int32 accumulation; the weight is OI + the
    kernel's dims in every layout; bias is added in float32 after
    dequantization by the ``quantize_model`` rewrite."""
    if data.dtype != torch.int8 or weight.dtype != torch.int8:
        raise MXNetError("quantized_conv expects int8 data and weight")
    nd = len(kernel) if kernel else data.dim() - 2
    lay = layout or _DEFAULT_LAYOUT[nd]
    out = int8_conv(data, weight, stride, pad, dilate, num_group,
                    channels_last=lay[-1] == "C")
    omin, omax = _int32_range(min_data, max_data, min_weight, max_weight)
    return out, omin, omax


def quantized_fully_connected(data, weight, min_data, max_data, min_weight,
                              max_weight, num_hidden=0, no_bias=True,
                              flatten=True):
    """int8 x int8ᵀ -> int32 (a 1x1 convolution over a 1x1 image); bias is
    added in float32 after dequantization by the rewrite."""
    if data.dtype != torch.int8 or weight.dtype != torch.int8:
        raise MXNetError("quantized_fully_connected expects int8 inputs")
    x = data.reshape(data.shape[0], -1) if flatten else data
    lead = x.shape[:-1]
    x2 = x.reshape(-1, 1, 1, x.shape[-1])
    y = int8_conv(x2, weight.reshape(weight.shape[0], -1, 1, 1),
                  channels_last=True, site="fc")
    omin, omax = _int32_range(min_data, max_data, min_weight, max_weight)
    return y.reshape(*lead, weight.shape[0]), omin, omax


def _windows(x, window, strides):
    """x (N, C, *spatial), padded, as (N, C, *out, *window) views."""
    for i, (k, s) in enumerate(zip(window, strides)):
        x = x.unfold(2 + i, k, s)
    return x


def quantized_pooling(data, min_data, max_data, kernel=(), pool_type="max",
                      stride=(), pad=(), global_pool=False,
                      pooling_convention="valid", layout=None):
    """Pooling on int8/uint8 directly: max exactly (padding at the type's
    minimum), avg as an int32 sum over the whole window (padding counted)
    divided in float32, rounded half to even and clipped.  The window
    geometry is the float Pooling op's."""
    from .nn import _pool_pads

    channels_last = bool(layout) and layout[-1] == "C"
    x = data.permute(0, data.dim() - 1, *range(1, data.dim() - 1)) \
        if channels_last else data
    nsp = x.dim() - 2
    if global_pool:
        window, strides = tuple(x.shape[2:]), (1,) * nsp
        pads = [(0, 0)] * nsp
    else:
        window = tuple(kernel)
        if len(window) != nsp:
            raise MXNetError(f"pooling: kernel must have {nsp} dims for "
                             f"{data.dim()}-d input (got {window!r})")
        strides = tuple(stride) if stride else (1,) * nsp
        pads = _pool_pads(x.shape[2:], window, strides,
                          tuple(pad) if pad else (0,) * nsp,
                          pooling_convention)
    flat = [v for pr in reversed(pads) for v in pr]
    info = torch.iinfo(data.dtype)
    axes = tuple(range(-nsp, 0))
    if pool_type == "max":
        xp = F.pad(x, flat, value=info.min) if any(flat) else x
        out = _windows(xp, window, strides).amax(dim=axes)
    elif pool_type == "avg":
        xp = F.pad(x, flat) if any(flat) else x
        acc = _windows(xp, window, strides).sum(dim=axes, dtype=torch.int32)
        avg = _div(acc.to(torch.float32), math.prod(window))
        out = torch.clamp(torch.round(avg), info.min, info.max).to(
            data.dtype)
    else:
        raise MXNetError(f"quantized_pooling: unsupported pool_type "
                         f"{pool_type!r}")
    if channels_last:
        out = out.permute(0, *range(2, out.dim()), 1)
    return out, min_data.reshape(()), max_data.reshape(())


def quantized_flatten(data, min_data, max_data):
    """Flatten to (N, -1), the range passed through."""
    return (data.reshape(data.shape[0], -1), min_data.reshape(()),
            max_data.reshape(()))


def _stub(name: str):
    def stub(*args, **kwargs):
        raise MXNetError(
            f"{name} is not provided as a standalone kernel in the port, "
            "as in the JAX package: the int8 contractions and pooling are "
            "real ops (quantized_conv/fully_connected/pooling), and "
            "everything elementwise runs in float32 between dequantize and "
            "the next quantize.")

    stub.__name__ = name
    return stub


for _name, _fn, _n in (
        ("quantize", quantize, 3), ("quantize_v2", quantize_v2, 3),
        ("dequantize", dequantize, 1), ("requantize", requantize, 3),
        ("quantized_conv", quantized_conv, 3),
        ("quantized_fully_connected", quantized_fully_connected, 3),
        ("quantized_pooling", quantized_pooling, 3),
        ("quantized_flatten", quantized_flatten, 3)):
    register_op("_contrib_" + _name, aliases=(_name,), num_outputs=_n,
                differentiable=False)(_fn)
for _name in ("_contrib_quantized_act", "_contrib_quantized_concat",
              "_contrib_quantized_elemwise_add"):
    register_op(_name, differentiable=False)(_stub(_name))
