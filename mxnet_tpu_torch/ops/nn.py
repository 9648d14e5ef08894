"""Neural-net ops of the ResNet serving path: FullyConnected, Convolution,
Pooling (max, global average), BatchNorm, Activation (ReLU), flatten.

Counterpart of ``mxnet_tpu/ops/nn.py``, as plain functions on tensors
with the same attributes, layouts and rounding points.  The JAX package
leaves these ops to XLA; the port leaves them to PyTorch
(``torch.nn.functional.conv2d`` over cuDNN, ``torch.matmul``).  The
convolution weight is (Co, Ci/g, kh, kw) for every layout, as in the
checkpoints.  NHWC tensors are handed to PyTorch as permuted NCHW views
(channels-last memory), so no layout copy is made.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..base import MXNetError
from ..util import env

__all__ = ["fully_connected", "convolution", "pooling", "batch_norm",
           "activation", "flatten"]


def _channels_last(layout) -> bool:
    return bool(layout) and layout[-1] == "C"


def fully_connected(data, weight, bias=None, num_hidden=0, no_bias=False,
                    flatten=True):
    """Dense layer: data @ weight.T + bias, flattening trailing dims first
    when ``flatten``."""
    if flatten and data.dim() > 2:
        data = data.reshape(data.shape[0], -1)
    out = torch.matmul(data, weight.t())
    if bias is not None and not no_bias:
        out = out + bias
    return out


def convolution(data, weight, bias=None, kernel=(), stride=(), dilate=(),
                pad=(), num_filter=0, num_group=1, no_bias=False,
                layout=None):
    """2-D grouped convolution in NCHW or NHWC with optional bias.  The
    bias is added to the conv output in its own dtype, after the conv
    has rounded to it, as the JAX package does."""
    if data.dim() != 4:
        raise MXNetError(f"convolution: only 2-D convolution is ported, "
                         f"got a {data.dim()}-d input")
    stride = tuple(stride) if stride else (1, 1)
    dilate = tuple(dilate) if dilate else (1, 1)
    pad = tuple(pad) if pad else (0, 0)
    nhwc = _channels_last(layout)
    x = data.permute(0, 3, 1, 2) if nhwc else data
    out = F.conv2d(x, weight, stride=stride, padding=pad, dilation=dilate,
                   groups=num_group)
    if bias is not None and not no_bias:
        out = out + bias.reshape(1, -1, 1, 1)
    return out.permute(0, 2, 3, 1) if nhwc else out


def pooling(data, kernel=(), pool_type="max", stride=(), pad=(),
            global_pool=False, pooling_convention="valid", layout=None):
    """Max pooling (valid convention, -inf padding) and global average
    pooling: what ResNet uses.  Other pool types and the "full"
    convention are not ported."""
    nhwc = _channels_last(layout)
    if global_pool and pool_type == "avg":
        return data.mean(dim=(1, 2) if nhwc else (2, 3), keepdim=True)
    if global_pool or pool_type != "max" or pooling_convention != "valid":
        raise MXNetError(f"pooling: pool_type={pool_type!r} global_pool="
                         f"{global_pool} pooling_convention="
                         f"{pooling_convention!r} is not ported")
    kernel = tuple(kernel)
    stride = tuple(stride) if stride else (1, 1)
    pad = tuple(pad) if pad else (0, 0)
    if any(2 * p > k for p, k in zip(pad, kernel)):
        raise MXNetError(f"pooling: pad {pad} wider than half the kernel "
                         f"{kernel} is not ported")
    x = data.permute(0, 3, 1, 2) if nhwc else data
    # max_pool2d pads with -inf, as the JAX package's reduce_window does
    out = F.max_pool2d(x, kernel, stride, padding=pad)
    return out.permute(0, 2, 3, 1) if nhwc else out


_BN_EXACT_VAR = None  # read once per process, like the JAX package


def batch_norm(data, gamma, beta, moving_mean, moving_var, eps=1e-5,
               momentum=0.9, fix_gamma=False, use_global_stats=False,
               axis=1, train=False, exact_var=None):
    """Batch normalization over ``axis``.  Eval (or use_global_stats)
    returns the normalized tensor from the moving statistics.  Train
    returns (out, new_moving_mean, new_moving_var) from batch
    statistics: the single-pass variance E[(x-c)^2] - (mean-c)^2 shifted
    by the running mean c with the relative floor 1e-6·raw, or the
    exact two-pass variance under ``MXNET_BN_EXACT_VAR`` / ``exact_var``.
    The big tensor is read in its own dtype and normalized with C-sized
    coefficients in the statistics dtype."""
    shape = [1] * data.dim()
    shape[axis] = data.shape[axis]
    sdt = moving_mean.dtype
    odtype = data.dtype
    g = torch.ones_like(gamma) if fix_gamma else gamma

    def apply_affine(mean, var):
        scale = g.to(sdt) * torch.rsqrt(var + eps)
        bias = beta.to(sdt) - mean * scale
        return (data.to(sdt) * scale.reshape(shape)
                + bias.reshape(shape)).to(odtype)

    if not train or use_global_stats:
        return apply_affine(moving_mean, moving_var)
    global _BN_EXACT_VAR
    if _BN_EXACT_VAR is None:
        _BN_EXACT_VAR = env.get_bool("MXNET_BN_EXACT_VAR")
    exact = _BN_EXACT_VAR if exact_var is None else bool(exact_var)
    red = tuple(i for i in range(data.dim()) if i != axis)
    n = int(np.prod([data.shape[i] for i in red]))
    xs = data.to(sdt)
    mean = xs.sum(dim=red) / n
    if exact:
        xc = xs - mean.reshape(shape)
        var = (xc * xc).sum(dim=red) / n
    else:
        c = moving_mean.detach().to(sdt)
        d = xs - c.reshape(shape)
        raw = (d * d).sum(dim=red) / n
        dm = mean - c
        var = torch.maximum(raw - dm * dm, 1e-6 * raw)
    out = apply_affine(mean, var)
    unbiased = var * (n / max(n - 1, 1))
    new_mean = momentum * moving_mean + (1 - momentum) * mean
    new_var = momentum * moving_var + (1 - momentum) * unbiased
    return out, new_mean, new_var


def activation(data, act_type="relu"):
    """Elementwise activation; ReLU is the one this slice uses."""
    if act_type != "relu":
        raise MXNetError(f"activation: act_type {act_type!r} is not ported")
    return torch.relu(data)


def flatten(data):
    return data.reshape(data.shape[0], -1)
