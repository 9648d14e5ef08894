"""Neural-net ops of the ResNet and BERT paths: FullyConnected,
Convolution, Pooling (max, global average), BatchNorm, LayerNorm,
Activation (ReLU, tanh, erf GELU), Dropout, Embedding, flatten,
log_softmax.

Counterpart of ``mxnet_tpu/ops/nn.py``, as plain functions on tensors
with the same attributes, layouts and rounding points.  The JAX package
leaves these ops to XLA; the port leaves them to PyTorch
(``torch.nn.functional.conv2d`` over cuDNN, ``torch.matmul``).  The
convolution weight is (Co, Ci/g, kh, kw) for every layout, as in the
checkpoints.  NHWC tensors are handed to PyTorch as permuted NCHW views
(channels-last memory), so no layout copy is made.  Each op is
registered under the JAX package's name (``FullyConnected``, ...).
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from ..base import MXNetError
from ..parallel import dist
from ..parallel.mesh import batch_shards
from ..parallel.sharding import rand_batch
from ..util import env
from .registry import register_op

__all__ = ["fully_connected", "convolution", "pooling", "batch_norm",
           "layer_norm", "activation", "dropout", "embedding", "flatten",
           "log_softmax"]


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
    coefficients in the statistics dtype.

    Under a data-parallel mesh of several ranks the batch is the global
    one: the sums Σx and Σ(x-c)^2 (two-pass: Σx, then Σ(x-mean)^2) are
    summed over the ranks by a differentiable all-reduce, and n counts
    every rank's rows, as the JAX package's sums over a batch that GSPMD
    shards."""
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
    shards = batch_shards()
    n = int(np.prod([data.shape[i] for i in red])) * shards
    xs = data.to(sdt)
    s1 = xs.sum(dim=red)
    if exact:
        if shards > 1:
            s1 = dist.all_reduce_sum(s1)
        mean = s1 / n
        xc = xs - mean.reshape(shape)
        s2 = (xc * xc).sum(dim=red)
        var = (dist.all_reduce_sum(s2) if shards > 1 else s2) / n
    else:
        c = moving_mean.detach().to(sdt)
        d = xs - c.reshape(shape)
        s2 = (d * d).sum(dim=red)
        if shards > 1:
            s1, s2 = dist.all_reduce_sum(torch.stack([s1, s2])).unbind(0)
        mean = s1 / n
        raw = s2 / n
        dm = mean - c
        var = torch.maximum(raw - dm * dm, 1e-6 * raw)
    out = apply_affine(mean, var)
    unbiased = var * (n / max(n - 1, 1))
    new_mean = momentum * moving_mean + (1 - momentum) * mean
    new_var = momentum * moving_var + (1 - momentum) * unbiased
    return out, new_mean, new_var


def layer_norm(data, gamma, beta, axis=-1, eps=1e-5):
    """Layer normalization over ``axis``, op by op as the JAX package
    writes it: the mean and the biased variance accumulate in fp32 and
    round to x's dtype (``jnp.mean``/``jnp.var`` of a bf16 tensor), then
    (x - mean) * rsqrt(var + eps) * gamma + beta runs in x's dtype.
    (``F.layer_norm`` on the card keeps fp32 to the end and rounds once.)"""
    xf = data.float()
    mean = xf.mean(dim=axis, keepdim=True)
    var = (xf - mean).square().mean(dim=axis, keepdim=True)
    mean, var = mean.to(data.dtype), var.to(data.dtype)
    out = (data - mean) * torch.rsqrt(var + eps)
    shape = [1] * data.dim()
    shape[axis] = data.shape[axis]
    return out * gamma.reshape(shape) + beta.reshape(shape)


# sqrt(1/2) rounded to each dtype, as jax.nn.gelu rounds its constant
_SQRT_HALF = {dt: float(torch.tensor(math.sqrt(0.5), dtype=dt))
              for dt in (torch.float32, torch.bfloat16, torch.float16)}


def _gelu(x):
    """erf GELU, 0.5·x·erfc(-x·sqrt(1/2)) op by op in x's dtype, as
    ``jax.nn.gelu(approximate=False)`` writes it (its constant rounded to
    x's dtype too)."""
    return 0.5 * x * torch.erfc(-x * _SQRT_HALF[x.dtype])


_ACTIVATIONS = {"relu": torch.relu, "tanh": torch.tanh, "gelu": _gelu}


def activation(data, act_type="relu"):
    """Elementwise activation: relu, tanh, or gelu (erf, not the tanh
    approximation)."""
    fn = _ACTIVATIONS.get(act_type)
    if fn is None:
        raise MXNetError(f"activation: act_type {act_type!r} is not ported; "
                         f"ported: {sorted(_ACTIVATIONS)}")
    return fn(data)


def dropout(data, p=0.5, mode="training", train=False, generator=None):
    """Inverted dropout: zero with probability p and rescale by 1/(1-p)
    when ``train`` or ``mode="always"``, the mask drawn from
    ``generator`` on data's device; the identity otherwise or when p is
    0.  Under data parallelism the mask is this rank's rows of the mask
    of the global batch (``parallel.sharding.rand_batch``)."""
    if not (mode == "always" or train) or p == 0.0:
        return data
    if generator is None:
        raise MXNetError("dropout: applying dropout draws from a "
                         "torch.Generator; pass generator=")
    keep = 1.0 - p
    mask = rand_batch(data.shape, generator, data.device) < keep
    return data * mask.to(data.dtype) / keep


def embedding(data, weight):
    """Row lookup into the (input_dim, output_dim) table ``weight``.  The
    ids are cast to int32 (a float id truncates) and out-of-range ids are
    clamped into range, as ``jnp.take(..., mode="clip")``: it never
    raises."""
    idx = data.to(torch.int32).long().clamp(0, weight.shape[0] - 1)
    return weight[idx]


def flatten(data):
    """(N, ...) -> (N, prod(...)); a 1-d array stays as it is."""
    return data.reshape(data.shape[0], -1) if data.dim() > 1 else data


def log_softmax(data, axis=-1, temperature=None):
    """log(softmax) over ``axis`` with optional temperature, written as
    ``jax.nn.log_softmax`` computes it (shift by the max, which gets no
    gradient; subtract the log of the summed exponentials), so each op
    rounds where the JAX package's does in a low-precision dtype."""
    x = data / temperature if temperature else data
    shifted = x - x.detach().amax(dim=axis, keepdim=True)
    return shifted - torch.log(torch.exp(shifted).sum(dim=axis,
                                                       keepdim=True))


for _name, _fn in (("FullyConnected", fully_connected),
                   ("Convolution", convolution), ("Pooling", pooling),
                   ("BatchNorm", batch_norm), ("LayerNorm", layer_norm),
                   ("Activation", activation), ("Dropout", dropout),
                   ("Embedding", embedding)):
    register_op(_name, aliases=(_fn.__name__,))(_fn)
register_op("log_softmax")(log_softmax)
