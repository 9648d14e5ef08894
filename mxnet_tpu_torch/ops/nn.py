"""Neural-net ops of the ResNet and BERT paths: FullyConnected,
Convolution, Pooling (max, global average), BatchNorm, LayerNorm,
Activation (ReLU, tanh, erf GELU), Dropout, Embedding, flatten,
softmax, log_softmax; and the legacy loss heads of the symbolic API:
SoftmaxOutput, the three regression outputs, MakeLoss and
stop_gradient (BlockGrad).

Counterpart of ``mxnet_tpu/ops/nn.py``, as plain functions on tensors
with the same attributes, layouts and rounding points.  The JAX package
leaves these ops to XLA; the port leaves them to PyTorch
(``torch.nn.functional.conv2d`` over cuDNN, ``torch.matmul``).  The
convolution weight is (Co, Ci/g, kh, kw) for every layout, as in the
checkpoints.  NHWC tensors are handed to PyTorch as permuted NCHW views
(channels-last memory), so no layout copy is made.  Each op is
registered under the JAX package's name (``FullyConnected``, ...) and
accepts every attribute the JAX op accepts, so a symbol file written by
the JAX package loads: the hints that only choose an implementation
(``cudnn_off``, ``cudnn_tune``, ``workspace``) and the ones the JAX op
ignores too (BatchNorm's and LayerNorm's ``output_mean_var``) change
nothing.

The loss heads are ``torch.autograd.Function``s with the JAX package's
backward, which ignores the upstream gradient: SoftmaxOutput's is
(softmax - one_hot(label)) * grad_scale under its ``normalization``
and ``use_ignore``; a regression head's is grad_scale / (outputs per
sample) times the residual.  As in the JAX package, SoftmaxOutput takes
the softmax over the last axis and ignores ``multi_output``,
``preserve_shape``, ``out_grad`` and ``smooth_alpha``; MakeLoss is the
identity and ignores ``grad_scale``, ``valid_thresh`` and
``normalization``.
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
           "softmax", "log_softmax", "softmax_output", "make_loss",
           "stop_gradient"]


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
                layout=None, cudnn_tune=None, cudnn_off=False,
                workspace=1024):
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
            global_pool=False, pooling_convention="valid", layout=None,
            count_include_pad=True, cudnn_off=False):
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
               axis=1, train=False, exact_var=None, output_mean_var=False,
               cudnn_off=False):
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


def layer_norm(data, gamma, beta, axis=-1, eps=1e-5, output_mean_var=False):
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


def dropout(data, p=0.5, mode="training", train=False, generator=None,
            axes=()):
    """Inverted dropout: zero with probability p and rescale by 1/(1-p)
    when ``train`` or ``mode="always"``, the mask drawn from
    ``generator`` on data's device (one mask shared along ``axes``); the
    identity otherwise or when p is 0.  Under data parallelism the mask
    is this rank's rows of the mask of the global batch
    (``parallel.sharding.rand_batch``)."""
    if not (mode == "always" or train) or p == 0.0:
        return data
    if generator is None:
        raise MXNetError("dropout: applying dropout draws from a "
                         "torch.Generator; pass generator=")
    keep = 1.0 - p
    shape = list(data.shape)
    shared = {a % data.dim() for a in axes}
    for a in shared:
        shape[a] = 1
    # a mask shared along the batch axis is one draw on every rank
    draw = (lambda *a: torch.rand(a[0], generator=a[1], device=a[2])) \
        if 0 in shared else rand_batch
    mask = draw(tuple(shape), generator, data.device) < keep
    return data * mask.to(data.dtype) / keep


def embedding(data, weight, input_dim=0, output_dim=0, dtype="float32",
              sparse_grad=False):
    """Row lookup into the (input_dim, output_dim) table ``weight``.  The
    ids are cast to int32 (a float id truncates) and out-of-range ids are
    clamped into range, as ``jnp.take(..., mode="clip")``: it never
    raises."""
    idx = data.to(torch.int32).long().clamp(0, weight.shape[0] - 1)
    return weight[idx]


def flatten(data):
    """(N, ...) -> (N, prod(...)); a 1-d array stays as it is."""
    return data.reshape(data.shape[0], -1) if data.dim() > 1 else data


def softmax(data, axis=-1, temperature=None, length=None):
    """softmax over ``axis`` with optional temperature, and with
    positions at or past a row's ``length`` (one value per leading
    index) masked to -inf, written as ``jax.nn.softmax`` computes it:
    exp(x - max(x)), the max getting no gradient, over its sum."""
    x = data / temperature if temperature else data
    if length is not None:
        pos = torch.arange(x.shape[axis], device=x.device)
        shape = [1] * x.dim()
        shape[axis] = -1
        mask = pos.reshape(shape) < length.reshape(
            (-1,) + (1,) * (x.dim() - 1))
        x = torch.where(mask, x, float("-inf"))
    e = torch.exp(x - x.detach().amax(dim=axis, keepdim=True))
    return e / e.sum(dim=axis, keepdim=True)


def log_softmax(data, axis=-1, temperature=None):
    """log(softmax) over ``axis`` with optional temperature, written as
    ``jax.nn.log_softmax`` computes it (shift by the max, which gets no
    gradient; subtract the log of the summed exponentials) and rounded
    where XLA rounds it in a low-precision dtype: the shift in x's dtype,
    the exponentials summed in fp32 without a rounding of their own (XLA
    keeps their excess precision up to the fp32 sum), the sum rounded to
    x's dtype, its log rounded to x's dtype, then the subtraction.  bf16
    log-probabilities then equal the JAX package's bit for bit, so tied
    values tie alike (SSD's hard-negative ranking)."""
    x = data / temperature if temperature else data
    acc = torch.promote_types(x.dtype, torch.float32)
    shifted = x - x.detach().amax(dim=axis, keepdim=True)
    total = torch.exp(shifted.to(acc)).sum(dim=axis, keepdim=True)
    return shifted - torch.log(total.to(x.dtype).to(acc)).to(x.dtype)


# ---------------------------------------------------------------------------
# the legacy loss heads (their backward ignores the upstream gradient)
# ---------------------------------------------------------------------------

class _SoftmaxOutputFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, data, label, grad_scale, ignore_label, use_ignore,
                normalization):
        out = softmax(data, axis=-1)
        ctx.save_for_backward(out, label)
        ctx.conf = (grad_scale, ignore_label, use_ignore, normalization)
        return out

    @staticmethod
    def backward(ctx, g):
        out, label = ctx.saved_tensors
        grad_scale, ignore_label, use_ignore, normalization = ctx.conf
        lab = label.to(torch.int32)
        classes = torch.arange(out.shape[-1], device=out.device)
        # one_hot of an out-of-range label is a zero row, as jax.nn.one_hot
        grad = out - (lab.unsqueeze(-1) == classes).to(out.dtype)
        valid = None
        if use_ignore:
            keep = lab != int(ignore_label)
            grad = grad * keep.unsqueeze(-1).to(grad.dtype)
            valid = keep.sum().clamp_min(1)
        if normalization == "batch":
            grad = grad / out.shape[0]
        elif normalization == "valid":
            grad = grad / (valid if valid is not None else out.shape[0])
        glabel = torch.zeros_like(label) if ctx.needs_input_grad[1] \
            else None
        return grad * grad_scale, glabel, None, None, None, None


def softmax_output(data, label, grad_scale=1.0, ignore_label=-1,
                   use_ignore=False, multi_output=False,
                   preserve_shape=False, normalization="null",
                   out_grad=False, smooth_alpha=0.0):
    """Forward: softmax over the last axis.  Backward: (softmax -
    one_hot(label)) * grad_scale, divided by the batch (``"batch"``) or
    the count of labels not ignored (``"valid"``), rows whose label is
    ``ignore_label`` zeroed under ``use_ignore``."""
    return _SoftmaxOutputFn.apply(data, label, float(grad_scale),
                                  ignore_label, bool(use_ignore),
                                  normalization)


class _RegressionFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, data, label, grad_scale, kind):
        out = torch.sigmoid(data) if kind == "logistic" else data
        ctx.save_for_backward(out, label)
        ctx.conf = (grad_scale, kind)
        return out

    @staticmethod
    def backward(ctx, g):
        out, label = ctx.saved_tensors
        grad_scale, kind = ctx.conf
        res = out - label.reshape(out.shape).to(out.dtype)
        if kind == "mae":
            res = torch.sign(res)
        # grad_scale over the outputs of one sample, not over the batch
        grad = res * (grad_scale / math.prod(out.shape[1:]))
        glabel = torch.zeros_like(label) if ctx.needs_input_grad[1] \
            else None
        return grad, glabel, None, None


def _regression_head(kind):
    def head(data, label, grad_scale=1.0):
        """Regression output head: forward the identity (logistic: the
        sigmoid), backward grad_scale * (out - label) (MAE: its sign)
        over the outputs of one sample."""
        return _RegressionFn.apply(data, label, float(grad_scale), kind)
    return head


def make_loss(data, grad_scale=1.0, valid_thresh=0.0, normalization="null"):
    """A loss head: the identity (a gradient of ones flows back)."""
    return data


def stop_gradient(data):
    """The identity forward, no gradient back."""
    return data.detach()


def _bn_nout(attrs):
    return 3 if attrs.get("train", False) else 1


for _name, _fn in (("FullyConnected", fully_connected),
                   ("Convolution", convolution), ("Pooling", pooling),
                   ("LayerNorm", layer_norm),
                   ("Activation", activation), ("Dropout", dropout),
                   ("Embedding", embedding),
                   ("SoftmaxOutput", softmax_output),
                   ("MakeLoss", make_loss)):
    register_op(_name, aliases=(_fn.__name__,))(_fn)
register_op("BatchNorm", aliases=("batch_norm",),
            num_outputs=_bn_nout)(batch_norm)
register_op("stop_gradient", aliases=("BlockGrad", "block_grad"))(
    stop_gradient)
for _name, _snake, _kind in (
        ("LinearRegressionOutput", "linear_regression_output", "linear"),
        ("MAERegressionOutput", "mae_regression_output", "mae"),
        ("LogisticRegressionOutput", "logistic_regression_output",
         "logistic")):
    register_op(_name, aliases=(_snake,))(_regression_head(_kind))
register_op("softmax")(softmax)
register_op("log_softmax")(log_softmax)
