"""Neural-net ops: FullyConnected, Convolution and Deconvolution (1-D to
3-D), Pooling (max, avg, sum, lp, global, the valid and full
conventions), BatchNorm, LayerNorm, InstanceNorm, GroupNorm, Activation
(relu, sigmoid, tanh, softrelu, softsign, gelu, gelu_tanh, silu),
LeakyReLU (leaky, prelu, elu, selu, gelu, rrelu), Dropout, Embedding,
flatten, softmax, log_softmax, softmin, pad, RMSNorm, hard_sigmoid,
hard_swish, mish, SoftmaxActivation, UpSampling, BilinearSampler,
GridGenerator, SpatialTransformer, im2col/col2im, Correlation and
DeformableConvolution; and the legacy loss heads of the symbolic API:
SoftmaxOutput, SVMOutput, the three regression outputs, MakeLoss and
stop_gradient (BlockGrad); and CTCLoss (ctc_loss), the JAX op's
log-space recursion over the label with blanks between its symbols, one
step per frame, with -1e30 standing for log 0 and its gradient taken by
autograd through a logaddexp with ``jnp.logaddexp``'s derivative
(``F.ctc_loss`` gives inf where no alignment exists and treats padding
its own way, so it is not this op).

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
backward, which ignores the upstream gradient: SVMOutput's is the hinge
gradient; SoftmaxOutput's is
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

from .. import _graphs
from ..base import MXNetError
from ..parallel import dist
from ..parallel.mesh import batch_group, batch_shards
from ..parallel.sharding import rand_batch
from ..util import env
from .registry import register_op

__all__ = ["fully_connected", "convolution", "deconvolution", "pooling",
           "batch_norm", "layer_norm", "instance_norm", "group_norm",
           "activation", "leaky_relu", "dropout", "embedding", "flatten",
           "softmax", "log_softmax", "softmin", "pad", "softmax_output",
           "make_loss", "stop_gradient", "rms_norm", "hard_sigmoid",
           "hard_swish", "mish", "softmax_activation", "svm_output",
           "upsampling", "bilinear_sampler", "grid_generator",
           "spatial_transformer", "im2col", "col2im", "correlation",
           "deformable_convolution", "ctc_loss"]


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


_CONV = {1: F.conv1d, 2: F.conv2d, 3: F.conv3d}
_DECONV = {1: F.conv_transpose1d, 2: F.conv_transpose2d,
           3: F.conv_transpose3d}
_MAXPOOL = {1: F.max_pool1d, 2: F.max_pool2d, 3: F.max_pool3d}
_AVGPOOL = {1: F.avg_pool1d, 2: F.avg_pool2d, 3: F.avg_pool3d}


def _to_channels_first(x, nhwc):
    """An N-D tensor in a channels-last layout as a channels-first view
    (channels-last memory: no copy), and back."""
    if not nhwc:
        return x
    return x.permute(0, x.dim() - 1, *range(1, x.dim() - 1))


def _to_layout(x, nhwc):
    if not nhwc:
        return x
    return x.permute(0, *range(2, x.dim()), 1)


def _add_bias(out, bias, no_bias):
    if bias is None or no_bias:
        return out
    return out + bias.reshape((1, -1) + (1,) * (out.dim() - 2))


def convolution(data, weight, bias=None, kernel=(), stride=(), dilate=(),
                pad=(), num_filter=0, num_group=1, no_bias=False,
                layout=None, cudnn_tune=None, cudnn_off=False,
                workspace=1024):
    """1-, 2- or 3-D grouped convolution in a channels-first (NCW, NCHW,
    NCDHW) or channels-last layout with optional bias.  The bias is
    added to the conv output in its own dtype, after the conv has
    rounded to it, as the JAX package does."""
    nd = data.dim() - 2
    if nd not in _CONV:
        raise MXNetError(f"convolution: a {data.dim()}-d input; 1-D to "
                         "3-D convolutions are ported")
    stride = tuple(stride) if stride else (1,) * nd
    dilate = tuple(dilate) if dilate else (1,) * nd
    pad = tuple(pad) if pad else (0,) * nd
    nhwc = _channels_last(layout)
    x = _to_channels_first(data, nhwc)
    out = _CONV[nd](x, weight, stride=stride, padding=pad, dilation=dilate,
                    groups=num_group)
    return _to_layout(_add_bias(out, bias, no_bias), nhwc)


def deconvolution(data, weight, bias=None, kernel=(), stride=(), dilate=(),
                  pad=(), adj=(), num_filter=0, num_group=1, no_bias=False,
                  target_shape=None, layout=None, workspace=1024,
                  cudnn_tune=None, cudnn_off=False):
    """Transposed convolution, the weight (in, out/g, *k) as in the JAX
    package: out = (in-1)*s - 2p + (k-1)*d + 1 + adj per spatial dim,
    ``target_shape`` choosing adj."""
    nd = data.dim() - 2
    if nd not in _DECONV:
        raise MXNetError(f"deconvolution: a {data.dim()}-d input; 1-D to "
                         "3-D are ported")
    kernel = tuple(kernel) if kernel else tuple(weight.shape[2:])
    stride = tuple(stride) if stride else (1,) * nd
    pad = tuple(pad) if pad else (0,) * nd
    dilate = tuple(dilate) if dilate else (1,) * nd
    nhwc = _channels_last(layout)
    x = _to_channels_first(data, nhwc)
    if target_shape:
        adj = tuple(t - ((x.shape[2 + i] - 1) * stride[i] - 2 * pad[i]
                         + (kernel[i] - 1) * dilate[i] + 1)
                    for i, t in enumerate(target_shape))
    else:
        adj = tuple(adj) if adj else (0,) * nd
    out = _DECONV[nd](x, weight, stride=stride, padding=pad,
                      output_padding=adj, groups=num_group, dilation=dilate)
    return _to_layout(_add_bias(out, bias, no_bias), nhwc)


def _pool_pads(shape, kernel, stride, pad, convention):
    """(before, after) padding per spatial dim, the "full" (ceil)
    convention extending the right side as the JAX package's
    ``pool_window`` does."""
    pads = []
    for i, (k, s, p) in enumerate(zip(kernel, stride, pad)):
        extra = 0
        if convention == "full":
            rem = (shape[i] + 2 * p - k) % s
            extra = 0 if rem == 0 else s - rem
        elif convention != "valid":
            raise MXNetError("pooling_convention must be valid/full "
                             f"(got {convention!r})")
        pads.append((p, p + extra))
    return pads


def pooling(data, kernel=(), pool_type="max", stride=(), pad=(),
            global_pool=False, pooling_convention="valid", layout=None,
            count_include_pad=True, cudnn_off=False):
    """max, avg, sum and lp (p=2) pooling over 1 to 3 spatial dims, the
    valid or full (ceil) convention and global pooling, as the JAX
    package's ``reduce_window`` computes them: max pads with -inf, avg
    divides by the kernel's size (``count_include_pad``) or by the count
    of the window's real elements."""
    nhwc = _channels_last(layout)
    nd = data.dim() - 2
    if global_pool:
        axes = tuple(range(1, data.dim() - 1)) if nhwc \
            else tuple(range(2, data.dim()))
        if pool_type == "max":
            return data.amax(dim=axes, keepdim=True)
        return data.mean(dim=axes, keepdim=True)
    kernel = tuple(kernel)
    if len(kernel) != nd:
        raise MXNetError(f"pooling: kernel must have {nd} dims for a "
                         f"{data.dim()}-d input (got {kernel!r})")
    stride = tuple(stride) if stride else (1,) * nd
    pad = tuple(pad) if pad else (0,) * nd
    x = _to_channels_first(data, nhwc)
    pads = _pool_pads(x.shape[2:], kernel, stride, pad, pooling_convention)
    if pool_type == "max" and pooling_convention == "valid" \
            and all(2 * p <= k for p, k in zip(pad, kernel)):
        # max_pool pads with -inf, as the JAX package's reduce_window does
        return _to_layout(_MAXPOOL[nd](x, kernel, stride, padding=pad), nhwc)
    flat = [v for pr in reversed(pads) for v in pr]
    if pool_type == "max":
        xp = F.pad(x, flat, value=float("-inf"))
        return _to_layout(_MAXPOOL[nd](xp, kernel, stride), nhwc)
    if pool_type not in ("avg", "sum", "lp"):
        raise MXNetError(f"pooling: unknown pool_type {pool_type!r}")
    src = x.abs().square() if pool_type == "lp" else x
    size = math.prod(kernel)
    total = _AVGPOOL[nd](F.pad(src, flat), kernel, stride) * size
    if pool_type == "lp":
        return _to_layout(torch.sqrt(total), nhwc)
    if pool_type == "sum":
        return _to_layout(total, nhwc)
    if count_include_pad:
        return _to_layout(total / float(size), nhwc)
    ones = F.pad(torch.ones_like(x[:1, :1]), flat)
    cnt = _AVGPOOL[nd](ones, kernel, stride) * size
    return _to_layout(total / cnt, nhwc)


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
            s1 = dist.all_reduce_sum(s1, batch_group())
        mean = s1 / n
        xc = xs - mean.reshape(shape)
        s2 = (xc * xc).sum(dim=red)
        var = (dist.all_reduce_sum(s2, batch_group()) if shards > 1
               else s2) / n
    else:
        c = moving_mean.detach().to(sdt)
        d = xs - c.reshape(shape)
        s2 = (d * d).sum(dim=red)
        if shards > 1:
            s1, s2 = dist.all_reduce_sum(torch.stack([s1, s2]),
                                         batch_group()).unbind(0)
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


def _norm_over(x, red, eps):
    mean = x.mean(dim=red, keepdim=True)
    var = (x - mean).square().mean(dim=red, keepdim=True)
    return (x - mean) * torch.rsqrt(var + eps)


def instance_norm(data, gamma, beta, eps=1e-3):
    """Normalize each (sample, channel) over its spatial dims (the biased
    variance), then scale by gamma and shift by beta per channel."""
    out = _norm_over(data, tuple(range(2, data.dim())), eps)
    shape = (1, -1) + (1,) * (data.dim() - 2)
    return out * gamma.reshape(shape) + beta.reshape(shape)


def group_norm(data, gamma, beta, num_groups=1, eps=1e-5):
    """Normalize over each group of channels and the spatial dims, then
    scale and shift per channel."""
    b, c = data.shape[:2]
    x = data.reshape((b, num_groups, c // num_groups) + data.shape[2:])
    out = _norm_over(x, tuple(range(2, x.dim())), eps).reshape(data.shape)
    shape = (1, -1) + (1,) * (data.dim() - 2)
    return out * gamma.reshape(shape) + beta.reshape(shape)


# sqrt(1/2) rounded to each dtype, as jax.nn.gelu rounds its constant
_SQRT_HALF = {dt: float(torch.tensor(math.sqrt(0.5), dtype=dt))
              for dt in (torch.float32, torch.bfloat16, torch.float16)}


def _gelu(x):
    """erf GELU, 0.5·x·erfc(-x·sqrt(1/2)) op by op in x's dtype, as
    ``jax.nn.gelu(approximate=False)`` writes it (its constant rounded to
    x's dtype too)."""
    return 0.5 * x * torch.erfc(-x * _SQRT_HALF[x.dtype])


def _gelu_tanh(x):
    """The tanh approximation of GELU, as ``jax.nn.gelu(approximate=True)``
    writes it."""
    c = math.sqrt(2 / math.pi)
    return 0.5 * x * (1 + torch.tanh(c * (x + 0.044715 * x ** 3)))


_ACTIVATIONS = {
    "relu": torch.relu, "tanh": torch.tanh, "gelu": _gelu,
    "sigmoid": torch.sigmoid, "gelu_tanh": _gelu_tanh,
    "softrelu": lambda x: torch.logaddexp(x, torch.zeros_like(x)),
    "softsign": lambda x: x / (1 + x.abs()),
    "silu": lambda x: x * torch.sigmoid(x)}


def activation(data, act_type="relu"):
    """Elementwise activation: relu, sigmoid, tanh, softrelu (softplus),
    softsign, gelu (erf), gelu_tanh, silu."""
    fn = _ACTIVATIONS.get(act_type)
    if fn is None:
        raise MXNetError(f"activation: act_type {act_type!r} is not ported; "
                         f"ported: {sorted(_ACTIVATIONS)}")
    return fn(data)


_SELU = (1.6732632423543772, 1.0507009873554805)


def leaky_relu(data, gamma=None, act_type="leaky", slope=0.25,
               lower_bound=0.125, upper_bound=0.334):
    """The LeakyReLU family: leaky (``slope``), prelu (a learned slope
    ``gamma`` per channel, or one), elu, selu, gelu, and rrelu at its
    inference slope (the midpoint of its bounds)."""
    if act_type == "leaky":
        return torch.where(data >= 0, data, slope * data)
    if act_type == "prelu":
        g = gamma
        if g.numel() > 1:
            g = g.reshape((1, -1) + (1,) * (data.dim() - 2)) \
                if data.dim() > 1 else g.reshape(-1)
        return torch.where(data >= 0, data, g * data)
    if act_type == "elu":
        return torch.where(data >= 0, data, slope * torch.expm1(data))
    if act_type == "selu":
        alpha, scale = _SELU
        return scale * torch.where(data >= 0, data,
                                   alpha * torch.expm1(data))
    if act_type == "gelu":
        return _gelu(data)
    if act_type == "rrelu":
        mid = (lower_bound + upper_bound) / 2
        return torch.where(data >= 0, data, mid * data)
    raise MXNetError(f"LeakyReLU: unknown act_type {act_type!r}")


def softmin(data, axis=-1):
    """softmax of the negated input."""
    return softmax(-data, axis=axis)


def pad(data, mode="constant", pad_width=(), constant_value=0.0):
    """Pad in constant, edge or reflect mode; ``pad_width`` is MXNet's
    flat (before, after) per axis.  Edge and reflect pad the trailing 1
    to 3 axes only, the leading ones unpadded, as MXNet's Pad."""
    pw = [int(v) for v in pad_width]
    pairs = [(pw[2 * i], pw[2 * i + 1]) for i in range(len(pw) // 2)]
    if mode == "constant":
        flat = [v for pr in reversed(pairs) for v in pr]
        return F.pad(data, flat, value=float(constant_value))
    if mode not in ("edge", "reflect"):
        raise MXNetError(f"pad: unknown mode {mode!r}")
    lead = 0
    while lead < len(pairs) and pairs[lead] == (0, 0):
        lead += 1
    if len(pairs) - lead > 3:
        raise MXNetError("pad: edge/reflect pad at most the last 3 axes")
    flat = [v for pr in reversed(pairs[lead:]) for v in pr]
    rest = data.shape[:lead]
    x = data.reshape((1, -1) + tuple(data.shape[lead:]))
    out = F.pad(x, flat, mode="replicate" if mode == "edge" else "reflect")
    return out.reshape(tuple(rest) + tuple(out.shape[2:]))


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
    # a mirror segment's recompute reuses the mask its first pass drew
    mask = _graphs.segment_value(
        lambda: draw(tuple(shape), generator, data.device) < keep)
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
    values tie alike (SSD's hard-negative ranking).  An integer or bool
    input is float32 first, as jax.nn.log_softmax promotes it."""
    x = data / temperature if temperature else data
    if not x.is_floating_point():
        x = x.to(torch.float32)
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


class _LogAddExp(torch.autograd.Function):
    """log(exp(a) + exp(b)) with jnp.logaddexp's derivative,
    exp(a - out) and exp(b - out): where -1e30 absorbs both terms (a
    label no alignment can emit) each gets the whole cotangent, where
    torch.logaddexp's gives each half."""

    @staticmethod
    def forward(ctx, a, b):
        out = torch.logaddexp(a, b)
        ctx.save_for_backward(a, b, out)
        return out

    @staticmethod
    def backward(ctx, g):
        a, b, out = ctx.saved_tensors
        return g * torch.exp(a - out), g * torch.exp(b - out)


def ctc_loss(data, label, data_lengths=None, label_lengths=None,
             use_data_lengths=False, use_label_lengths=False,
             blank_label="first"):
    """The CTC loss per sequence, -log p(label | data), as the JAX op
    computes it.

    data: (T, N, alphabet) activations before the softmax.  label:
    (N, L), padded with 0 or -1 when the blank is ``first`` (index 0;
    real labels > 0), with -1 when it is ``last`` (index alphabet - 1;
    real labels >= 0).  ``data_lengths`` are clipped into [1, T]; the
    loss reads the last valid frame's alpha at 2·len and 2·len - 1 of
    the extended label."""
    seq_len, batch, alphabet = data.shape
    logp = log_softmax(data, axis=-1)
    blank = 0 if blank_label == "first" else alphabet - 1
    lab = label.to(torch.int32).long()
    n_lab = lab.shape[1]
    lab_valid = lab > 0 if blank_label == "first" else lab >= 0
    lab_len = lab_valid.sum(1) if not use_label_lengths \
        else label_lengths.to(torch.int32).long()
    dev = data.device
    ext = torch.full((batch, 2 * n_lab + 1), blank, dtype=torch.long,
                     device=dev)
    ext[:, 1::2] = torch.where(lab_valid, lab, blank)
    adt = torch.float64 if logp.dtype == torch.float64 else torch.float32
    neg_inf = -1e30
    alpha = torch.full((batch, 2 * n_lab + 1), neg_inf, dtype=adt,
                       device=dev)
    alpha[:, 0] = logp[0, :, blank]
    alpha[:, 1] = logp[0].gather(1, ext[:, 1:2])[:, 0]
    pad1 = torch.full((batch, 1), neg_inf, dtype=adt, device=dev)
    pad2 = torch.full((batch, 2), neg_inf, dtype=adt, device=dev)
    ext_shift = torch.cat([torch.full((batch, 2), -2, dtype=torch.long,
                                      device=dev), ext[:, :-2]], 1)
    allow_skip = (ext != blank) & (ext != ext_shift)
    alphas = [alpha]
    for t in range(1, seq_len):
        prev1 = torch.cat([pad1, alpha[:, :-1]], 1)
        prev2 = torch.cat([pad2, alpha[:, :-2]], 1)
        merged = _LogAddExp.apply(alpha, prev1)
        merged = torch.where(allow_skip, _LogAddExp.apply(merged, prev2),
                             merged)
        alpha = merged + logp[t].gather(1, ext)
        alphas.append(alpha)
    alphas = torch.stack(alphas)
    if use_data_lengths and data_lengths is not None:
        dl = data_lengths.to(torch.int32).long().clamp(1, seq_len)
    else:
        dl = torch.full((batch,), seq_len, dtype=torch.long, device=dev)
    alpha_t = alphas.gather(0, (dl - 1).reshape(1, batch, 1).expand(
        1, batch, alphas.shape[2]))[0]
    a1 = alpha_t.gather(1, (2 * lab_len)[:, None])[:, 0]
    a2 = alpha_t.gather(1, (2 * lab_len - 1).clamp_min(0)[:, None])[:, 0]
    return -_LogAddExp.apply(a1, a2)


def _bn_nout(attrs):
    return 3 if attrs.get("train", False) else 1


for _name, _fn in (("FullyConnected", fully_connected),
                   ("Convolution", convolution), ("Pooling", pooling),
                   ("Deconvolution", deconvolution),
                   ("InstanceNorm", instance_norm),
                   ("GroupNorm", group_norm), ("LeakyReLU", leaky_relu),
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
register_op("CTCLoss", aliases=("ctc_loss",))(ctc_loss)
for _name, _snake, _kind in (
        ("LinearRegressionOutput", "linear_regression_output", "linear"),
        ("MAERegressionOutput", "mae_regression_output", "mae"),
        ("LogisticRegressionOutput", "logistic_regression_output",
         "logistic")):
    register_op(_name, aliases=(_snake,))(_regression_head(_kind))
register_op("softmax")(softmax)
register_op("log_softmax")(log_softmax)
register_op("softmin")(softmin)
register_op("pad", aliases=("Pad",))(pad)


# ---------------------------------------------------------------------------
# RMSNorm, the activations hard_sigmoid/hard_swish/mish, SoftmaxActivation
# ---------------------------------------------------------------------------

def rms_norm(data, gamma, axis=-1, eps=1e-6):
    """data over the root mean square along ``axis``, times gamma (no
    mean subtracted)."""
    ms = data.square().mean(dim=axis, keepdim=True)
    return data * torch.rsqrt(ms + eps) * gamma


def hard_sigmoid(data, alpha=0.2, beta=0.5):
    return torch.clamp(alpha * data + beta, 0.0, 1.0)


def hard_swish(data):
    return data * torch.clamp(data / 6.0 + 0.5, 0.0, 1.0)


def mish(data):
    """x·tanh(softplus(x)), softplus as jax.nn.softplus writes it
    (logaddexp(x, 0))."""
    return data * torch.tanh(torch.logaddexp(data, torch.zeros_like(data)))


def softmax_activation(data, mode="instance"):
    """softmax over axis 1 (``channel``) or over all but the first axis
    (``instance``)."""
    if mode == "channel":
        return softmax(data, axis=1)
    flat = data.reshape(data.shape[0], -1)
    return softmax(flat, axis=-1).reshape(data.shape)


# ---------------------------------------------------------------------------
# SVMOutput: the identity forward, the hinge gradient backward (the
# upstream gradient is ignored, as for the other loss heads)
# ---------------------------------------------------------------------------

class _SVMOutputFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, data, label, margin, reg_coef, use_linear):
        ctx.save_for_backward(data, label)
        ctx.conf = (margin, reg_coef, use_linear)
        return data.clone()

    @staticmethod
    def backward(ctx, g):
        scores, label = ctx.saved_tensors
        margin, reg_coef, use_linear = ctx.conf
        classes = torch.arange(scores.shape[-1], device=scores.device)
        y = (label.to(torch.int32).unsqueeze(-1) == classes).to(
            scores.dtype)
        s_y = (scores * y).sum(dim=-1, keepdim=True)
        viol = torch.clamp_min(margin - (s_y - scores), 0.0) * (1.0 - y)
        gj = (viol > 0).to(scores.dtype) if use_linear else 2.0 * viol
        grad = gj - y * gj.sum(dim=-1, keepdim=True)
        glabel = torch.zeros_like(label) if ctx.needs_input_grad[1] \
            else None
        return reg_coef * grad / scores.shape[0], glabel, None, None, None


def svm_output(data, label, margin=1.0, regularization_coefficient=1.0,
               use_linear=False):
    """Multiclass SVM head: forward the identity; backward the hinge
    gradient (squared hinge unless ``use_linear``) times the coefficient
    over the batch."""
    return _SVMOutputFn.apply(data, label, float(margin),
                              float(regularization_coefficient),
                              bool(use_linear))


# ---------------------------------------------------------------------------
# UpSampling and the spatial transformer family (NCHW)
# ---------------------------------------------------------------------------

def upsampling(*datas, scale=1, sample_type="nearest", num_args=1,
               num_filter=0, multi_input_mode="concat", workspace=512):
    """Each input upsampled to the first one's size times ``scale``:
    ``nearest`` repeats pixels, ``bilinear`` interpolates with half-pixel
    centres (jax.image.resize's bilinear, which is F.interpolate's with
    align_corners=False when upsampling); several inputs are then
    concatenated on channels or summed."""
    scale = int(scale)
    th, tw = datas[0].shape[2] * scale, datas[0].shape[3] * scale
    outs = []
    for d in datas:
        if sample_type == "nearest":
            up = d.repeat_interleave(th // d.shape[2], dim=2) \
                .repeat_interleave(tw // d.shape[3], dim=3)
        elif sample_type == "bilinear":
            up = F.interpolate(d, size=(th, tw), mode="bilinear",
                               align_corners=False)
        else:
            raise MXNetError(f"UpSampling: unknown sample_type "
                             f"{sample_type!r}")
        outs.append(up)
    if len(outs) == 1:
        return outs[0]
    if multi_input_mode == "sum":
        out = outs[0]
        for o in outs[1:]:
            out = out + o
        return out
    return torch.cat(outs, dim=1)


def _bilinear_taps(data, y, x):
    """data (N, C, H, W) at absolute coordinates y, x (N, Ho, Wo):
    bilinear over the four neighbours, a neighbour outside the image
    counting as zero; (N, C, Ho, Wo)."""
    n, _, h, w = data.shape
    b = torch.arange(n, device=data.device).reshape(n, 1, 1)
    y0 = torch.floor(y)
    x0 = torch.floor(x)
    wy = (y - y0)[:, None].to(data.dtype)
    wx = (x - x0)[:, None].to(data.dtype)

    def tap(yi, xi):
        inb = (yi >= 0) & (yi <= h - 1) & (xi >= 0) & (xi <= w - 1)
        yc = yi.clamp(0, h - 1).long()
        xc = xi.clamp(0, w - 1).long()
        v = data[b, :, yc, xc].permute(0, 3, 1, 2)
        return v * inb[:, None].to(data.dtype)

    return ((1 - wy) * ((1 - wx) * tap(y0, x0) + wx * tap(y0, x0 + 1))
            + wy * ((1 - wx) * tap(y0 + 1, x0) + wx * tap(y0 + 1, x0 + 1)))


def bilinear_sampler(data, grid, cudnn_off=False):
    """data sampled at the normalised coordinates of ``grid`` (N, 2, Ho,
    Wo; x then y, -1 and 1 the centres of the edge pixels), zero
    outside."""
    h, w = data.shape[2], data.shape[3]
    gx = (grid[:, 0] + 1.0) * (w - 1) / 2.0
    gy = (grid[:, 1] + 1.0) * (h - 1) / 2.0
    return _bilinear_taps(data, gy, gx)


def _linspace(n, device):
    """jnp.linspace(-1, 1, n) as JAX computes it: -(1 - t) + t at t =
    i / (n - 1), the end point exact."""
    div = n - 1
    if div < 1:
        return torch.full((n,), -1.0, device=device)
    t = torch.arange(div, dtype=torch.float32, device=device) / div
    return torch.cat([-1.0 * (1 - t) + 1.0 * t,
                      torch.ones(1, device=device)])


def grid_generator(data, transform_type="affine", target_shape=(0, 0)):
    """A sampling grid: ``affine`` maps the target's normalised
    coordinates by the (N, 6) matrices in data; ``warp`` adds the (N, 2,
    H, W) pixel offsets in data to the pixel coordinates."""
    if transform_type == "affine":
        th, tw = int(target_shape[0]), int(target_shape[1])
        if th <= 0 or tw <= 0:
            raise MXNetError("GridGenerator(affine) needs target_shape")
        theta = data.reshape(-1, 2, 3).to(torch.float32)
        gy, gx = torch.meshgrid(_linspace(th, data.device),
                                _linspace(tw, data.device), indexing="ij")
        base = torch.stack([gx.reshape(-1), gy.reshape(-1),
                            torch.ones(th * tw, device=data.device)])
        return (theta @ base).reshape(-1, 2, th, tw)
    if transform_type == "warp":
        h, w = data.shape[2], data.shape[3]
        gy, gx = torch.meshgrid(torch.arange(h, device=data.device),
                                torch.arange(w, device=data.device),
                                indexing="ij")
        fx = (gx[None] + data[:, 0]) * 2.0 / max(w - 1, 1) - 1.0
        fy = (gy[None] + data[:, 1]) * 2.0 / max(h - 1, 1) - 1.0
        return torch.stack([fx, fy], dim=1)
    raise MXNetError(f"GridGenerator: unknown transform_type "
                     f"{transform_type!r}")


def spatial_transformer(data, loc, target_shape=(0, 0),
                        transform_type="affine", sampler_type="bilinear",
                        cudnn_off=False):
    """GridGenerator(affine) of ``loc`` then BilinearSampler."""
    if transform_type != "affine" or sampler_type != "bilinear":
        raise MXNetError("SpatialTransformer supports affine+bilinear")
    return bilinear_sampler(data, grid_generator(
        loc, transform_type="affine", target_shape=target_shape))


# ---------------------------------------------------------------------------
# im2col / col2im (any number of spatial axes), Correlation, and
# DeformableConvolution (DCN v1)
# ---------------------------------------------------------------------------

def _patches(x, kernel, stride, dilate, pad, value=0):
    """x (N, C, *S) -> (N, C*prod(kernel), L): each output position's
    window, channel-major then the kernel taps, as
    lax.conv_general_dilated_patches orders them."""
    nd = len(kernel)
    stride = tuple(stride) if stride else (1,) * nd
    dilate = tuple(dilate) if dilate else (1,) * nd
    pad = tuple(pad) if pad else (0,) * nd
    x = F.pad(x, [p for pp in reversed(pad) for p in (pp, pp)],
              value=value)
    for i, (k, s, d) in enumerate(zip(kernel, stride, dilate)):
        x = x.unfold(2 + i, (k - 1) * d + 1, s)[..., ::d]
    n, c = x.shape[:2]
    outs = x.shape[2:2 + nd]
    perm = (0, 1) + tuple(range(2 + nd, 2 + 2 * nd)) \
        + tuple(range(2, 2 + nd))
    return x.permute(perm).reshape(n, c * math.prod(kernel),
                                   math.prod(outs))


def im2col(data, kernel=(), stride=(), dilate=(), pad=()):
    """The sliding windows of data (N, C, *S) as columns (N,
    C*prod(kernel), L)."""
    return _patches(data, kernel, stride, dilate, pad)


def col2im(data, output_size=(), kernel=(), stride=(), dilate=(), pad=()):
    """The adjoint of im2col: columns summed back into an image of
    ``output_size`` (overlapping windows add up, padding taps drop)."""
    n, ck, _ = data.shape
    c = ck // math.prod(kernel)
    spatial = tuple(output_size)
    size = c * math.prod(spatial)
    ids = torch.arange(size, device=data.device).reshape((1, c) + spatial)
    # slot 0 collects the padding taps (id -1)
    slot = _patches(ids, kernel, stride, dilate, pad, value=-1) \
        .reshape(-1) + 1
    out = torch.zeros((n, size + 1), dtype=data.dtype, device=data.device)
    out = out.index_add(1, slot, data.reshape(n, -1))
    return out[:, 1:].reshape((n, c) + spatial)


def correlation(data1, data2, kernel_size=1, max_displacement=1, stride1=1,
                stride2=1, pad_size=0, is_multiply=True):
    """FlowNet's cost volume: for each displacement within
    ``max_displacement``, the channel mean of data1 times (or minus,
    absolute) data2 shifted; (N, (2d+1)^2, Ho, Wo)."""
    if kernel_size != 1 or stride1 != 1 or stride2 != 1:
        raise MXNetError("Correlation: this build supports "
                         "kernel_size=1, stride1=1, stride2=1")
    h, w = data1.shape[2], data1.shape[3]
    d, p = int(max_displacement), int(pad_size)
    ho, wo = h + 2 * p - 2 * d, w + 2 * p - 2 * d
    if ho <= 0 or wo <= 0:
        raise MXNetError(
            f"Correlation: non-positive output size {(ho, wo)}; "
            f"pad_size must satisfy in + 2*pad > 2*max_displacement")
    f1 = F.pad(data1, (p, p, p, p))
    f2 = F.pad(data2, (p, p, p, p))
    base = f1[:, :, d:d + ho, d:d + wo]
    outs = []
    for dy in range(-d, d + 1):
        for dx in range(-d, d + 1):
            shifted = f2[:, :, d + dy:d + dy + ho, d + dx:d + dx + wo]
            outs.append((base * shifted).mean(dim=1) if is_multiply
                        else (base - shifted).abs().mean(dim=1))
    return torch.stack(outs, dim=1)


def deformable_convolution(data, offset, weight, bias=None, kernel=(),
                           stride=(), dilate=(), pad=(), num_filter=0,
                           num_group=1, num_deformable_group=1,
                           no_bias=False, layout=None, workspace=1024):
    """Deformable convolution v1: each kernel tap reads the input by
    bilinear interpolation at its position plus the learned ``offset``
    (N, 2*prod(kernel), Ho, Wo; y then x per tap), then the taps contract
    with the weight."""
    if num_group != 1 or num_deformable_group != 1:
        raise MXNetError("DeformableConvolution: this build supports "
                         "num_group=num_deformable_group=1")
    kh, kw = kernel
    sh, sw = stride if stride else (1, 1)
    dh, dw = dilate if dilate else (1, 1)
    ph, pw = pad if pad else (0, 0)
    n, c, h, w = data.shape
    ho = (h + 2 * ph - (dh * (kh - 1) + 1)) // sh + 1
    wo = (w + 2 * pw - (dw * (kw - 1) + 1)) // sw + 1
    if tuple(offset.shape) != (n, 2 * kh * kw, ho, wo):
        raise MXNetError(
            f"DeformableConvolution: offset must be "
            f"{(n, 2 * kh * kw, ho, wo)} (N, 2*prod(kernel), out_h, "
            f"out_w); got {tuple(offset.shape)}")
    oy, ox = torch.meshgrid(
        torch.arange(ho, device=data.device) * sh - ph,
        torch.arange(wo, device=data.device) * sw - pw, indexing="ij")
    cols = []
    for ki in range(kh):
        for kj in range(kw):
            t = ki * kw + kj
            cols.append(_bilinear_taps(data, oy + ki * dh + offset[:, 2 * t],
                                       ox + kj * dw + offset[:, 2 * t + 1]))
    cols = torch.stack(cols, dim=2)                  # (N, C, K, Ho, Wo)
    out = torch.einsum("ock,nckhw->nohw",
                       weight.reshape(num_filter, c, kh * kw), cols)
    if bias is not None and not no_bias:
        out = out + bias.reshape(1, -1, 1, 1)
    return out


for _name, _alias, _fn in (
        ("RMSNorm", "rms_norm", rms_norm),
        ("UpSampling", "upsampling", upsampling),
        ("BilinearSampler", "bilinear_sampler", bilinear_sampler),
        ("GridGenerator", "grid_generator", grid_generator),
        ("SpatialTransformer", "spatial_transformer", spatial_transformer),
        ("SoftmaxActivation", "softmax_activation", softmax_activation),
        ("SVMOutput", "svm_output", svm_output),
        ("Correlation", "correlation", correlation)):
    register_op(_name, aliases=(_alias,))(_fn)
for _fn in (hard_sigmoid, hard_swish, mish, im2col, col2im):
    register_op(_fn.__name__)(_fn)
register_op("_contrib_DeformableConvolution",
            aliases=("DeformableConvolution", "deformable_convolution"))(
    deformable_convolution)
