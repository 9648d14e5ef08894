"""Tensor ops: those of the training loss (pick, mean, sum), of BERT's
forward (arange_like, expand_dims, squeeze, slice_axis, cast,
broadcast_add, broadcast_lesser), and those NDArray's operators and
methods call (the broadcast and ``*_scalar`` arithmetic, the
comparisons, negative, abs, matmul, max/min/norm/argmax, reshape with
MXNet's special codes, transpose), concat (``nd.concatenate``, the
Transformer's greedy decoding), and those of SSD's loss and decoder
(zeros_like, ones_like, clip, broadcast_maximum/minimum, exp, log,
sqrt, smooth_l1 and the ordering ops sort, argsort and topk).

The ordering ops keep the JAX package's order among equal values, on
which SSD's hard-negative mining depends: ``argsort`` is a stable
ascending sort, flipped for ``is_ascend=False`` (so the later index of
a tie comes first there; ``torch.argsort(descending=True,
stable=True)`` would put the earlier one first), and ``topk`` follows
``lax.top_k`` (the lower index of a tie first, +0.0 above -0.0, which
argsort takes as equal).

Counterpart of the same registered ops in ``mxnet_tpu/ops/tensor.py``,
as plain functions on tensors, registered under the JAX package's
names (``ops/registry.py``).  The dtype rules are the JAX package's
(x32 mode): a ``*_scalar`` op first casts its scalar to x's dtype (an
int array truncates 2.7 to 2), comparisons return 1/0 in the operands'
result dtype, integer sums stay int32 and argmax/argmin return float32.
The other JAX tensor ops wait (ROADMAP queue A item 3).
"""
from __future__ import annotations

import functools

import torch

from ..base import MXNetError, dtype_of
from .registry import register_op

__all__ = ["pick", "mean", "sum", "arange_like", "expand_dims", "squeeze",
           "slice_axis", "cast", "broadcast_add", "broadcast_lesser",
           "reshape", "transpose", "concat", "max", "min", "norm",
           "argmax", "zeros_like", "ones_like", "clip", "broadcast_maximum",
           "broadcast_minimum", "smooth_l1", "sort", "argsort", "topk"]


def pick(x, index, axis=-1, keepdims=False, mode="clip"):
    """Select one element along ``axis`` per position of ``index``.  The
    index is clamped into range (``mode="clip"``); it never raises on an
    out-of-range index."""
    if mode != "clip":
        raise MXNetError(f"pick: mode={mode!r} is not ported (clip only)")
    axis = axis % x.dim()
    idx = index.to(device=x.device, dtype=torch.long)
    idx = idx.clamp(0, x.shape[axis] - 1).unsqueeze(axis)
    out = torch.gather(x, axis, idx)
    return out if keepdims else out.squeeze(axis)


def _axes(x, axis, exclude):
    if axis is None:
        return tuple(range(x.dim()))
    ax = (axis,) if isinstance(axis, int) else tuple(axis)
    ax = tuple(a % x.dim() for a in ax)
    if exclude:
        ax = tuple(i for i in range(x.dim()) if i not in ax)
    return ax


def mean(x, axis=None, keepdims=False, exclude=False):
    ax = _axes(x, axis, exclude)
    if not ax:
        return x
    if not x.is_floating_point():
        x = x.float()  # jnp.mean of an integer array is float32
    return x.mean(dim=ax, keepdim=keepdims)


def _int32(out, x):
    """Integer and bool reductions stay int32, as in x32 JAX (torch
    gives int64)."""
    return out.to(torch.int32) if out.dtype == torch.int64 \
        and x.dtype != torch.int64 else out


def sum(x, axis=None, keepdims=False, exclude=False):  # noqa: A001 — op name
    ax = _axes(x, axis, exclude)
    return _int32(x.sum(dim=ax, keepdim=keepdims), x) if ax else x


def max(x, axis=None, keepdims=False, exclude=False):  # noqa: A001 — op name
    ax = _axes(x, axis, exclude)
    return x.amax(dim=ax, keepdim=keepdims) if ax else x


def min(x, axis=None, keepdims=False, exclude=False):  # noqa: A001 — op name
    ax = _axes(x, axis, exclude)
    return x.amin(dim=ax, keepdim=keepdims) if ax else x


def norm(x, ord=2, axis=None, keepdims=False):  # noqa: A002 — attr name
    """L1 or L2 norm over ``axis`` (ord in {1, 2})."""
    ax = _axes(x, axis, False)
    if ord == 1:
        return x.abs().sum(dim=ax, keepdim=keepdims)
    return x.square().sum(dim=ax, keepdim=keepdims).sqrt()


def argmax(x, axis=None, keepdims=False):
    """Index of the first maximum along ``axis`` (flat when None), as
    float32."""
    if axis is None:
        out = torch.argmax(x.reshape(-1))
        return (out.reshape([1] * x.dim()) if keepdims else out).float()
    return torch.argmax(x, dim=axis, keepdim=keepdims).float()


def arange_like(x, axis=None, start=0.0, step=1.0, dtype="float32"):
    """start + step * arange shaped like ``x`` (axis None) or along one of
    its axes, on x's device, in ``dtype`` (float32 by default)."""
    dt = dtype_of(dtype)
    n = x.numel() if axis is None else x.shape[axis]
    out = start + step * torch.arange(n, dtype=dt, device=x.device)
    return out.reshape(x.shape) if axis is None else out


def expand_dims(x, axis=0):
    return x.unsqueeze(axis)


def squeeze(x, axis=None):
    """Drop size-1 axes (all of them when ``axis`` is None)."""
    return x.squeeze() if axis is None else x.squeeze(axis)


def slice_axis(x, axis=0, begin=0, end=None):
    """[begin, end) along one axis (a view)."""
    idx = [slice(None)] * x.dim()
    idx[axis] = slice(begin, end)
    return x[tuple(idx)]


def cast(x, dtype="float32"):
    return x.to(dtype_of(dtype))


def broadcast_add(a, b):
    return a + b


def broadcast_lesser(a, b):
    """a < b as 1/0 in the operands' result dtype (float32 for a non-
    numeric one), as the JAX package's comparison table returns it."""
    rt = torch.result_type(a, b)
    return (a < b).to(torch.float32 if rt == torch.bool else rt)


def zeros_like(x):
    return torch.zeros_like(x)


def ones_like(x):
    return torch.ones_like(x)


def clip(x, a_min=None, a_max=None):
    """Clamp every element to [a_min, a_max] (a bound of None is open)."""
    return torch.clamp(x, a_min, a_max)


def broadcast_maximum(a, b):
    return torch.maximum(a, b)


def broadcast_minimum(a, b):
    return torch.minimum(a, b)


def smooth_l1(x, scalar=1.0):
    """Smooth L1: 0.5·s²·x² where |x| < 1/s², |x| - 0.5/s² beyond, with
    the constants formed in Python first, as the JAX package writes it."""
    s2 = scalar * scalar
    ax = x.abs()
    return torch.where(ax < 1.0 / s2, 0.5 * s2 * x.square(),
                       ax - 0.5 / s2)


# ---------------------------------------------------------------------------
# ordering (the JAX package's order among equal values; module docstring)
# ---------------------------------------------------------------------------

def sort(x, axis=-1, is_ascend=True):
    """Values along ``axis``; descending is the ascending sort flipped."""
    out = torch.sort(x, dim=axis, stable=True).values
    return out if is_ascend else torch.flip(out, (axis,))


def argsort(x, axis=-1, is_ascend=True, dtype="float32"):
    """The stable ascending sorting permutation along ``axis`` (flipped
    for ``is_ascend=False``), cast to ``dtype`` (float indices, as in
    MXNet)."""
    out = torch.argsort(x, dim=axis, stable=True)
    if not is_ascend:
        out = torch.flip(out, (axis,))
    return out.to(dtype_of(dtype))


def _total_order(x):
    """An integer key that orders floats as ``lax.top_k`` does (-0.0
    below +0.0); integers are their own key."""
    if not x.is_floating_point():
        return x
    bits = x.float().view(torch.int32)
    return torch.where(bits < 0, bits ^ 0x7FFFFFFF, bits)


def topk(x, axis=-1, k=1, ret_typ="indices", is_ascend=False,
         dtype="float32"):
    """The k largest (``is_ascend=False``) or smallest values along
    ``axis``, in that order, the lower index first among equal values
    (``lax.top_k`` on x, or on -x when ascending); ``ret_typ`` is
    "indices", "value" or "both" (values, indices)."""
    key = _total_order(-x if is_ascend else x)
    idx = torch.sort(key, dim=axis, descending=True,
                     stable=True).indices.narrow(axis, 0, k)
    if ret_typ == "value":
        return torch.gather(x, axis, idx)
    if ret_typ == "both":
        return torch.gather(x, axis, idx), idx.to(dtype_of(dtype))
    return idx.to(dtype_of(dtype))


# ---------------------------------------------------------------------------
# shapes
# ---------------------------------------------------------------------------

def reshape(x, shape=(), reverse=False):
    """Reshape with MXNet's special codes: 0 keep, -1 infer, -2 copy the
    rest, -3 merge two, -4 split one into the next two."""
    if reverse:
        raise MXNetError("reshape: reverse=True is not ported")
    shape = list(shape)
    if not any(s in (0, -2, -3, -4) for s in shape):
        return x.reshape(tuple(shape))
    src = list(x.shape)
    out = []
    si = k = 0
    while k < len(shape):
        s = shape[k]
        if s == 0:
            out.append(src[si])
            si += 1
        elif s == -2:
            out.extend(src[si:])
            si = len(src)
        elif s == -3:
            out.append(src[si] * src[si + 1])
            si += 2
        elif s == -4:
            a, b = shape[k + 1], shape[k + 2]
            if a == -1:
                a = src[si] // b
            if b == -1:
                b = src[si] // a
            out.extend([a, b])
            si += 1
            k += 2
        else:
            out.append(s)
            if s != -1:
                si += 1
        k += 1
    return x.reshape(tuple(out))


def concat(*xs, dim=1, num_args=None):
    """Concatenate along ``dim`` (Concat's channel axis by default)."""
    return torch.cat(xs, dim=dim)


def transpose(x, axes=None):
    """Permute axes (reverse them all when ``axes`` is None)."""
    return x.permute(tuple(axes) if axes else tuple(range(x.dim()))[::-1])


# ---------------------------------------------------------------------------
# elementwise, scalar and broadcast tables
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=1024)
def _scalar_as(value, dtype: torch.dtype):
    """A Python scalar cast to ``dtype`` as jnp.asarray(value, dtype)
    casts it: rounded for a float dtype, truncated for an integer one."""
    if dtype.is_floating_point:
        return float(torch.tensor(float(value), dtype=dtype))
    if dtype == torch.bool:
        return bool(value)
    return int(value)


def _scalar_op(fn, swap):
    if swap:
        return lambda x, scalar=1.0: fn(_scalar_as(scalar, x.dtype), x)
    return lambda x, scalar=1.0: fn(x, _scalar_as(scalar, x.dtype))


def _as_result(out, a, b=None):
    """1/0 in the operands' result dtype, float32 for bool operands."""
    rt = a.dtype if b is None else torch.result_type(a, b)
    return out.to(torch.float32 if rt == torch.bool else rt)


_UNARY = {"abs": torch.abs, "negative": torch.negative, "exp": torch.exp,
          "log": torch.log, "sqrt": torch.sqrt}
_BINARY = {
    "broadcast_sub": torch.sub, "broadcast_mul": torch.mul,
    "broadcast_div": torch.true_divide, "broadcast_mod": torch.remainder,
    "broadcast_power": torch.pow, "broadcast_maximum": broadcast_maximum,
    "broadcast_minimum": broadcast_minimum,
}
_CMP = {
    "broadcast_equal": torch.eq, "broadcast_not_equal": torch.ne,
    "broadcast_greater": torch.gt, "broadcast_greater_equal": torch.ge,
    "broadcast_lesser_equal": torch.le,
}
_SCALAR = {
    "_plus_scalar": (torch.add, False), "_minus_scalar": (torch.sub, False),
    "_rminus_scalar": (lambda s, x: s - x, True),
    "_mul_scalar": (torch.mul, False),
    "_div_scalar": (torch.true_divide, False),
    "_rdiv_scalar": (lambda s, x: s / x, True),
    "_mod_scalar": (torch.remainder, False),
    "_power_scalar": (torch.pow, False),
    "_rpower_scalar": (lambda s, x: torch.pow(s, x), True),
}
_SCALAR_CMP = {
    "_equal_scalar": torch.eq, "_not_equal_scalar": torch.ne,
    "_greater_scalar": torch.gt, "_greater_equal_scalar": torch.ge,
    "_lesser_scalar": torch.lt, "_lesser_equal_scalar": torch.le,
}


def _register():
    from . import nn as _nn

    for name, fn in _UNARY.items():
        register_op(name)(functools.partial(lambda x, _f: _f(x), _f=fn))
    for name, fn in _BINARY.items():
        register_op(name)(functools.partial(lambda a, b, _f: _f(a, b),
                                            _f=fn))
    for name, fn in _CMP.items():
        register_op(name, differentiable=False)(functools.partial(
            lambda a, b, _f: _as_result(_f(a, b), a, b), _f=fn))
    for name, (fn, swap) in _SCALAR.items():
        register_op(name)(_scalar_op(fn, swap))
    for name, fn in _SCALAR_CMP.items():
        register_op(name, differentiable=False)(functools.partial(
            lambda x, scalar=1.0, _f=None: _as_result(
                _f(x, _scalar_as(scalar, x.dtype)
                   if x.is_floating_point() else scalar), x), _f=fn))
    register_op("broadcast_add")(broadcast_add)
    register_op("broadcast_lesser", differentiable=False)(broadcast_lesser)
    register_op("_arange_like", aliases=("arange_like",),
                differentiable=False)(arange_like)
    register_op("cast", aliases=("Cast",))(cast)
    register_op("sum", aliases=("sum_axis",))(sum)
    register_op("mean")(mean)
    register_op("max", aliases=("max_axis",))(max)
    register_op("min", aliases=("min_axis",))(min)
    register_op("norm")(norm)
    register_op("argmax", differentiable=False)(argmax)
    register_op("reshape", aliases=("Reshape",))(reshape)
    register_op("transpose")(transpose)
    register_op("concat", aliases=("Concat",))(concat)
    register_op("flatten", aliases=("Flatten",))(_nn.flatten)
    register_op("expand_dims")(expand_dims)
    register_op("squeeze")(squeeze)
    register_op("slice_axis")(slice_axis)
    register_op("pick")(pick)
    register_op("matmul")(torch.matmul)
    register_op("zeros_like")(zeros_like)
    register_op("ones_like")(ones_like)
    register_op("clip")(clip)
    register_op("smooth_l1")(smooth_l1)
    register_op("sort", differentiable=False)(sort)
    register_op("argsort", differentiable=False)(argsort)
    register_op("topk", differentiable=False)(topk)


_register()
