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
result dtype, integer sums stay int32 and argmax/argmin return float32;
an inexact function (sin, sqrt, reciprocal, ...) of an integer or bool
array is float32, and the rounding functions keep its dtype.

Besides those, the rest of the JAX file's ops: the unary table, the
reductions prod/nansum/nanprod and argmin, broadcasting, slicing,
joining and splitting, indexing (take, one_hot, gather_nd,
scatter_nd), the Sequence* ops, dot/batch_dot, L2Normalization, diag,
cumsum/cumprod, the finiteness checks and the misc batch (trace,
ravel/unravel_index, digamma, the bitwise ops, all_finite, shape_array).
Like the JAX ops, an op that reads an index never raises on one out of
range: ``take`` clamps (``raise`` maps to ``clip``) or wraps,
``one_hot`` gives a row of ``off_value``, ``gather_nd`` clamps and
``scatter_nd`` drops the write.  The linalg names of the JAX
``tensor.py`` (``linalg_gemm2``, ``linalg_potrf``, ``linalg_syrk``,
``khatri_rao``) are registered in ``linalg.py`` with the rest of the
family.

The mixed-precision casts of ``contrib.amp`` are here too:
``amp_cast`` is ``cast`` with the JAX package's dtype map (float16 is
bfloat16), and ``amp_multicast`` casts its inputs to the widest of
their dtypes (bfloat16 < float32 < float64, any other ranking as
float32), or the narrowest with ``cast_narrow``.
"""
from __future__ import annotations

import builtins
import functools
import math

import torch

from ..base import MXNetError, dtype_of
from .registry import register_op

__all__ = ["pick", "mean", "sum", "arange_like", "expand_dims", "squeeze",
           "slice_axis", "cast", "broadcast_add", "broadcast_lesser",
           "reshape", "transpose", "concat", "max", "min", "norm",
           "argmax", "zeros_like", "ones_like", "clip", "broadcast_maximum",
           "broadcast_minimum", "smooth_l1", "sort", "argsort", "topk",
           "reshape_like", "where", "depth_to_space", "space_to_depth",
           "prod", "argmin", "broadcast_to", "broadcast_like", "stack",
           "split", "tile", "repeat", "take", "one_hot", "gather_nd",
           "scatter_nd", "sequence_mask", "sequence_last",
           "sequence_reverse", "dot", "batch_dot", "l2_normalization",
           "cumsum", "cumprod", "amp_cast", "amp_multicast"]


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


def _arg_index(fn, x, axis, keepdims):
    if axis is None:
        out = fn(x.reshape(-1))
        return (out.reshape([1] * x.dim()) if keepdims else out).float()
    return fn(x, dim=axis, keepdim=keepdims).float()


def argmax(x, axis=None, keepdims=False):
    """Index of the first maximum along ``axis`` (flat when None), as
    float32."""
    return _arg_index(torch.argmax, x, axis, keepdims)


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
    """Clamp every element to [a_min, a_max] (a bound of None is open;
    with neither, a copy of x, as jnp.clip returns x)."""
    if a_min is None and a_max is None:
        return x.clone()
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


def reshape_like(x, y):
    """x reshaped to y's shape."""
    return x.reshape(y.shape)


def where(cond, x, y):
    """``x`` where ``cond`` is nonzero, else ``y``."""
    return torch.where(cond.to(torch.bool), x, y)


def depth_to_space(x, block_size=1):
    """NCHW channel blocks into spatial blocks: (N, C/b^2, H*b, W*b)."""
    n, c, h, w = x.shape
    b = block_size
    y = x.reshape(n, b, b, c // (b * b), h, w).permute(0, 3, 4, 1, 5, 2)
    return y.reshape(n, c // (b * b), h * b, w * b)


def space_to_depth(x, block_size=1):
    """The inverse of :func:`depth_to_space`."""
    n, c, h, w = x.shape
    b = block_size
    y = x.reshape(n, c, h // b, b, w // b, b).permute(0, 3, 5, 1, 2, 4)
    return y.reshape(n, c * b * b, h // b, w // b)


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
          "log": torch.log, "sqrt": torch.sqrt, "relu": torch.relu,
          "sigmoid": torch.sigmoid, "tanh": torch.tanh,
          "square": torch.square}
_BINARY = {
    "broadcast_sub": torch.sub, "broadcast_mul": torch.mul,
    "broadcast_div": torch.true_divide, "broadcast_mod": torch.remainder,
    "broadcast_power": torch.pow, "broadcast_maximum": broadcast_maximum,
    "broadcast_minimum": broadcast_minimum,
    # the reference's elemwise (same-shape) names
    "elemwise_add": torch.add, "elemwise_sub": torch.sub,
    "elemwise_mul": torch.mul, "elemwise_div": torch.true_divide,
}
_CMP = {
    "broadcast_equal": torch.eq, "broadcast_not_equal": torch.ne,
    "broadcast_greater": torch.gt, "broadcast_greater_equal": torch.ge,
    "broadcast_lesser_equal": torch.le,
    "broadcast_logical_and": torch.logical_and,
    "broadcast_logical_or": torch.logical_or,
    "broadcast_logical_xor": torch.logical_xor,
}
_SCALAR = {
    "_plus_scalar": (torch.add, False), "_minus_scalar": (torch.sub, False),
    "_rminus_scalar": (lambda s, x: s - x, True),
    "_mul_scalar": (torch.mul, False),
    "_div_scalar": (torch.true_divide, False),
    "_rdiv_scalar": (lambda s, x: s / x, True),
    "_mod_scalar": (torch.remainder, False),
    "_rmod_scalar": (lambda s, x: torch.remainder(torch.full_like(x, s), x),
                     True),
    "_power_scalar": (torch.pow, False),
    "_rpower_scalar": (lambda s, x: torch.pow(s, x), True),
    "_maximum_scalar": (lambda x, s: torch.clamp(x, min=s), False),
    "_minimum_scalar": (lambda x, s: torch.clamp(x, max=s), False),
}
def _logical_scalar(fn):
    return lambda x, s: fn(x, torch.as_tensor(s, device=x.device))


_SCALAR_CMP = {
    "_equal_scalar": torch.eq, "_not_equal_scalar": torch.ne,
    "_greater_scalar": torch.gt, "_greater_equal_scalar": torch.ge,
    "_lesser_scalar": torch.lt, "_lesser_equal_scalar": torch.le,
    "_logical_and_scalar": _logical_scalar(torch.logical_and),
    "_logical_or_scalar": _logical_scalar(torch.logical_or),
    "_logical_xor_scalar": _logical_scalar(torch.logical_xor),
}


# ---------------------------------------------------------------------------
# the rest of the unary table and the binaries arctan2/hypot
# ---------------------------------------------------------------------------

def _inexact(x):
    """An integer or bool array as float32, as jnp promotes it before an
    inexact function; a float array as it is."""
    return x if x.is_floating_point() else x.to(torch.float32)


def _inexact_pair(a, b):
    rt = torch.result_type(a, b)
    rt = rt if rt.is_floating_point else torch.float32
    return a.to(rt), b.to(rt)


def _rounding(fn):
    """A rounding function: an integer or bool array is its own value."""
    return lambda x: fn(x) if x.is_floating_point() else x.clone()


def _cbrt(x):
    """The real cube root sign(x)·|x|^(1/3) (torch has no cbrt), its power
    taken in float64 for float32 input (within an ulp of jnp.cbrt), in
    float32 for the half types."""
    x = _inexact(x)
    wide = torch.float64 if x.dtype in (torch.float32, torch.float64) \
        else torch.float32
    w = x.to(wide)
    return (torch.sign(w) * w.abs().pow(1.0 / 3.0)).to(x.dtype)


def _digamma(x):
    """digamma, NaN at 0 as jax.scipy.special.digamma (torch gives -inf
    there)."""
    x = _inexact(x)
    return torch.where(x == 0, float("nan"), torch.digamma(x))


_UNARY_REST = {
    "sign": torch.sign,
    "round": _rounding(torch.round),   # half to even, as jnp.round
    "rint": lambda x: torch.round(_inexact(x)),
    "ceil": _rounding(torch.ceil), "floor": _rounding(torch.floor),
    "trunc": _rounding(torch.trunc), "fix": _rounding(torch.trunc),
    "rsqrt": lambda x: torch.rsqrt(_inexact(x)),
    "cbrt": _cbrt, "rcbrt": lambda x: 1.0 / _cbrt(x),
    "log10": lambda x: torch.log10(_inexact(x)),
    "log2": lambda x: torch.log2(_inexact(x)),
    "log1p": lambda x: torch.log1p(_inexact(x)),
    "expm1": lambda x: torch.expm1(_inexact(x)),
    "sin": lambda x: torch.sin(_inexact(x)),
    "cos": lambda x: torch.cos(_inexact(x)),
    "tan": lambda x: torch.tan(_inexact(x)),
    "arcsin": lambda x: torch.asin(_inexact(x)),
    "arccos": lambda x: torch.acos(_inexact(x)),
    "arctan": lambda x: torch.atan(_inexact(x)),
    "sinh": lambda x: torch.sinh(_inexact(x)),
    "cosh": lambda x: torch.cosh(_inexact(x)),
    "arcsinh": lambda x: torch.asinh(_inexact(x)),
    "arccosh": lambda x: torch.acosh(_inexact(x)),
    "arctanh": lambda x: torch.atanh(_inexact(x)),
    "degrees": lambda x: _inexact(x) * (180.0 / math.pi),
    "radians": lambda x: _inexact(x) * (math.pi / 180.0),
    "softsign": lambda x: x / (1 + torch.abs(x)),
    "reciprocal": lambda x: 1.0 / _inexact(x),
    "erf": lambda x: torch.erf(_inexact(x)),
    "erfinv": lambda x: torch.erfinv(_inexact(x)),
    # exp(gammaln(x)) as the JAX package writes it: |Γ(x)| for x < 0
    "gamma": lambda x: torch.exp(torch.lgamma(_inexact(x))),
    "gammaln": lambda x: torch.lgamma(_inexact(x)),
    "logical_not": lambda x: (x == 0).to(x.dtype),
    "identity": lambda x: x,
}


def arctan2(a, b):
    return torch.atan2(*_inexact_pair(a, b))


def broadcast_hypot(a, b):
    return torch.hypot(*_inexact_pair(a, b))


def _hypot_scalar(x, scalar=1.0):
    """hypot(x, scalar), the scalar first cast to x's dtype (an int array
    truncates it), then both promoted as jnp.hypot promotes them."""
    s = _scalar_as(scalar, x.dtype)
    xf = _inexact(x)
    return torch.hypot(xf, torch.full_like(xf, s))


# ---------------------------------------------------------------------------
# reductions, argmin
# ---------------------------------------------------------------------------

def prod(x, axis=None, keepdims=False, exclude=False):
    ax = _axes(x, axis, exclude)
    if not ax:
        return x
    out = x
    for a in sorted(ax, reverse=True):
        out = out.prod(dim=a, keepdim=keepdims)
    return _int32(out, x)


def nansum(x, axis=None, keepdims=False, exclude=False):
    if not x.is_floating_point():
        return sum(x, axis, keepdims, exclude)
    ax = _axes(x, axis, exclude)
    return torch.nansum(x, dim=ax, keepdim=keepdims) if ax else x


def nanprod(x, axis=None, keepdims=False, exclude=False):
    if x.is_floating_point():
        x = torch.where(torch.isnan(x), torch.ones_like(x), x)
    return prod(x, axis, keepdims, exclude)


def argmin(x, axis=None, keepdims=False):
    """Index of the first minimum along ``axis`` (flat when None), as
    float32."""
    return _arg_index(torch.argmin, x, axis, keepdims)


def argmax_channel(x):
    return torch.argmax(x, dim=-1).float()


# ---------------------------------------------------------------------------
# broadcasting, axes, slicing, joining
# ---------------------------------------------------------------------------

def broadcast_to(x, shape=()):
    """x broadcast to ``shape``, where a 0 keeps x's size on that axis;
    a new array, as in the JAX package."""
    tgt = tuple(s if s != 0 else x.shape[i] for i, s in enumerate(shape))
    return x.broadcast_to(tgt).contiguous()


def broadcast_like(x, y):
    return x.broadcast_to(y.shape).contiguous()


def broadcast_axis(x, axis=(), size=()):
    """The named size-1 axes broadcast out to ``size``."""
    axes = (axis,) if isinstance(axis, int) else tuple(axis)
    sizes = (size,) if isinstance(size, int) else tuple(size)
    tgt = list(x.shape)
    for a, s in zip(axes, sizes):
        tgt[a] = s
    return x.broadcast_to(tuple(tgt)).contiguous()


def swapaxes(x, dim1=0, dim2=0):
    """Axes dim1 and dim2 exchanged (a view, as ``transpose`` gives)."""
    return x.swapaxes(dim1, dim2)


def _slice(x, begin=(), end=(), step=None):
    """A strided slice per axis from begin/end/step tuples (None entries
    open), a view where every step is positive; a negative step selects
    the same elements as Python's slice."""
    out = x
    for i, (b, e) in enumerate(zip(begin, end)):
        st = step[i] if step and step[i] is not None else 1
        if st > 0:
            idx = [slice(None)] * out.dim()
            idx[i] = slice(b, e, st)
            out = out[tuple(idx)]
        else:
            keep = range(*slice(b, e, st).indices(out.shape[i]))
            out = out.index_select(i, torch.arange(
                keep.start, keep.stop, keep.step, device=out.device)
                if len(keep) else torch.zeros(0, dtype=torch.long,
                                              device=out.device))
    return out


def slice_like(x, y, axes=()):
    """x cropped to y's extent along ``axes`` (every shared axis when
    empty)."""
    axes = tuple(axes) if axes else tuple(range(builtins.min(x.dim(),
                                                             y.dim())))
    idx = [slice(None)] * x.dim()
    for a in axes:
        idx[a] = slice(0, y.shape[a])
    return x[tuple(idx)]


def stack(*xs, axis=0, num_args=None):
    return torch.stack(xs, dim=axis)


def _split_nout(attrs):
    return int(attrs.get("num_outputs", 1))


def split(x, num_outputs=1, axis=1, squeeze_axis=False):
    """``num_outputs`` equal parts along ``axis`` (views), each squeezed
    on that axis with ``squeeze_axis``; an axis that ``num_outputs`` does
    not divide raises, as jnp.split does."""
    n = x.shape[axis]
    if n % num_outputs:
        raise MXNetError(f"split: axis {axis} of size {n} does not divide "
                         f"into {num_outputs} equal parts")
    parts = torch.split(x, n // num_outputs, dim=axis)
    if squeeze_axis:
        parts = [p.squeeze(axis) for p in parts]
    return tuple(parts)


def tile(x, reps=()):
    """numpy's tile: ``reps`` shorter than x's rank repeats the trailing
    axes, longer adds leading axes."""
    return torch.tile(x, (reps,) if isinstance(reps, int) else tuple(reps))


def repeat(x, repeats=1, axis=None):
    """Each element ``repeats`` times along ``axis`` (x flattened first
    when None)."""
    return torch.repeat_interleave(x, repeats, dim=axis)


def reverse(x, axis=()):
    return torch.flip(x, (axis,) if isinstance(axis, int) else tuple(axis))


# ---------------------------------------------------------------------------
# indexing
# ---------------------------------------------------------------------------

_TAKE_MODES = {"clip": "clip", "wrap": "wrap", "raise": "clip"}


def take(x, indices, axis=0, mode="clip"):
    """Slices of x along ``axis`` at ``indices`` (cast to int32, so a
    float index truncates): out of range, ``clip`` (and ``raise``, which
    the JAX op maps to it) clamps and ``wrap`` wraps."""
    if mode not in _TAKE_MODES:
        raise MXNetError(f"take: unknown mode {mode!r}")
    axis = axis % x.dim()
    n = x.shape[axis]
    idx = indices.to(torch.int32).long()
    idx = idx.remainder(n) if _TAKE_MODES[mode] == "wrap" \
        else idx.clamp(0, n - 1)
    out = x.index_select(axis, idx.reshape(-1))
    return out.reshape(x.shape[:axis] + idx.shape + x.shape[axis + 1:])


def one_hot(indices, depth=1, on_value=1.0, off_value=0.0, dtype="float32"):
    """depth-long rows, ``on_value`` at each index and ``off_value``
    elsewhere (all of a row for an index out of [0, depth)), computed as
    the JAX op does: one_hot(...) * (on - off) + off in ``dtype``, which
    the float scalars make float32 for an integer ``dtype``."""
    dt = dtype_of(dtype)
    idx = indices.to(torch.int32)
    hot = idx.unsqueeze(-1) == torch.arange(depth, dtype=torch.int32,
                                            device=idx.device)
    out = hot.to(dt if dt.is_floating_point else torch.float32)
    return out * (on_value - off_value) + off_value


def _multi_index(shape, indices):
    """indices (M, ...) as M long tensors into the leading axes of an
    array of ``shape``, negatives counted from the end."""
    idx = indices.to(torch.int32).long()
    dims = torch.tensor(shape[:idx.shape[0]], dtype=torch.long,
                        device=idx.device).reshape(
                            (-1,) + (1,) * (idx.dim() - 1))
    return torch.where(idx < 0, idx + dims, idx), dims


def gather_nd(data, indices):
    """data at the multi-indices in ``indices``'s leading axis; an index
    out of range is clamped."""
    idx, dims = _multi_index(data.shape, indices)
    idx = torch.minimum(idx.clamp_min(0), dims - 1)
    return data[tuple(idx)]


def scatter_nd(data, indices, shape=()):
    """zeros of ``shape`` with ``data`` written at the multi-indices in
    ``indices``'s leading axis; a write out of range is dropped.  Which
    of several writes to one cell lands is unspecified (as in the JAX
    op): give unique indices."""
    idx, dims = _multi_index(tuple(shape), indices)
    m = idx.shape[0]
    lead = math.prod(shape[:m])
    rest = tuple(shape[m:])
    ok = ((idx >= 0) & (idx < dims)).all(dim=0)
    strides = [math.prod(shape[i + 1:m]) for i in range(m)]
    flat = functools.reduce(torch.add, [idx[i] * strides[i]
                                        for i in range(m)])
    flat = torch.where(ok, flat, lead)   # a spare row takes dropped writes
    out = torch.zeros((lead + 1,) + rest, dtype=data.dtype,
                      device=data.device)
    out = out.index_put((flat.reshape(-1),),
                        data.reshape((-1,) + rest))
    return out[:lead].reshape(tuple(shape))


# ---------------------------------------------------------------------------
# sequences: data is (seq, batch, ...) for axis 0, (batch, seq, ...) for 1
# ---------------------------------------------------------------------------

def _lengths(sequence_length):
    return sequence_length.to(torch.int32).long()


def sequence_mask(data, sequence_length=None, use_sequence_length=False,
                  value=0.0, axis=0):
    """Positions at or past each sequence's length set to ``value``."""
    if not use_sequence_length or sequence_length is None:
        return data
    pos = torch.arange(data.shape[axis], device=data.device)
    mask = pos[:, None] < _lengths(sequence_length)[None, :]
    if axis == 1:
        mask = mask.T
    mask = mask.reshape(mask.shape + (1,) * (data.dim() - 2))
    fill = torch.full((), _scalar_as(value, data.dtype), dtype=data.dtype,
                      device=data.device)
    return torch.where(mask, data, fill)


def _take_steps(moved, src):
    """moved (seq, batch, ...) gathered along axis 0 at src (k, batch)."""
    idx = src.reshape(src.shape + (1,) * (moved.dim() - 2))
    return moved.gather(0, idx.expand((src.shape[0],) + moved.shape[1:]))


def sequence_last(data, sequence_length=None, use_sequence_length=False,
                  axis=0):
    """Each sequence's last valid step.  As the JAX op's take_along_axis:
    a length of 0 reads the last step and a float array gets NaN for a
    length past the end."""
    if not use_sequence_length or sequence_length is None:
        return data.select(axis, -1)
    moved = data.movedim(axis, 0)
    seq = moved.shape[0]
    last = _lengths(sequence_length) - 1
    last = torch.where(last < 0, last + seq, last)
    out = _take_steps(moved, last.clamp(0, seq - 1)[None])[0]
    if out.is_floating_point():
        ok = (last >= 0) & (last < seq)
        out = torch.where(ok.reshape(ok.shape + (1,) * (out.dim() - 1)),
                          out, float("nan"))
    return out


def sequence_reverse(data, sequence_length=None, use_sequence_length=False,
                     axis=0):
    """Each sequence's first ``length`` steps reversed, the padding after
    them left in place; the whole axis flipped without lengths."""
    if not use_sequence_length or sequence_length is None:
        return torch.flip(data, (axis,))
    moved = data.movedim(axis, 0)
    seq = moved.shape[0]
    lens = _lengths(sequence_length)[None, :]
    pos = torch.arange(seq, device=data.device)[:, None]
    src = torch.where(pos < lens, lens - 1 - pos, pos).clamp(0, seq - 1)
    return _take_steps(moved, src).movedim(0, axis)


# ---------------------------------------------------------------------------
# products (cuBLAS for floats; an integer product has no cuBLAS kernel,
# so it is summed exactly, broadcast and reduced, as int64)
# ---------------------------------------------------------------------------

def _matmul(a, b):
    rt = torch.result_type(a, b)
    a, b = a.to(rt), b.to(rt)
    if rt.is_floating_point:
        return torch.matmul(a, b)
    out = (a.to(torch.int64).unsqueeze(-1)
           * b.to(torch.int64).unsqueeze(-3)).sum(-2)
    return out.to(torch.int32 if rt == torch.bool else rt)


def dot(a, b, transpose_a=False, transpose_b=False):
    """MXNet's dot: a's last axis contracted with b's first (two 1-d
    operands give a scalar); a transpose swaps an operand's last two
    axes, as the JAX op does."""
    if transpose_a and a.dim() > 1:
        a = a.swapaxes(-1, -2)
    if transpose_b and b.dim() > 1:
        b = b.swapaxes(-1, -2)
    lead, tail = a.shape[:-1], b.shape[1:]
    out = _matmul(a.reshape(-1, a.shape[-1]), b.reshape(b.shape[0], -1))
    return out.reshape(lead + tail)


def batch_dot(a, b, transpose_a=False, transpose_b=False):
    if transpose_a:
        a = a.swapaxes(-1, -2)
    if transpose_b:
        b = b.swapaxes(-1, -2)
    return _matmul(a, b)


def l2_normalization(x, eps=1e-10, mode="instance"):
    """x over the L2 norm of each instance, channel or spatial slice."""
    if mode == "instance":
        axes = tuple(range(1, x.dim()))
    elif mode == "channel":
        axes = (1,)
    else:
        axes = tuple(range(2, x.dim()))
    return x / torch.sqrt(x.square().sum(dim=axes, keepdim=True) + eps)


def diag(x, k=0):
    """The k-th diagonal of a (batched) matrix, or the matrix of a
    vector."""
    if x.dim() == 1:
        return torch.diag(x, k)
    return torch.diagonal(x, offset=k, dim1=-2, dim2=-1)


def cumsum(x, axis=None, dtype=None):
    src, dim = (x.reshape(-1), 0) if axis is None else (x, axis)
    if dtype:
        return torch.cumsum(src, dim, dtype=dtype_of(dtype))
    return _int32(torch.cumsum(src, dim), x)


def cumprod(x, axis=None):
    src, dim = (x.reshape(-1), 0) if axis is None else (x, axis)
    return _int32(torch.cumprod(src, dim), x)


# ---------------------------------------------------------------------------
# the misc batch
# ---------------------------------------------------------------------------

def trace(data, offset=0, axis1=0, axis2=1):
    return _int32(torch.diagonal(data, offset, axis1, axis2).sum(-1), data)


def ravel_multi_index(data, shape=()):
    """data (d, n) of multi-indices -> (n,) flat indices, in data's
    dtype."""
    strides = [math.prod(shape[i + 1:]) for i in range(len(shape))]
    out = data[0] * strides[0]
    for i in range(1, len(shape)):
        out = out + data[i] * strides[i]
    return out


def unravel_index(data, shape=()):
    """(n,) flat indices -> (d, n) multi-indices in data's dtype; as
    jnp.unravel_index, an index is clipped into [-size, size) and a
    negative one counts from the end."""
    size = math.prod(shape)
    idx = data.to(torch.int32).long().clamp(-size, size - 1)
    idx = torch.where(idx < 0, idx + size, idx)
    outs = []
    for s in reversed(shape):
        outs.append(idx.remainder(s))
        idx = idx.div(s, rounding_mode="floor")
    return torch.stack(outs[::-1]).to(data.dtype)


def _bitwise(fn):
    return lambda lhs, rhs: fn(lhs.to(torch.int64),
                               rhs.to(torch.int64)).to(lhs.dtype)


def all_finite(data, init_output=True):
    return torch.isfinite(data).all().reshape(1).to(torch.float32)


def multi_all_finite(*arrays, num_arrays=1, init_output=True):
    ok = torch.stack([torch.isfinite(a).all() for a in arrays]).all()
    return ok.reshape(1).to(torch.float32)


def amp_cast(data, dtype="float32"):
    """``cast`` with float16 mapped to bfloat16, as in the JAX op."""
    return data.to(dtype_of({"float16": "bfloat16"}.get(str(dtype), dtype)))


_AMP_RANK = {torch.bfloat16: 0, torch.float32: 1, torch.float64: 2}


def amp_multicast(*data, num_outputs=1, cast_narrow=False):
    """Every input cast to the dtype of the widest one (the first of
    the widest), or of the narrowest with ``cast_narrow``."""
    ranked = [_AMP_RANK.get(d.dtype, 1) for d in data]
    pick = (builtins.min if cast_narrow else builtins.max)(
        range(len(data)), key=lambda i: ranked[i])
    return tuple(d.to(data[pick].dtype) for d in data)


def shape_array(x):
    return torch.tensor(x.shape, dtype=torch.int32, device=x.device)


def size_array(x):
    return torch.tensor(x.numel(), dtype=torch.int32, device=x.device)


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
    register_op("reshape_like")(reshape_like)
    register_op("where")(where)
    register_op("depth_to_space")(depth_to_space)
    register_op("space_to_depth")(space_to_depth)
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
    for name, fn in _UNARY_REST.items():
        register_op(name)(functools.partial(lambda x, _f: _f(x), _f=fn))
    register_op("digamma")(_digamma)
    register_op("arctan2")(arctan2)
    register_op("broadcast_hypot")(broadcast_hypot)
    register_op("_hypot_scalar")(_hypot_scalar)
    register_op("prod")(prod)
    register_op("nansum")(nansum)
    register_op("nanprod")(nanprod)
    register_op("argmin", differentiable=False)(argmin)
    register_op("argmax_channel", differentiable=False)(argmax_channel)
    register_op("broadcast_to")(broadcast_to)
    register_op("broadcast_like")(broadcast_like)
    register_op("broadcast_axis", aliases=("broadcast_axes",))(
        broadcast_axis)
    register_op("swapaxes", aliases=("SwapAxis",))(swapaxes)
    register_op("slice")(_slice)
    register_op("slice_like")(slice_like)
    register_op("stack")(stack)
    register_op("split", aliases=("SliceChannel",),
                num_outputs=_split_nout)(split)
    register_op("tile")(tile)
    register_op("repeat")(repeat)
    register_op("reverse", aliases=("flip",))(reverse)
    register_op("take")(take)
    register_op("one_hot", differentiable=False)(one_hot)
    register_op("gather_nd")(gather_nd)
    register_op("scatter_nd")(scatter_nd)
    register_op("sequence_mask", aliases=("SequenceMask",))(sequence_mask)
    register_op("sequence_last", aliases=("SequenceLast",))(sequence_last)
    register_op("sequence_reverse", aliases=("SequenceReverse",))(
        sequence_reverse)
    register_op("dot")(dot)
    register_op("batch_dot")(batch_dot)
    register_op("L2Normalization")(l2_normalization)
    register_op("diag")(diag)
    register_op("cumsum")(cumsum)
    register_op("cumprod")(cumprod)
    for name in ("isnan", "isinf", "isfinite"):
        register_op(name, differentiable=False)(functools.partial(
            lambda x, _f: _f(x).to(torch.float32), _f=getattr(torch, name)))
    register_op("trace")(trace)
    register_op("_ravel_multi_index", aliases=("ravel_multi_index",),
                differentiable=False)(ravel_multi_index)
    register_op("_unravel_index", aliases=("unravel_index",),
                differentiable=False)(unravel_index)
    for name in ("bitwise_and", "bitwise_or", "bitwise_xor"):
        register_op(name, differentiable=False)(
            _bitwise(getattr(torch, name)))
    register_op("all_finite", differentiable=False)(all_finite)
    register_op("multi_all_finite", differentiable=False)(multi_all_finite)
    register_op("amp_cast")(amp_cast)
    register_op("amp_multicast", num_outputs=lambda attrs: int(
        attrs.get("num_outputs", 1)))(amp_multicast)
    register_op("shape_array", differentiable=False)(shape_array)
    register_op("size_array", differentiable=False)(size_array)
    register_op("copy", aliases=("_copy",))(lambda x: x.clone())


_register()
