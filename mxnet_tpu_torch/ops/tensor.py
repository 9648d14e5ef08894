"""Tensor ops of the training loss (pick, mean, sum) and of BERT's
forward (arange_like, expand_dims, squeeze, slice_axis, cast,
broadcast_add, broadcast_lesser).

Counterpart of the same registered ops in ``mxnet_tpu/ops/tensor.py``
(``_pick``, the ``_red`` reductions, ``_arange_like``, the shape ops,
``_cast`` and the broadcast tables), as plain functions on tensors.
Only what ``gluon.loss.SoftmaxCrossEntropyLoss`` and
``BERTModel.hybrid_forward`` need is ported.
"""
from __future__ import annotations

import torch

from ..base import MXNetError, dtype_of

__all__ = ["pick", "mean", "sum", "arange_like", "expand_dims", "squeeze",
           "slice_axis", "cast", "broadcast_add", "broadcast_lesser"]


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
    return x.mean(dim=ax, keepdim=keepdims) if ax else x


def sum(x, axis=None, keepdims=False, exclude=False):  # noqa: A001 — op name
    ax = _axes(x, axis, exclude)
    return x.sum(dim=ax, keepdim=keepdims) if ax else x


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
