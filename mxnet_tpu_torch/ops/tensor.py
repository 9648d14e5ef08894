"""Tensor ops of the training loss: pick, mean, sum.

Counterpart of the same registered ops in ``mxnet_tpu/ops/tensor.py``
(``_pick`` and the ``_red`` reductions), as plain functions on tensors.
Only what ``gluon.loss.SoftmaxCrossEntropyLoss`` needs is ported.
"""
from __future__ import annotations

import torch

from ..base import MXNetError

__all__ = ["pick", "mean", "sum"]


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
