"""Gluon utilities (counterpart of ``mxnet_tpu/gluon/utils.py``):
split_data, split_and_load, clip_global_norm."""
from __future__ import annotations

import math
from typing import List, Sequence

import torch

from ..base import MXNetError
from ..ndarray.ndarray import NDArray, array as nd_array

__all__ = ["split_data", "split_and_load", "clip_global_norm"]


def split_data(data: NDArray, num_slice: int, batch_axis: int = 0,
               even_split: bool = True) -> List[NDArray]:
    """Slice a batch along ``batch_axis`` into ``num_slice`` views."""
    size = data.shape[batch_axis]
    if even_split and size % num_slice != 0:
        raise MXNetError(
            f"data with shape {data.shape} cannot be evenly split into "
            f"{num_slice} slices along axis {batch_axis}")
    step = size // num_slice
    out = []
    for i in range(num_slice):
        if not even_split and size % num_slice != 0:
            begin = int(round(i * size / num_slice))
            end = int(round((i + 1) * size / num_slice))
        else:
            begin, end = i * step, (i + 1) * step
        idx = [slice(None)] * data.ndim
        idx[batch_axis] = slice(begin, end)
        out.append(data[tuple(idx)])
    return out


def split_and_load(data, ctx_list: Sequence, batch_axis: int = 0,
                   even_split: bool = True) -> List[NDArray]:
    """Slice a batch and move slice i to ``ctx_list[i]``."""
    if not isinstance(data, NDArray):
        data = nd_array(data, ctx=ctx_list[0])
    if len(ctx_list) == 1:
        return [data.as_in_context(ctx_list[0])]
    slices = split_data(data, len(ctx_list), batch_axis, even_split)
    return [s.as_in_context(c) for s, c in zip(slices, ctx_list)]


def clip_global_norm(arrays: Sequence[NDArray], max_norm: float,
                     check_isfinite: bool = True) -> float:
    """Scale ``arrays`` in place so that their global L2 norm is at most
    ``max_norm``; returns the norm before scaling."""
    if not arrays:
        raise MXNetError("no arrays given")
    total = math.sqrt(sum(float(a.norm().asscalar()) ** 2 for a in arrays))
    if check_isfinite and not math.isfinite(total):
        raise MXNetError(f"global norm is not finite ({total})")
    scale = max_norm / (total + 1e-8)
    if scale < 1.0:
        with torch.no_grad():
            for a in arrays:
                a._data.mul_(scale)
    return total
