"""Ulysses sequence parallelism: all-to-all over the ``sp`` mesh axis
(counterpart of ``mxnet_tpu/parallel/ulysses.py``).

The second long-context layout beside ``parallel.ring``: one all-to-all
re-shards the sequence-split [B, H, L/n, D] blocks into head-split
[B, H/n, L, D] ones, each rank runs plain attention at full length for
its heads (``ring.local_attention``), and one all-to-all re-shards back.
Two collectives instead of n - 1 hops; the heads must divide the axis.
Each all-to-all is ``dist.all_to_all_`` (``all_to_all_single`` over the
``sp`` group) inside a ``torch.autograd.Function`` whose backward is the
all-to-all the other way.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..base import MXNetError
from . import dist
from .mesh import DeviceMesh, current_mesh
from .ring import local_attention, sharded_seq_attention

__all__ = ["ulysses_attention", "ulysses_attention_sharded"]


def _seq_to_head(x, mesh, axis):
    """[B, H, L/n, D] (sequence block i on rank i) -> [B, H/n, L, D]
    (head block i on rank i)."""
    n = mesh.size(axis)
    b, h, lb, d = x.shape
    xs = x.reshape(b, n, h // n, lb, d).permute(1, 0, 2, 3, 4)
    out = dist.all_to_all_(xs.contiguous(), mesh.group(axis))
    return out.permute(1, 2, 0, 3, 4).reshape(b, h // n, n * lb, d)


def _head_to_seq(y, mesh, axis):
    """The inverse of :func:`_seq_to_head`."""
    n = mesh.size(axis)
    b, hn, l, d = y.shape
    ys = y.reshape(b, hn, n, l // n, d).permute(2, 0, 1, 3, 4)
    out = dist.all_to_all_(ys.contiguous(), mesh.group(axis))
    return out.permute(1, 0, 2, 3, 4).reshape(b, n * hn, l // n, d)


class _SeqToHead(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.cfg = (mesh, axis)
        return _seq_to_head(x, mesh, axis)

    @staticmethod
    def backward(ctx, g):
        return _head_to_seq(g, *ctx.cfg), None, None


class _HeadToSeq(torch.autograd.Function):
    @staticmethod
    def forward(ctx, y, mesh, axis):
        ctx.cfg = (mesh, axis)
        return _head_to_seq(y, mesh, axis)

    @staticmethod
    def backward(ctx, g):
        return _seq_to_head(g, *ctx.cfg), None, None


def ulysses_attention(q, k, v, axis_name: str = "sp", *,
                      causal: bool = False, scale: Optional[float] = None,
                      mesh: Optional[DeviceMesh] = None):
    """Per-shard body: q, k, v are this rank's [B, H, L_local, D] blocks
    of the sequence over ``axis_name``.  Heads must divide the axis
    size."""
    mesh = mesh or current_mesh()
    n = mesh.size(axis_name)
    h = q.shape[1]
    if h % n != 0:
        raise MXNetError(
            f"ulysses_attention needs heads ({h}) divisible by the "
            f"'{axis_name}' axis size ({n}); use parallel.ring for "
            "few-head models")
    qh, kh, vh = (_SeqToHead.apply(t, mesh, axis_name) for t in (q, k, v))
    out = local_attention(qh, kh, vh, causal=causal, scale=scale)
    return _HeadToSeq.apply(out, mesh, axis_name)


def ulysses_attention_sharded(q, k, v, **kw):
    """User entry: q, k, v are [B, H, L, D], the same on every rank of
    ``sp``; re-shards their sequence blocks to heads with one all-to-all
    each way."""
    return sharded_seq_attention(
        ulysses_attention, q, k, v,
        entry_name="ulysses_attention_sharded", **kw)
