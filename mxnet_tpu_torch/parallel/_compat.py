"""Blocks of a global tensor by a partition spec (the port's counterpart
of ``mxnet_tpu/parallel/_compat.py``).

The JAX package runs a per-shard body under ``shard_map`` with the
replication checks off (``shard_map_unchecked``): XLA cuts each input
into a device's block by its spec and puts the output blocks back
together.  Here each rank is a process holding global tensors, so the
same two moves are done by hand over the mesh's sub-groups
(``DeviceMesh.group``):

* :func:`block_of` cuts this rank's block of ``x``: along each dim that
  the spec splits over axes A, block ``mesh.index(A)`` of
  ``size(A)`` equal blocks;
* :func:`gather_blocks` all-gathers the blocks, dim by dim, each over
  its axes' group, back into the global tensor.

Both have a differentiable form whose backward is the other move, for
values that every rank of the axes holds alike: :func:`take_block` (the
cotangent of the block is all-gathered, so the global cotangent is again
the same on every rank) and :func:`gather` (the cotangent of the
gathered tensor is cut to this rank's block; with ``partial`` axes, along
which the ranks hold different rows of the batch and so different
partial cotangents, it is first summed over them, as a reduce-scatter).
:func:`shard_map_unchecked` composes them around a per-shard body.
"""
from __future__ import annotations

from typing import Sequence

import torch

from . import dist
from .mesh import DeviceMesh
from .sharding import _axes_of, filter_spec

__all__ = ["block_of", "gather_blocks", "gather_dim", "take_block",
           "gather", "shard_map_unchecked", "split_dims"]


def split_dims(spec, mesh: DeviceMesh):
    """[(dim, axes)] of every dim that ``spec`` splits on ``mesh``, the
    axes in the spec's order with those of size 1 left out."""
    out = []
    for d, e in enumerate(filter_spec(spec, mesh)):
        axes = tuple(a for a in _axes_of(e) if mesh.size(a) > 1)
        if axes:
            out.append((d, axes))
    return out


def block_of(x: torch.Tensor, spec, mesh: DeviceMesh) -> torch.Tensor:
    """This rank's block of the global ``x`` (a view)."""
    for d, axes in split_dims(spec, mesh):
        k = mesh.size(axes)
        if x.shape[d] % k:
            raise ValueError(f"dim {d} of {tuple(x.shape)} does not divide "
                             f"into {k} blocks over {axes}")
        n = x.shape[d] // k
        x = x.narrow(d, mesh.index(axes) * n, n)
    return x


def _order(mesh: DeviceMesh, axes) -> list:
    """For each place in the group over ``axes`` (global-rank order), the
    block index its rank holds along ``axes`` (in their spec order)."""
    out = []
    for r in mesh.group_ranks(axes):
        c = mesh.coords_of(r)
        i = 0
        for a in axes:
            i = i * mesh.size(a) + c[a]
        out.append(i)
    return out


def gather_dim(b: torch.Tensor, d: int, axes, mesh: DeviceMesh):
    """``b`` all-gathered along dim ``d`` over ``axes``, the blocks in
    the order of this rank's place along them."""
    parts = dist.all_gather_list(b.contiguous(), mesh.group(axes))
    ordered = [None] * len(parts)
    for p, i in zip(parts, _order(mesh, axes)):
        ordered[i] = p
    return torch.cat(ordered, d)


def gather_blocks(b: torch.Tensor, spec, mesh: DeviceMesh) -> torch.Tensor:
    """The global tensor whose block on each rank is its ``b``."""
    for d, axes in reversed(split_dims(spec, mesh)):
        b = gather_dim(b, d, axes, mesh)
    return b


def _sum_to_block(g: torch.Tensor, spec, mesh: DeviceMesh,
                  partial: Sequence[str]) -> torch.Tensor:
    """This rank's block of the sum of ``g`` over the ``partial`` axes: a
    reduce-scatter when one dim is split and only over partial axes, in
    group order; else an all-reduce over them, then the block."""
    dims = split_dims(spec, mesh)
    over = tuple(a for a in partial if mesh.size(a) > 1)
    if not over:
        return block_of(g, spec, mesh).contiguous()
    if (len(dims) == 1 and set(dims[0][1]) == set(over)
            and _order(mesh, dims[0][1]) == list(range(mesh.size(over)))):
        d, axes = dims[0]
        k = mesh.size(axes)
        moved = g.movedim(d, 0).contiguous()
        blk = dist.reduce_scatter(moved.reshape(-1), mesh.group(axes))
        shape = (moved.shape[0] // k,) + tuple(moved.shape[1:])
        return blk.view(shape).movedim(0, d).contiguous()
    g = dist.all_reduce_(g.contiguous().clone(), mesh.group(over))
    return block_of(g, spec, mesh).contiguous()


class _TakeBlock(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, spec, mesh):
        ctx.spec, ctx.mesh = spec, mesh
        return block_of(x, spec, mesh).contiguous()

    @staticmethod
    def backward(ctx, g):
        return gather_blocks(g.contiguous(), ctx.spec, ctx.mesh), None, None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, b, spec, mesh, partial):
        ctx.spec, ctx.mesh, ctx.partial = spec, mesh, partial
        return gather_blocks(b.detach(), spec, mesh)

    @staticmethod
    def backward(ctx, g):
        return (_sum_to_block(g, ctx.spec, ctx.mesh, ctx.partial), None,
                None, None)


def take_block(x: torch.Tensor, spec, mesh: DeviceMesh) -> torch.Tensor:
    """Differentiable :func:`block_of` of an ``x`` that the ranks hold
    alike: its backward all-gathers the blocks' cotangents."""
    if not split_dims(spec, mesh):
        return x
    return _TakeBlock.apply(x, spec, mesh)


def gather(b: torch.Tensor, spec, mesh: DeviceMesh,
           partial: Sequence[str] = ()) -> torch.Tensor:
    """Differentiable :func:`gather_blocks`: the backward cuts the
    cotangent to this rank's block, after summing it over the
    ``partial`` axes (where the ranks hold different rows)."""
    if not split_dims(spec, mesh):
        return b
    return _Gather.apply(b, spec, mesh, tuple(partial))


def shard_map_unchecked(fn, *, mesh: DeviceMesh, in_specs, out_specs):
    """``fn`` as a per-shard body: each input cut to this rank's block by
    its spec (:func:`take_block`), each output gathered back by its spec
    (:func:`gather`); one spec for a single output."""
    def run(*args):
        out = fn(*(take_block(x, s, mesh) for x, s in zip(args, in_specs)))
        if isinstance(out, (tuple, list)):
            return type(out)(gather(o, s, mesh)
                             for o, s in zip(out, out_specs))
        return gather(out, out_specs, mesh)
    return run
