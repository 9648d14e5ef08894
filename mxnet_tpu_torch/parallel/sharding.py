"""Batch sharding of the port (counterpart of ``shard_batch`` in
``mxnet_tpu/parallel/sharding.py``).

The JAX package returns a ``NamedSharding`` that GSPMD applies to a
global array.  Here each rank is a process, so :func:`shard_batch` does
the placement itself: rank r keeps the contiguous block r of dim 0, the
block GSPMD gives device r of the ``dp`` axis.  Random draws over the
batch (dropout masks) follow the same rule: :func:`rand_batch` draws
over the global batch and keeps this rank's block.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..base import MXNetError
from . import dist
from .mesh import DeviceMesh, batch_shards, current_mesh, get_mesh

__all__ = ["shard_batch", "rand_batch"]


def shard_batch(x: torch.Tensor,
                mesh: Optional[DeviceMesh] = None) -> torch.Tensor:
    """This rank's rows of the global batch ``x`` (a view).  A batch that
    the mesh's batch shards do not divide raises: the port has no
    fallback for it (the JAX package's fused unit takes its XLA plan)."""
    mesh = mesh or get_mesh()
    shards = batch_shards(mesh)
    if shards == 1:
        return x
    n = x.shape[0]
    if n % shards:
        raise MXNetError(f"shard_batch: a batch of {n} rows does not divide "
                         f"into {shards} shards of mesh {mesh!r}")
    rows = n // shards
    r = dist.rank()
    return x[r * rows:(r + 1) * rows]


def rand_batch(shape, generator: torch.Generator,
               device) -> torch.Tensor:
    """``torch.rand(shape)`` for this rank's rows, dim 0 being its block
    of the batch (or batch-major rows, as (B*H, ...)).  Under a mesh that
    splits the batch over N ranks every rank draws the tensor of the
    global batch, N times as many rows, from the generator state they
    share, and keeps its block r: the ranks together use the draw that
    one device makes for the whole batch, as the JAX package draws one
    mask a step from one key, and their generators stay in step."""
    shards = batch_shards(current_mesh())
    if shards == 1:
        return torch.rand(shape, generator=generator, device=device)
    rows = shape[0]
    full = torch.rand((rows * shards,) + tuple(shape[1:]),
                      generator=generator, device=device)
    r = dist.rank()
    return full[r * rows:(r + 1) * rows]
