"""Parallel training of the port (counterpart of ``mxnet_tpu/parallel``):
the process group (``dist``), device meshes, batch sharding and
``SPMDTrainer``, on one device or data parallel over ranks."""
from . import dist
from .mesh import (AXIS_NAMES, DeviceMesh, batch_shards, current_mesh,
                   get_mesh, make_mesh, mesh_shard_plan)
from .sharding import shard_batch
from .spmd import FunctionalOptimizer, SPMDTrainer, functional_optimizer

__all__ = ["dist", "DeviceMesh", "make_mesh", "current_mesh", "get_mesh",
           "mesh_shard_plan", "batch_shards", "shard_batch", "AXIS_NAMES",
           "SPMDTrainer", "FunctionalOptimizer", "functional_optimizer"]
