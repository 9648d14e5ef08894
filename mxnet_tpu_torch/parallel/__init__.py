"""Parallel training of the port (counterpart of ``mxnet_tpu/parallel``):
the process group (``dist``), device meshes over every axis (dp, fsdp,
tp, pp, sp, ep), partition specs and sharding rules, ``SPMDTrainer``
with sharded parameters, and ring and Ulysses sequence-parallel
attention.  MoE (``moe_apply``) and the pipeline (``pipeline_apply``,
``HeteroPipeline``) are ROADMAP queue A item 7, cut (c)."""
from . import dist, ring, ulysses
from .checkpoint import load_sharded, save_sharded
from .mesh import (AXIS_NAMES, DeviceMesh, batch_shards, current_mesh,
                   get_mesh, make_mesh, mesh_shard_plan)
from .ring import local_attention, ring_attention, ring_attention_sharded
from .sharding import (DEFAULT_RULES, NamedSharding, P, PartitionSpec,
                       ShardingRules, constraint, named_sharding,
                       replicated, shard_batch, zero_state_spec)
from .spmd import FunctionalOptimizer, SPMDTrainer, functional_optimizer
from .ulysses import ulysses_attention, ulysses_attention_sharded

__all__ = ["dist", "ring", "ulysses", "DeviceMesh", "make_mesh",
           "current_mesh", "get_mesh", "mesh_shard_plan", "batch_shards",
           "shard_batch", "AXIS_NAMES", "SPMDTrainer", "FunctionalOptimizer",
           "functional_optimizer", "ShardingRules", "DEFAULT_RULES",
           "PartitionSpec", "P", "NamedSharding", "named_sharding",
           "replicated", "constraint", "zero_state_spec",
           "local_attention", "ring_attention", "ring_attention_sharded",
           "ulysses_attention", "ulysses_attention_sharded",
           "save_sharded", "load_sharded"]

# the JAX package's expert and pipeline parallelism, not ported yet
_QUEUED = ("moe", "pipeline", "moe_apply", "pipeline_apply",
           "HeteroPipeline")


def __getattr__(name):
    if name in _QUEUED:
        from ..base import MXNetError

        raise MXNetError(
            f"parallel.{name}: expert (ep) and pipeline (pp) parallelism "
            "are not ported yet (ROADMAP queue A item 7, cut (c)); the "
            "meshes make their groups already")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
