"""Parallel training of the port (counterpart of ``mxnet_tpu/parallel``):
the process group (``dist``), device meshes over every axis (dp, fsdp,
tp, pp, sp, ep), partition specs and sharding rules, ``SPMDTrainer``
with sharded parameters and every input layout, ring and Ulysses
sequence-parallel attention, expert-parallel top-1 MoE over ``ep``
(``moe``: ``moe_apply``) and pipeline parallelism over ``pp``
(``pipeline``: ``pipeline_apply``, ``stack_stage_params``, and
``HeteroPipeline`` over stages on their own devices)."""
from . import dist, moe, pipeline, ring, ulysses
from .checkpoint import load_sharded, save_sharded
from .moe import moe_apply
from .pipeline import HeteroPipeline, pipeline_apply, stack_stage_params
from .mesh import (AXIS_NAMES, DeviceMesh, batch_shards, current_mesh,
                   get_mesh, make_mesh, mesh_shard_plan)
from .ring import local_attention, ring_attention, ring_attention_sharded
from .sharding import (DEFAULT_RULES, NamedSharding, P, PartitionSpec,
                       ShardingRules, constraint, named_sharding,
                       replicated, shard_batch, zero_state_spec)
from .spmd import FunctionalOptimizer, SPMDTrainer, functional_optimizer
from .ulysses import ulysses_attention, ulysses_attention_sharded

__all__ = ["dist", "ring", "ulysses", "moe", "pipeline", "moe_apply",
           "pipeline_apply", "stack_stage_params", "HeteroPipeline",
           "DeviceMesh", "make_mesh",
           "current_mesh", "get_mesh", "mesh_shard_plan", "batch_shards",
           "shard_batch", "AXIS_NAMES", "SPMDTrainer", "FunctionalOptimizer",
           "functional_optimizer", "ShardingRules", "DEFAULT_RULES",
           "PartitionSpec", "P", "NamedSharding", "named_sharding",
           "replicated", "constraint", "zero_state_spec",
           "local_attention", "ring_attention", "ring_attention_sharded",
           "ulysses_attention", "ulysses_attention_sharded",
           "save_sharded", "load_sharded"]

