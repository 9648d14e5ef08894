"""Parallel training of the port (counterpart of ``mxnet_tpu/parallel``):
device meshes and ``SPMDTrainer``, on one device in this slice."""
from .mesh import AXIS_NAMES, DeviceMesh, current_mesh, get_mesh, make_mesh
from .spmd import FunctionalOptimizer, SPMDTrainer, functional_optimizer

__all__ = ["DeviceMesh", "make_mesh", "current_mesh", "get_mesh",
           "AXIS_NAMES", "SPMDTrainer", "FunctionalOptimizer",
           "functional_optimizer"]
