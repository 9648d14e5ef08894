"""mxnet_tpu_torch — the PyTorch/CUDA port of mxnet_tpu.

A second package beside the JAX one, with its module names and
structure, in PyTorch's idiom: blocks are ``nn.Module``s, ops are plain
functions on tensors, devices are explicit and random draws take an
explicit ``torch.Generator``.  Every Pallas kernel of the JAX package
on a ported path is a hand-written CUDA kernel for Hopper (``csrc/``),
built with nvcc at first use.  The port imports neither jax nor
anything of ``mxnet_tpu``.

Slice 1 serves ResNet V1 (``gluon.model_zoo.vision``) through
``contrib.deploy`` and ``serving``.
"""
from __future__ import annotations

from .base import MXNetError
from .context import cpu, current_context, gpu, tpu
from . import initializer
from . import initializer as init
from . import ops, serialization

__all__ = ["MXNetError", "cpu", "gpu", "tpu", "current_context",
           "initializer", "init", "ops", "serialization"]
