"""Optimizers of the port (counterpart of ``mxnet_tpu/optimizer``)."""
from .optimizer import NAG, SGD, Optimizer, create, register

__all__ = ["Optimizer", "SGD", "NAG", "create", "register"]
