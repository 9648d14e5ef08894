"""Optimizers of the port (counterpart of ``mxnet_tpu/optimizer``)."""
from .optimizer import (NAG, SGD, Adam, Optimizer, Updater, create,
                        get_updater, register)
from . import fused
from .fused import FusedUnsupported, FusedUpdater

__all__ = ["Optimizer", "SGD", "NAG", "Adam", "Updater", "create", "register",
           "get_updater", "fused", "FusedUpdater", "FusedUnsupported"]
