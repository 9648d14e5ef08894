"""Optimizers of the port (counterpart of ``mxnet_tpu/optimizer``)."""
from .optimizer import (NAG, SGD, Optimizer, Updater, create, get_updater,
                        register)

__all__ = ["Optimizer", "SGD", "NAG", "Updater", "create", "register",
           "get_updater"]
