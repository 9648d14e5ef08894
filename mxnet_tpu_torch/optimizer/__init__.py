"""Optimizers of the port (counterpart of ``mxnet_tpu/optimizer``)."""
from .optimizer import (LAMB, NAG, SGD, AdaDelta, AdaGrad, Adam, Adamax,
                        Ftrl, Nadam, Optimizer, RMSProp, Signum, SignSGD,
                        Test, Updater, create, get_updater, register)
from . import fused
from .fused import FusedUnsupported, FusedUpdater

__all__ = ["Optimizer", "SGD", "NAG", "Adam", "AdaGrad", "AdaDelta",
           "Adamax", "Nadam", "RMSProp", "Ftrl", "Signum", "SignSGD", "LAMB",
           "Test", "Updater", "create", "register", "get_updater", "fused",
           "FusedUpdater", "FusedUnsupported"]
