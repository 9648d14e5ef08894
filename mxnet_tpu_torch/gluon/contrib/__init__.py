"""Gluon contrib of the port (counterpart of
``mxnet_tpu/gluon/contrib``): the contrib layers and the Estimator fit
loop."""
from . import estimator
from . import nn

__all__ = ["estimator", "nn"]
