"""Ops of the port as plain functions on tensors (the ``F`` that
``hybrid_forward`` receives).  Counterpart of ``mxnet_tpu/ops``."""
from __future__ import annotations

from .fused_convbn import (fused_conv_unit, fused_conv_unit_ref,
                           launch_count, reset_launch_count)
from .nn import (activation, batch_norm, convolution, flatten,
                 fully_connected, pooling)

__all__ = ["fused_conv_unit", "fused_conv_unit_ref", "launch_count",
           "reset_launch_count", "activation", "batch_norm", "convolution",
           "flatten", "fully_connected", "pooling"]
