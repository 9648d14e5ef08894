"""Ops of the port as plain functions on tensors (the ``F`` that
``hybrid_forward`` receives).  Counterpart of ``mxnet_tpu/ops``."""
from __future__ import annotations

from .attention import (attend, attention_launch_count,
                        dot_product_attention, dot_product_attention_ref,
                        reset_attention_launch_count)
from .fused_convbn import (bwd_launch_count, fused_conv_unit,
                           fused_conv_unit_bwd, fused_conv_unit_bwd_ref,
                           fused_conv_unit_ref, launch_count,
                           reset_bwd_launch_count, reset_launch_count)
from .nn import (activation, batch_norm, convolution, dropout, embedding,
                 flatten, fully_connected, layer_norm, log_softmax, pooling)
from .optimizer_ops import (adam_update, mp_adam_update, mp_sgd_mom_update,
                            mp_sgd_update, nag_mom_update, sgd_mom_update,
                            sgd_update)
from .tensor import (arange_like, broadcast_add, broadcast_lesser, cast,
                     expand_dims, mean, pick, slice_axis, squeeze,
                     sum)  # noqa: A004 — op names

__all__ = ["fused_conv_unit", "fused_conv_unit_ref", "fused_conv_unit_bwd",
           "fused_conv_unit_bwd_ref", "launch_count", "reset_launch_count",
           "bwd_launch_count", "reset_bwd_launch_count",
           "dot_product_attention", "dot_product_attention_ref", "attend",
           "attention_launch_count", "reset_attention_launch_count",
           "activation", "batch_norm", "convolution", "dropout", "embedding",
           "flatten", "fully_connected", "layer_norm", "log_softmax",
           "pooling", "sgd_update", "sgd_mom_update", "nag_mom_update",
           "mp_sgd_update", "mp_sgd_mom_update", "adam_update",
           "mp_adam_update", "pick", "mean", "sum",
           "arange_like", "expand_dims", "squeeze", "slice_axis", "cast",
           "broadcast_add", "broadcast_lesser"]
