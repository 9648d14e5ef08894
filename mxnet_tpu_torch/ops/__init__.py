"""Ops of the port as plain functions on tensors (the ``F`` that
``hybrid_forward`` receives).  Counterpart of ``mxnet_tpu/ops``: besides
the functions imported below by their Python names, every registered op
is an attribute under its registered name (``F.MultiBoxPrior``,
``F.broadcast_greater``, ``F.argsort``), as in the JAX package."""
from __future__ import annotations

from . import contrib, image_ops, linalg, random_ops, rnn

from .attention import (attend, attention_launch_count,
                        dot_product_attention, dot_product_attention_ref,
                        reset_attention_launch_count)
from .fused_convbn import (bwd_launch_count, fused_conv_unit,
                           fused_conv_unit_bwd, fused_conv_unit_bwd_ref,
                           fused_conv_unit_ref, launch_count,
                           reset_bwd_launch_count, reset_launch_count)
from .nn import (activation, batch_norm, convolution, dropout, embedding,
                 flatten, fully_connected, layer_norm, log_softmax, pooling)
from .optimizer_ops import (adadelta_update, adagrad_update, adam_update,
                            adamax_update, ftrl_update, lamb_update_phase1,
                            lamb_update_phase2, mp_adam_update,
                            mp_sgd_mom_update, mp_sgd_update, multi_lars,
                            multi_mp_sgd_mom_update, multi_mp_sgd_update,
                            multi_sgd_mom_update, multi_sgd_update,
                            multi_sum_sq, nadam_update, nag_mom_update,
                            preloaded_multi_sgd_update, rmsprop_update,
                            rmspropalex_update, sgd_mom_update, sgd_update,
                            signsgd_update, signum_update)
from .registry import get_op as _get_op
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
           "mp_adam_update", "rmsprop_update", "rmspropalex_update",
           "ftrl_update", "signsgd_update", "signum_update",
           "adagrad_update", "adadelta_update", "adamax_update",
           "nadam_update", "multi_sum_sq", "multi_sgd_update",
           "multi_sgd_mom_update", "multi_mp_sgd_update",
           "multi_mp_sgd_mom_update", "preloaded_multi_sgd_update",
           "multi_lars", "lamb_update_phase1", "lamb_update_phase2", "pick", "mean", "sum",
           "arange_like", "expand_dims", "squeeze", "slice_axis", "cast",
           "broadcast_add", "broadcast_lesser", "contrib", "image_ops",
           "random_ops", "rnn"]


def __getattr__(name: str):
    """A registered op by its registered name (``F.MultiBoxTarget``)."""
    from ..base import MXNetError

    try:
        return _get_op(name).fn
    except MXNetError:
        raise AttributeError(f"module 'mxnet_tpu_torch.ops' has no "
                             f"attribute {name!r}") from None
