"""Gluon contrib layers of the port (counterpart of
``mxnet_tpu/gluon/contrib/nn.py``): Concurrent, HybridConcurrent,
Identity, SparseEmbedding (dense-backed), SyncBatchNorm (an alias of
BatchNorm) and PixelShuffle2D."""
from __future__ import annotations

from .. import nn as _nn
from ..block import HybridBlock

__all__ = ["Concurrent", "HybridConcurrent", "Identity", "SparseEmbedding",
           "SyncBatchNorm", "PixelShuffle2D"]


class HybridConcurrent(HybridBlock):
    """Parallel branches on one input, concatenated along ``axis``;
    children named 0, 1, 2, ... in the order they are added."""

    def __init__(self, axis=-1, prefix=None, params=None):
        super().__init__(prefix, params)
        self.axis = axis

    def add(self, block):
        self.add_module(str(len(self._modules)), block)
        return self

    def hybrid_forward(self, F, x):
        return F.concat(*[c(x) for c in self._modules.values()],
                        dim=self.axis)


Concurrent = HybridConcurrent
Identity = _nn.Identity


class SparseEmbedding(_nn.Embedding):
    """The JAX package's dense-gradient Embedding: its row-sparse
    gradient is a dense one here too, with the same values."""


class SyncBatchNorm(_nn.BatchNorm):
    """BatchNorm over channel axis 1.  Under a data-parallel mesh the
    port's BatchNorm already sums its statistics over the ranks
    (``ops.nn.batch_norm``), so ``num_devices`` changes nothing."""

    def __init__(self, in_channels=0, num_devices=None, momentum=0.9,
                 epsilon=1e-5, **kwargs):
        super().__init__(axis=1, momentum=momentum, epsilon=epsilon,
                         in_channels=in_channels, **kwargs)


class PixelShuffle2D(HybridBlock):
    """(N, C*f*f, H, W) -> (N, C, H*f, W*f) (``depth_to_space``)."""

    def __init__(self, factor, prefix=None, params=None):
        super().__init__(prefix, params)
        self._factor = int(factor[0]) if isinstance(factor, (tuple, list)) \
            else int(factor)

    def hybrid_forward(self, F, x):
        return F.depth_to_space(x, block_size=self._factor)
