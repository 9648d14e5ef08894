"""Basic Gluon layers of the port: HybridSequential, Dense, BatchNorm,
Activation, Flatten (counterpart of
``mxnet_tpu/gluon/nn/basic_layers.py``, with the options ResNet uses)."""
from __future__ import annotations

import torch

from ..block import HybridBlock

__all__ = ["HybridSequential", "Dense", "BatchNorm", "Activation", "Flatten"]


class HybridSequential(HybridBlock):
    """Children are named 0, 1, 2, … in the order they are added."""

    def add(self, *blocks):
        for b in blocks:
            self.add_module(str(len(self._modules)), b)
        return self

    def hybrid_forward(self, F, x):
        for b in self._modules.values():
            x = b(x)
        return x

    def __getitem__(self, i):
        return list(self._modules.values())[i]


class Dense(HybridBlock):
    """Fully connected layer over the flattened input."""

    def __init__(self, units, use_bias=True, weight_initializer=None,
                 in_units=0, prefix=None, params=None):
        super().__init__(prefix, params)
        self._units = units
        self.weight = self._param("weight", (units, in_units),
                                  weight_initializer)
        self.bias = self._param("bias", (units,), "zeros") \
            if use_bias else None

    def hybrid_forward(self, F, x):
        return F.fully_connected(x, self.weight, self.bias,
                                 num_hidden=self._units,
                                 no_bias=self.bias is None)


class Activation(HybridBlock):
    def __init__(self, activation, prefix=None, params=None):
        super().__init__(prefix, params)
        self._act_type = activation

    def hybrid_forward(self, F, x):
        return F.activation(x, act_type=self._act_type)


class BatchNorm(HybridBlock):
    """gamma/beta are parameters, the moving statistics buffers.  In
    training mode the statistics are updated in place from the batch (the
    port may update in place where the JAX package rebinds functional aux
    state)."""

    def __init__(self, axis=1, momentum=0.9, epsilon=1e-5, center=True,
                 scale=True, use_global_stats=False, in_channels=0,
                 prefix=None, params=None):
        super().__init__(prefix, params)
        self._axis = axis
        self._momentum = momentum
        self._epsilon = epsilon
        self._scale = scale
        self._use_global_stats = use_global_stats
        self.gamma = self._param("gamma", (in_channels,), "ones")
        self.beta = self._param("beta", (in_channels,), "zeros")
        self.gamma.requires_grad_(scale)
        self.beta.requires_grad_(center)
        self._buffer("running_mean", (in_channels,), "zeros")
        self._buffer("running_var", (in_channels,), "ones")

    def cast(self, dtype):
        if str(dtype).replace("torch.", "") in ("float16", "bfloat16"):
            dtype = "float32"  # keep BN parameters and stats in fp32
        return super().cast(dtype)

    def hybrid_forward(self, F, x):
        train = self.training and not self._use_global_stats
        res = F.batch_norm(x, self.gamma, self.beta, self.running_mean,
                           self.running_var, eps=self._epsilon,
                           momentum=self._momentum, fix_gamma=not self._scale,
                           use_global_stats=self._use_global_stats,
                           axis=self._axis, train=train)
        if not train:
            return res
        out, new_mean, new_var = res
        with torch.no_grad():
            self.running_mean.copy_(new_mean)
            self.running_var.copy_(new_var)
        return out


class Flatten(HybridBlock):
    def hybrid_forward(self, F, x):
        return F.flatten(x)
