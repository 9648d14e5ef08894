"""Basic Gluon layers of the port: HybridSequential, Dense, Activation,
Dropout, BatchNorm, LayerNorm, Embedding, Flatten (counterpart of
``mxnet_tpu/gluon/nn/basic_layers.py``, with the options ResNet and BERT
use)."""
from __future__ import annotations

import torch

from ..block import HybridBlock, trace_generator, train_mode

__all__ = ["HybridSequential", "Dense", "BatchNorm", "Activation", "Dropout",
           "LayerNorm", "Embedding", "Flatten"]


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
    """Fully connected layer (over the flattened input when ``flatten``),
    with an optional activation child ``act``."""

    def __init__(self, units, activation=None, use_bias=True, flatten=True,
                 dtype="float32", weight_initializer=None, in_units=0,
                 prefix=None, params=None):
        super().__init__(prefix, params)
        self._units = units
        self._flatten = flatten
        self.weight = self._param("weight", (units, in_units),
                                  weight_initializer, dtype)
        self.bias = self._param("bias", (units,), "zeros", dtype) \
            if use_bias else None
        self.act = Activation(activation) if activation is not None else None

    def hybrid_forward(self, F, x):
        out = F.fully_connected(x, self.weight, self.bias,
                                num_hidden=self._units,
                                no_bias=self.bias is None,
                                flatten=self._flatten)
        return self.act(out) if self.act is not None else out


class Activation(HybridBlock):
    def __init__(self, activation, prefix=None, params=None):
        super().__init__(prefix, params)
        self._act_type = activation

    def hybrid_forward(self, F, x):
        return F.activation(x, act_type=self._act_type)


class Dropout(HybridBlock):
    """Inverted dropout in training (the trace's flag inside a trace
    scope, else the module's mode), the identity otherwise.  Its mask is
    drawn from the trace scope's ``generator``."""

    def __init__(self, rate, prefix=None, params=None):
        super().__init__(prefix, params)
        self._rate = rate

    def hybrid_forward(self, F, x):
        if self._rate == 0:
            return x
        return F.dropout(x, p=self._rate, train=train_mode(self),
                         generator=trace_generator())


class BatchNorm(HybridBlock):
    """gamma/beta are parameters, the moving statistics buffers.  Inside a
    trace scope the scope's ``train`` flag picks batch or moving
    statistics, outside one the module's mode does.  In training the
    statistics are updated in place from the batch (the port may update
    in place where the JAX package rebinds functional aux state)."""

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
        # the trace's flag wins over the module's mode, as in the JAX
        # package (block.py:187): SPMDTrainer traces with train=True
        train = train_mode(self) and not self._use_global_stats
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


class LayerNorm(HybridBlock):
    """Layer normalization over ``axis`` with gamma/beta of
    ``in_channels``."""

    def __init__(self, axis=-1, epsilon=1e-5, in_channels=0, prefix=None,
                 params=None):
        super().__init__(prefix, params)
        self._axis = axis
        self._epsilon = epsilon
        self.gamma = self._param("gamma", (in_channels,), "ones")
        self.beta = self._param("beta", (in_channels,), "zeros")

    def hybrid_forward(self, F, x):
        return F.layer_norm(x, self.gamma, self.beta, axis=self._axis,
                            eps=self._epsilon)


class Embedding(HybridBlock):
    """Row lookup into an (input_dim, output_dim) table; out-of-range ids
    are clamped."""

    def __init__(self, input_dim, output_dim, prefix=None, params=None):
        super().__init__(prefix, params)
        self.weight = self._param("weight", (input_dim, output_dim))

    def hybrid_forward(self, F, x):
        return F.embedding(x, self.weight)


class Flatten(HybridBlock):
    def hybrid_forward(self, F, x):
        return F.flatten(x)
