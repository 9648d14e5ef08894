"""Basic Gluon layers of the port (counterpart of
``mxnet_tpu/gluon/nn/basic_layers.py``): Sequential, HybridSequential,
Dense, Activation, Dropout, BatchNorm, InstanceNorm, LayerNorm,
GroupNorm, Embedding, Flatten, Identity, LeakyReLU, PReLU, ELU, SELU,
GELU, Swish (SiLU), Lambda, HybridLambda.

A layer whose parameter shapes follow its input (``in_units=0``,
``in_channels=0``, the default) defers them to its first forward
(``_infer_param_shapes``), as in the JAX package.  The layers read their
parameters as ``self._value("weight")`` (their ``hybrid_forward`` names
none); ``self.weight`` is the Gluon ``Parameter``.
"""
from __future__ import annotations

import torch

from ... import _graphs
from ... import initializer as init_mod
from ..block import Block, HybridBlock, trace_generator, train_mode

__all__ = ["Sequential", "HybridSequential", "Dense", "Dropout", "BatchNorm",
           "InstanceNorm", "LayerNorm", "GroupNorm", "Embedding", "Flatten",
           "Activation", "LeakyReLU", "PReLU", "ELU", "SELU", "GELU", "Swish",
           "SiLU", "Lambda", "HybridLambda", "Identity"]


class _Stack:
    """Children named 0, 1, 2, ... in the order they are added."""

    def add(self, *blocks):
        for b in blocks:
            self.add_module(str(len(self._modules)), b)
        return self

    def __getitem__(self, i):
        return list(self._modules.values())[i]

    def __len__(self):
        return len(self._modules)

    def __iter__(self):
        return iter(self._modules.values())


class Sequential(_Stack, Block):
    """An imperative stack of blocks."""

    def forward(self, x, *args):
        for b in self._modules.values():
            x = b(x)
        return x


class HybridSequential(_Stack, HybridBlock):
    def hybrid_forward(self, F, x):
        for b in self._modules.values():
            x = b(x)
        return x


class Dense(HybridBlock):
    """Fully connected layer (over the flattened input when ``flatten``),
    with an optional activation child ``act``; ``in_units=0`` defers the
    weight's input width to the first forward."""

    def __init__(self, units, activation=None, use_bias=True, flatten=True,
                 dtype="float32", weight_initializer=None,
                 bias_initializer="zeros", in_units=0, prefix=None,
                 params=None):
        super().__init__(prefix, params)
        self._units = units
        self._flatten = flatten
        self.weight = self._param("weight", (units, in_units),
                                  weight_initializer, dtype,
                                  allow_deferred=True)
        self.bias = self._param("bias", (units,), bias_initializer, dtype,
                                allow_deferred=True) if use_bias else None
        self.act = Activation(activation) if activation is not None else None

    def _infer_param_shapes(self, x, *args):
        in_units = x.numel() // x.shape[0] if self._flatten \
            else x.shape[-1]
        self._set_shape("weight", (self._units, int(in_units)))

    def hybrid_forward(self, F, x):
        bias = self._value("bias")
        out = F.fully_connected(x, self._value("weight"), bias,
                                num_hidden=self._units,
                                no_bias=bias is None,
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
    drawn from the trace scope's ``generator`` (one mask shared along
    ``axes``)."""

    def __init__(self, rate, axes=(), prefix=None, params=None):
        super().__init__(prefix, params)
        self._rate = rate
        self._axes = tuple(axes)

    def hybrid_forward(self, F, x):
        if self._rate == 0:
            return x
        kw = {"axes": self._axes} if self._axes else {}
        return F.dropout(x, p=self._rate, train=train_mode(self),
                         generator=trace_generator(), **kw)


def _channel_params(block, names_inits, in_channels, requires=None):
    for name, init in names_inits:
        block._param(name, (in_channels,), init, allow_deferred=True)
    for name, req in (requires or {}).items():
        block._value(name).requires_grad_(req)


class BatchNorm(HybridBlock):
    """gamma/beta are parameters, the moving statistics buffers.  Inside a
    trace scope the scope's ``train`` flag picks batch or moving
    statistics, outside one the module's mode does.  In training the
    statistics are updated in place from the batch (the port may update
    in place where the JAX package rebinds functional aux state); in a
    mirror segment the recompute reads the running mean its first pass
    read and updates nothing."""

    def __init__(self, axis=1, momentum=0.9, epsilon=1e-5, center=True,
                 scale=True, use_global_stats=False,
                 beta_initializer="zeros", gamma_initializer="ones",
                 running_mean_initializer="zeros",
                 running_variance_initializer="ones", in_channels=0,
                 prefix=None, params=None):
        super().__init__(prefix, params)
        self._axis = axis
        self._momentum = momentum
        self._epsilon = epsilon
        self._scale = scale
        self._use_global_stats = use_global_stats
        _channel_params(self, (("gamma", gamma_initializer),
                               ("beta", beta_initializer)), in_channels,
                        {"gamma": scale, "beta": center})
        self._buffer("running_mean", (in_channels,),
                     running_mean_initializer, allow_deferred=True)
        self._buffer("running_var", (in_channels,),
                     running_variance_initializer, allow_deferred=True)

    def _infer_param_shapes(self, x, *args):
        c = int(x.shape[self._axis])
        for n in ("gamma", "beta", "running_mean", "running_var"):
            self._set_shape(n, (c,))

    def cast(self, dtype):
        if str(dtype).replace("torch.", "") in ("float16", "bfloat16"):
            dtype = "float32"  # keep BN parameters and stats in fp32
        return super().cast(dtype)

    def hybrid_forward(self, F, x):
        # the trace's flag wins over the module's mode, as in the JAX
        # package (block.py:187): SPMDTrainer traces with train=True
        train = train_mode(self) and not self._use_global_stats
        rm = running_mean = self._value("running_mean")
        running_var = self._value("running_var")
        if train and _graphs.in_segment():
            rm = _graphs.segment_value(lambda: rm.detach().clone())
        res = F.batch_norm(x, self._value("gamma"), self._value("beta"), rm,
                           running_var, eps=self._epsilon,
                           momentum=self._momentum, fix_gamma=not self._scale,
                           use_global_stats=self._use_global_stats,
                           axis=self._axis, train=train)
        if not train:
            return res
        out, new_mean, new_var = res
        if not _graphs.segment_recomputing():
            with torch.no_grad():
                running_mean.copy_(new_mean)
                running_var.copy_(new_var)
        return out


class InstanceNorm(HybridBlock):
    def __init__(self, axis=1, epsilon=1e-5, center=True, scale=False,
                 beta_initializer="zeros", gamma_initializer="ones",
                 in_channels=0, prefix=None, params=None):
        super().__init__(prefix, params)
        self._epsilon = epsilon
        _channel_params(self, (("gamma", gamma_initializer),
                               ("beta", beta_initializer)), in_channels)

    def _infer_param_shapes(self, x, *args):
        for n in ("gamma", "beta"):
            self._set_shape(n, (int(x.shape[1]),))

    def hybrid_forward(self, F, x):
        return F.instance_norm(x, self._value("gamma"), self._value("beta"),
                               eps=self._epsilon)


class LayerNorm(HybridBlock):
    """Layer normalization over ``axis`` with gamma/beta of
    ``in_channels``."""

    def __init__(self, axis=-1, epsilon=1e-5, center=True, scale=True,
                 beta_initializer="zeros", gamma_initializer="ones",
                 in_channels=0, prefix=None, params=None):
        super().__init__(prefix, params)
        self._axis = axis
        self._epsilon = epsilon
        _channel_params(self, (("gamma", gamma_initializer),
                               ("beta", beta_initializer)), in_channels)

    def _infer_param_shapes(self, x, *args):
        for n in ("gamma", "beta"):
            self._set_shape(n, (int(x.shape[self._axis]),))

    def hybrid_forward(self, F, x):
        return F.layer_norm(x, self._value("gamma"), self._value("beta"),
                            axis=self._axis, eps=self._epsilon)


class GroupNorm(HybridBlock):
    def __init__(self, num_groups=1, epsilon=1e-5, center=True, scale=True,
                 beta_initializer="zeros", gamma_initializer="ones",
                 in_channels=0, prefix=None, params=None):
        super().__init__(prefix, params)
        self._num_groups = num_groups
        self._epsilon = epsilon
        _channel_params(self, (("gamma", gamma_initializer),
                               ("beta", beta_initializer)), in_channels)

    def _infer_param_shapes(self, x, *args):
        for n in ("gamma", "beta"):
            self._set_shape(n, (int(x.shape[1]),))

    def hybrid_forward(self, F, x):
        return F.group_norm(x, self._value("gamma"), self._value("beta"),
                            num_groups=self._num_groups, eps=self._epsilon)


class Embedding(HybridBlock):
    """Row lookup into an (input_dim, output_dim) table; out-of-range ids
    are clamped."""

    def __init__(self, input_dim, output_dim, dtype="float32",
                 weight_initializer=None, sparse_grad=False, prefix=None,
                 params=None):
        super().__init__(prefix, params)
        self._input_dim = input_dim
        self._output_dim = output_dim
        self.weight = self._param("weight", (input_dim, output_dim),
                                  weight_initializer, dtype)

    def hybrid_forward(self, F, x):
        return F.embedding(x, self._value("weight"))


class Flatten(HybridBlock):
    def hybrid_forward(self, F, x):
        return F.flatten(x)


class Identity(HybridBlock):
    def hybrid_forward(self, F, x):
        return x


class LeakyReLU(HybridBlock):
    def __init__(self, alpha, prefix=None, params=None):
        super().__init__(prefix, params)
        self._alpha = alpha

    def hybrid_forward(self, F, x):
        return F.leaky_relu(x, act_type="leaky", slope=self._alpha)


class PReLU(HybridBlock):
    """LeakyReLU with one learned slope ``alpha`` (initialized to 0.25)."""

    def __init__(self, alpha_initializer=None, prefix=None, params=None):
        super().__init__(prefix, params)
        self.alpha = self._param("alpha", (1,), alpha_initializer
                                 or init_mod.Constant(0.25))

    def hybrid_forward(self, F, x):
        return F.leaky_relu(x, self._value("alpha"), act_type="prelu")


class ELU(HybridBlock):
    def __init__(self, alpha=1.0, prefix=None, params=None):
        super().__init__(prefix, params)
        self._alpha = alpha

    def hybrid_forward(self, F, x):
        return F.leaky_relu(x, act_type="elu", slope=self._alpha)


class SELU(HybridBlock):
    def hybrid_forward(self, F, x):
        return F.leaky_relu(x, act_type="selu")


class GELU(HybridBlock):
    def __init__(self, approximation="erf", prefix=None, params=None):
        super().__init__(prefix, params)
        self._approx = approximation

    def hybrid_forward(self, F, x):
        return F.activation(
            x, act_type="gelu" if self._approx == "erf" else "gelu_tanh")


class Swish(HybridBlock):
    def __init__(self, beta=1.0, prefix=None, params=None):
        super().__init__(prefix, params)
        self._beta = beta

    def hybrid_forward(self, F, x):
        return x * F.sigmoid(x * self._beta)


SiLU = Swish


class Lambda(Block):
    """A function of NDArrays or tensors as a block (a name: the ``nd``
    function of that name)."""

    def __init__(self, function, prefix=None, params=None):
        super().__init__(prefix, params)
        if isinstance(function, str):
            from ... import ndarray as nd

            function = getattr(nd, function)
        self._func = function

    def forward(self, *args):
        return self._func(*args)


class HybridLambda(HybridBlock):
    """``function(F, x, *args)`` as a hybrid block (a name: the op of that
    name)."""

    def __init__(self, function, prefix=None, params=None):
        super().__init__(prefix, params)
        self._func_name = function if isinstance(function, str) else None
        self._func = function

    def hybrid_forward(self, F, x, *args):
        if self._func_name is not None:
            return getattr(F, self._func_name)(x, *args)
        return self._func(F, x, *args)
