"""Weight initializers (counterpart of ``mxnet_tpu/initializer.py``): the
ones the zoo's Conv2D, Dense and BatchNorm use by default, Normal (BERT),
Xavier and Constant (a value or a whole array: the Transformer's
position table).

Same dispatch by parameter-name suffix (``*bias``/``*beta``/
``*running_mean`` -> 0, ``*gamma``/``*running_var`` -> 1, anything else
-> the initializer's distribution) and the same distributions, drawn
from a ``torch.Generator`` that the caller seeds.  The streams do not
match JAX's threefry draws: parity tests carry weights across instead.
Values are drawn in fp32 on the CPU, then moved and cast by the caller.
"""
from __future__ import annotations

import math

import torch

from .base import MXNetError

__all__ = ["Initializer", "create", "Zero", "One", "Constant", "Uniform",
           "Normal", "Xavier"]


class Initializer:
    """Base initializer; subclasses implement ``_init_weight``."""

    def __init__(self, **kwargs):
        self._kwargs = kwargs

    def __call__(self, name: str, arr: torch.Tensor,
                 generator: torch.Generator) -> None:
        """Fill ``arr`` (fp32, CPU) in place by the name convention."""
        n = name.lower()
        if n.endswith(("bias", "beta", "moving_mean", "running_mean")):
            arr.fill_(0.0)
        elif n.endswith(("gamma", "moving_var", "running_var")):
            arr.fill_(1.0)
        else:
            self._init_weight(name, arr, generator)

    def init_array(self, name, arr, generator):
        """Unconditional init of ``arr`` with this distribution."""
        self._init_weight(name, arr, generator)

    def _init_weight(self, name, arr, generator):
        raise NotImplementedError

    def __repr__(self):
        return f"{type(self).__name__}({self._kwargs})"


class Zero(Initializer):
    def _init_weight(self, name, arr, generator):
        arr.fill_(0.0)


class One(Initializer):
    def _init_weight(self, name, arr, generator):
        arr.fill_(1.0)


class Constant(Initializer):
    """Fill with ``value``: a scalar, or an array of the parameter's
    shape."""

    def __init__(self, value=0.0):
        super().__init__(value=value)
        self.value = value

    def _init_weight(self, name, arr, generator):
        arr.copy_(torch.as_tensor(self.value, dtype=arr.dtype))


class Uniform(Initializer):
    def __init__(self, scale=0.07):
        super().__init__(scale=scale)
        self.scale = scale

    def _init_weight(self, name, arr, generator):
        arr.uniform_(-self.scale, self.scale, generator=generator)


class Normal(Initializer):
    def __init__(self, sigma=0.01):
        super().__init__(sigma=sigma)
        self.sigma = sigma

    def _init_weight(self, name, arr, generator):
        arr.normal_(0.0, self.sigma, generator=generator)


class Xavier(Initializer):
    """rnd_type uniform|gaussian, factor_type avg|in|out, magnitude."""

    def __init__(self, rnd_type="uniform", factor_type="avg", magnitude=3):
        super().__init__(rnd_type=rnd_type, factor_type=factor_type,
                         magnitude=magnitude)
        self.rnd_type = rnd_type
        self.factor_type = factor_type
        self.magnitude = float(magnitude)

    def _init_weight(self, name, arr, generator):
        shape = arr.shape
        hw_scale = float(math.prod(shape[2:])) if len(shape) > 2 else 1.0
        fan_in = (shape[1] if len(shape) > 1 else shape[0]) * hw_scale
        fan_out = shape[0] * hw_scale
        factor = {"avg": (fan_in + fan_out) / 2.0, "in": fan_in,
                  "out": fan_out}.get(self.factor_type)
        if factor is None:
            raise MXNetError(f"bad factor_type {self.factor_type}")
        scale = math.sqrt(self.magnitude / max(factor, 1.0))
        if self.rnd_type == "uniform":
            arr.uniform_(-scale, scale, generator=generator)
        elif self.rnd_type == "gaussian":
            arr.normal_(0.0, scale, generator=generator)
        else:
            raise MXNetError(f"bad rnd_type {self.rnd_type}")


_REG = {"zeros": Zero, "zero": Zero, "ones": One, "one": One,
        "constant": Constant,
        "uniform": Uniform, "normal": Normal, "xavier": Xavier}


def create(init) -> Initializer:
    """An initializer from an instance, a registered name, or None (the
    default, Uniform(0.07))."""
    if isinstance(init, Initializer):
        return init
    if init is None:
        return Uniform(0.07)
    if isinstance(init, str) and init.lower() in _REG:
        return _REG[init.lower()]()
    raise MXNetError(f"cannot create initializer from {init!r}; ported: "
                     f"{sorted(_REG)}")
