"""Weight initializers (counterpart of ``mxnet_tpu/initializer.py``):
Zero, One, Constant (a value or a whole array: the Transformer's
position table), Uniform, Normal, Orthogonal, Xavier, MSRAPrelu,
Bilinear, LSTMBias and Mixed, with ``InitDesc`` and ``create``.

Same dispatch by parameter-name suffix (``*bias``/``*beta``/
``*moving_mean``/``*running_mean``/``*min``/``*max`` -> 0,
``*gamma``/``*moving_var``/``*running_var`` -> 1, anything else -> the
initializer's distribution; an ``InitDesc`` whose ``__init__``
attribute names an initializer takes that one), which
``Module.init_params`` relies on, and the same distributions, drawn
from a ``torch.Generator`` that the caller seeds.  The streams do not
match the JAX package's numpy draws: parity tests carry weights across
instead.  Values are drawn in fp32 on the CPU, then moved and cast by
the caller.
"""
from __future__ import annotations

import json
import math
import re

import torch

from .base import MXNetError

__all__ = ["Initializer", "InitDesc", "create", "Zero", "One", "Constant",
           "Uniform", "Normal", "Orthogonal", "Xavier", "MSRAPrelu",
           "Bilinear", "LSTMBias", "Mixed"]


class InitDesc(str):
    """A parameter's name carrying its symbol attributes (``attrs``, e.g.
    ``{"__init__": "zeros"}``) and the global initializer."""

    def __new__(cls, name, attrs=None, global_init=None):
        obj = super().__new__(cls, name)
        obj.attrs = attrs or {}
        obj.global_init = global_init
        return obj


class Initializer:
    """Base initializer; subclasses implement ``_init_weight``."""

    def __init__(self, **kwargs):
        self._kwargs = kwargs

    def __call__(self, name: str, arr: torch.Tensor,
                 generator: torch.Generator) -> None:
        """Fill ``arr`` (fp32, CPU) in place by the name convention."""
        attr_init = getattr(name, "attrs", {}).get("__init__")
        if attr_init:
            create(attr_init).init_array(name, arr, generator)
            return
        n = str(name).lower()
        if n.endswith(("bias", "beta", "moving_mean", "running_mean", "min",
                       "max")):
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

    def dumps(self) -> str:
        """``[name, kwargs]`` as JSON, which :func:`create` reads back."""
        return json.dumps([type(self).__name__.lower(), self._kwargs])


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


class Orthogonal(Initializer):
    """A random orthogonal matrix (of the weight flattened to (out,
    in)) times ``scale``, from the SVD of a uniform or normal draw."""

    def __init__(self, scale=1.414, rand_type="uniform"):
        super().__init__(scale=scale, rand_type=rand_type)
        self.scale = scale
        self.rand_type = rand_type

    def _init_weight(self, name, arr, generator):
        nout = arr.shape[0]
        nin = math.prod(arr.shape[1:]) if arr.dim() > 1 else 1
        tmp = torch.empty(nout, nin, dtype=torch.float64)
        if self.rand_type == "uniform":
            tmp.uniform_(-1.0, 1.0, generator=generator)
        else:
            tmp.normal_(0.0, 1.0, generator=generator)
        u, _, v = torch.linalg.svd(tmp, full_matrices=False)
        q = u if u.shape == tmp.shape else v
        arr.copy_((self.scale * q).reshape(arr.shape))


class MSRAPrelu(Xavier):
    """Xavier gaussian with magnitude 2 / (1 + slope^2) (He et al.)."""

    def __init__(self, factor_type="avg", slope=0.25):
        super().__init__("gaussian", factor_type, 2.0 / (1 + slope ** 2))
        self._kwargs = {"factor_type": factor_type, "slope": slope}


class Bilinear(Initializer):
    """The bilinear upsampling kernel, for every (out, in) pair."""

    def _init_weight(self, name, arr, generator):
        kh, kw = arr.shape[2], arr.shape[3]
        f = math.ceil(kw / 2.0)
        c = (2 * f - 1 - f % 2) / (2.0 * f)
        x = torch.arange(kw, dtype=torch.float64)
        y = torch.arange(kh, dtype=torch.float64)
        k = (1 - (y / f - c).abs())[:, None] * (1 - (x / f - c).abs())
        arr.copy_(k.to(torch.float32).expand(arr.shape))


class LSTMBias(Initializer):
    """Zeros, with the forget gate's quarter set to ``forget_bias``."""

    def __init__(self, forget_bias=1.0):
        super().__init__(forget_bias=forget_bias)
        self.forget_bias = forget_bias

    def _init_weight(self, name, arr, generator):
        arr.fill_(0.0)
        n = arr.shape[0] // 4
        arr[n:2 * n] = self.forget_bias


class Mixed(Initializer):
    """The initializer of the first regular expression in ``patterns``
    that matches the parameter's name."""

    def __init__(self, patterns, initializers):
        super().__init__()
        self.map = [(re.compile(p), create(i))
                    for p, i in zip(patterns, initializers)]

    def __call__(self, name, arr, generator):
        for pat, init in self.map:
            if pat.match(str(name)):
                init(name, arr, generator)
                return
        raise MXNetError(f"parameter {name} did not match any pattern")


_REG = {"zeros": Zero, "zero": Zero, "ones": One, "one": One,
        "constant": Constant, "uniform": Uniform, "normal": Normal,
        "orthogonal": Orthogonal, "xavier": Xavier, "msraprelu": MSRAPrelu,
        "bilinear": Bilinear, "lstmbias": LSTMBias, "mixed": Mixed}


def create(init, **kwargs) -> Initializer:
    """An initializer from an instance, a registered name (with
    ``kwargs``), a :meth:`Initializer.dumps` string, or None (the
    default, Uniform(0.07))."""
    if isinstance(init, Initializer):
        return init
    if init is None:
        return Uniform(0.07)
    if isinstance(init, str) and init.startswith("["):
        name, kw = json.loads(init)
        return create(name, **{**kw, **kwargs})
    if isinstance(init, str) and init.lower() in _REG:
        return _REG[init.lower()](**kwargs)
    raise MXNetError(f"cannot create initializer from {init!r}; ported: "
                     f"{sorted(_REG)}")
