"""``nd.random`` (counterpart of ``mxnet_tpu/ndarray/random.py``).

Each sampler draws on ``ctx`` (``out``'s device when ``out`` is given;
the default context, gpu(0), otherwise, which raises without CUDA as
every entry point of the port does) from that device's generator
(``random.generator``), so the draw is made on the device and nothing
is copied from the host.  ``out`` fixes the shape, dtype and device and
is filled in place.
"""
from __future__ import annotations

import torch

from .. import random as _random
from ..base import MXNetError, dtype_of
from ..ops.registry import invoke

__all__ = ["uniform", "normal", "randn", "randint", "gamma", "exponential",
           "poisson", "negative_binomial", "multinomial", "shuffle",
           "bernoulli", "gumbel", "laplace", "seed"]

seed = _random.seed


def _sample(op, shape, dtype, ctx, out=None, **params):
    """One draw of ``op``: with ``out``, its shape, dtype and device are
    the draw's (an explicit shape or dtype must agree) and it is filled
    and returned."""
    if out is not None:
        if shape is not None and tuple(out.shape) != (
                (shape,) if isinstance(shape, int) else tuple(shape)):
            raise MXNetError(f"out shape {out.shape} != requested {shape}")
        if dtype is not None and dtype_of(dtype) != out._data.dtype:
            raise MXNetError(f"out dtype {out.dtype} != requested {dtype}")
        shape, dtype, ctx = out.shape, out._data.dtype, ctx or out.ctx
    if shape is None:
        shape = (1,)
    if isinstance(shape, int):
        shape = (shape,)
    res = invoke(op, _random.generator(ctx), shape=tuple(shape),
                 dtype=dtype or "float32", **params)
    if out is None:
        return res
    with torch.no_grad():
        out._data.copy_(res._data)
    return out


def uniform(low=0.0, high=1.0, shape=None, dtype=None, ctx=None, out=None):
    return _sample("_random_uniform", shape, dtype, ctx, out=out, low=low,
                   high=high)


def normal(loc=0.0, scale=1.0, shape=None, dtype=None, ctx=None, out=None):
    return _sample("_random_normal", shape, dtype, ctx, out=out, loc=loc,
                   scale=scale)


def randn(*shape, dtype=None, ctx=None):
    return normal(0.0, 1.0, shape or (1,), dtype=dtype, ctx=ctx)


def randint(low, high, shape=None, dtype=None, ctx=None, out=None):
    """Integers in [low, high): int32 unless ``dtype`` or ``out`` says
    otherwise."""
    if dtype is None and out is None:
        dtype = "int32"
    return _sample("_random_randint", shape, dtype, ctx, out=out, low=low,
                   high=high)


def gamma(alpha=1.0, beta=1.0, shape=None, dtype=None, ctx=None, out=None):
    return _sample("_random_gamma", shape, dtype, ctx, out=out, alpha=alpha,
                   beta=beta)


def exponential(scale=1.0, shape=None, dtype=None, ctx=None, out=None):
    return _sample("_random_exponential", shape, dtype, ctx, out=out,
                   lam=1.0 / scale)


def poisson(lam=1.0, shape=None, dtype=None, ctx=None, out=None):
    return _sample("_random_poisson", shape, dtype, ctx, out=out, lam=lam)


def negative_binomial(k=1, p=1.0, shape=None, dtype=None, ctx=None,
                      out=None):
    return _sample("_random_negative_binomial", shape, dtype, ctx, out=out,
                   k=k, p=p)


def gumbel(loc=0.0, scale=1.0, shape=None, dtype=None, ctx=None, out=None):
    return _sample("_random_gumbel", shape, dtype, ctx, out=out, loc=loc,
                   scale=scale)


def laplace(loc=0.0, scale=1.0, shape=None, dtype=None, ctx=None, out=None):
    return _sample("_random_laplace", shape, dtype, ctx, out=out, loc=loc,
                   scale=scale)


def bernoulli(p=0.5, shape=None, dtype=None, ctx=None, out=None):
    return _sample("_random_bernoulli", shape, dtype, ctx, out=out, p=p)


def multinomial(data, shape=(), get_prob=False, dtype="int32", **kw):
    """Category draws from each row of ``data``, on data's device."""
    return invoke("_sample_multinomial", _random.generator(data.ctx), data,
                  shape=(shape,) if isinstance(shape, int) else tuple(shape),
                  get_prob=get_prob, dtype=dtype)


def shuffle(data, **kw):
    """data with its first axis permuted, on data's device."""
    return invoke("_shuffle", _random.generator(data.ctx), data)
