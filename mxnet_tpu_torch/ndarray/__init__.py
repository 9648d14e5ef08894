"""mxnet_tpu_torch.ndarray (``nd``): NDArray, the creation functions and
the op namespace generated from the registry (counterpart of
``mxnet_tpu/ndarray/__init__.py``)."""
from __future__ import annotations

import torch as _torch

from .ndarray import (NDArray, arange, array, concatenate, empty, full,
                      ones, wrap_outputs, zeros)
from . import register as _register

__all__ = ["NDArray", "array", "zeros", "ones", "full", "empty", "arange",
           "concatenate", "waitall", "save", "load", "maximum", "minimum"]


def _elemwise_or_scalar(broadcast_op, scalar_op):
    """A commutative binary of two NDArrays (broadcast) or of an NDArray
    and a number (the ``*_scalar`` op), as the JAX package's ``nd``
    module-level function of that name."""
    def fn(lhs, rhs):
        if isinstance(lhs, NDArray) and isinstance(rhs, NDArray):
            return _register.lookup(broadcast_op)(lhs, rhs)
        if not isinstance(lhs, NDArray):
            lhs, rhs = rhs, lhs
        return _register.lookup(scalar_op)(lhs, scalar=float(rhs))
    return fn


maximum = _elemwise_or_scalar("broadcast_maximum", "_maximum_scalar")
minimum = _elemwise_or_scalar("broadcast_minimum", "_minimum_scalar")


def waitall():
    """Block until every card's queued work is done."""
    if _torch.cuda.is_available():
        _torch.cuda.synchronize()


def save(fname: str, data):
    """Save an NDArray, a list or a dict of them (the ``.params``
    format)."""
    from ..serialization import save_ndarrays

    if isinstance(data, NDArray):
        data = data._data
    elif isinstance(data, dict):
        data = {k: v._data for k, v in data.items()}
    else:
        data = [v._data for v in data]
    save_ndarrays(fname, data)


def load(fname: str):
    """A ``.params`` file as NDArrays on the CPU (a list, or a dict when
    the file names them)."""
    from ..serialization import load_ndarrays

    out = load_ndarrays(fname)
    if isinstance(out, dict):
        return {k: NDArray(v) for k, v in out.items()}
    return [NDArray(v) for v in out]


def __getattr__(name: str):
    try:
        return _register.lookup(name)
    except AttributeError:
        raise AttributeError(f"module 'mxnet_tpu_torch.ndarray' has no "
                             f"attribute {name!r}") from None
