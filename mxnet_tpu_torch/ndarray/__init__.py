"""mxnet_tpu_torch.ndarray (``nd``): NDArray, the creation functions and
the op namespace generated from the registry (counterpart of
``mxnet_tpu/ndarray/__init__.py``)."""
from __future__ import annotations

import numpy as _np
import torch as _torch

from .ndarray import (NDArray, arange, array, concatenate, empty, full,
                      ones, stack, wrap_outputs, zeros)
from . import image
from . import random
from . import sparse
from .sparse import (BaseSparseNDArray, CSRNDArray, RowSparseNDArray,
                     cast_storage)
from . import register as _register

__all__ = ["NDArray", "array", "zeros", "ones", "full", "empty", "arange",
           "concatenate", "stack", "image", "random", "waitall", "save",
           "load", "sparse", "BaseSparseNDArray", "CSRNDArray",
           "RowSparseNDArray", "cast_storage", "maximum", "minimum",
           "power", "modulo", "logical_and", "logical_or", "logical_xor",
           "linspace"]


def _scalar_or_elemwise(broadcast_op, scalar_op, rscalar_op=None):
    """A binary of two NDArrays (the broadcast op), of an NDArray and a
    number (the ``*_scalar`` op; ``rscalar_op``, the reversed one, for a
    number on the left of a function that does not commute), or of two
    numbers (a one-element array on the default device), as the JAX
    package's ``nd`` functions of that name dispatch."""
    def fn(lhs, rhs):
        l_nd, r_nd = isinstance(lhs, NDArray), isinstance(rhs, NDArray)
        if l_nd and r_nd:
            return _register.lookup(broadcast_op)(lhs, rhs)
        if l_nd:
            return _register.lookup(scalar_op)(lhs, scalar=float(rhs))
        if r_nd:
            return _register.lookup(rscalar_op or scalar_op)(
                rhs, scalar=float(lhs))
        return _register.lookup(scalar_op)(
            array(_np.asarray([lhs], _np.float32)), scalar=float(rhs))
    return fn


maximum = _scalar_or_elemwise("broadcast_maximum", "_maximum_scalar")
minimum = _scalar_or_elemwise("broadcast_minimum", "_minimum_scalar")
power = _scalar_or_elemwise("broadcast_power", "_power_scalar",
                            "_rpower_scalar")
modulo = _scalar_or_elemwise("broadcast_mod", "_mod_scalar", "_rmod_scalar")
logical_and = _scalar_or_elemwise("broadcast_logical_and",
                                  "_logical_and_scalar")
logical_or = _scalar_or_elemwise("broadcast_logical_or",
                                 "_logical_or_scalar")
logical_xor = _scalar_or_elemwise("broadcast_logical_xor",
                                  "_logical_xor_scalar")


def linspace(start, stop, num, endpoint=True, ctx=None, dtype=None):
    """``num`` evenly spaced values from start to stop (numpy's, in
    float64, then cast to ``dtype``, float32 by default), on ``ctx``."""
    a = _np.linspace(float(start), float(stop), int(num),
                     endpoint=bool(endpoint)).astype(dtype or "float32")
    return array(a, ctx=ctx)


def waitall():
    """Block until every card's queued work is done."""
    if _torch.cuda.is_available():
        _torch.cuda.synchronize()


def _to_record(v):
    from ..serialization import SparseRecord

    if isinstance(v, BaseSparseNDArray):
        aux = (v._aux["indptr"], v._aux["indices"]) \
            if isinstance(v, CSRNDArray) else (v._aux["indices"],)
        return SparseRecord(v.stype, v.shape, v.data._data, aux)
    return v._data


def _from_record(v):
    from ..context import cpu
    from ..serialization import SparseRecord

    if not isinstance(v, SparseRecord):
        return NDArray(v)
    if v.stype == "row_sparse":
        return sparse.row_sparse_array((v.values, v.aux[0]), shape=v.shape,
                                       ctx=cpu(), dtype=v.values.dtype)
    indptr, indices = v.aux
    return sparse.csr_matrix((v.values, indices, indptr), shape=v.shape,
                             ctx=cpu(), dtype=v.values.dtype)


def save(fname: str, data):
    """Save an NDArray, a list or a dict of them (the ``.params``
    format; sparse arrays as sparse records)."""
    from ..serialization import save_ndarrays

    if isinstance(data, NDArray):
        data = _to_record(data)
    elif isinstance(data, dict):
        data = {k: _to_record(v) for k, v in data.items()}
    else:
        data = [_to_record(v) for v in data]
    save_ndarrays(fname, data)


def load(fname: str):
    """A ``.params`` file as NDArrays on the CPU (a list, or a dict when
    the file names them; sparse records as sparse NDArrays)."""
    from ..serialization import load_ndarrays

    out = load_ndarrays(fname)
    if isinstance(out, dict):
        return {k: _from_record(v) for k, v in out.items()}
    return [_from_record(v) for v in out]


def __getattr__(name: str):
    try:
        return _register.lookup(name)
    except AttributeError:
        raise AttributeError(f"module 'mxnet_tpu_torch.ndarray' has no "
                             f"attribute {name!r}") from None
