"""NDArray: MXNet's imperative array over a ``torch.Tensor`` (counterpart
of ``mxnet_tpu/ndarray/ndarray.py``).

  * The payload is a tensor on one device; ``ctx`` is that
    ``torch.device``.  PyTorch dispatch on a CUDA device is asynchronous,
    so ``asnumpy``/``asscalar``/``wait_to_read`` are the sync points, as
    in the JAX package.
  * Operators and methods go through the op registry
    (``ops.registry.invoke``), which records on ``torch.autograd`` only
    under ``autograd.record()``.
  * Basic indexing and reshape return views that write through to the
    base (PyTorch's own views), as ``_make_view`` makes them in the JAX
    package.  Sliced assignment and in-place operators outside
    recording write into the tensor under ``torch.no_grad()``, so they
    never record a write into a parameter's graph and never hit
    PyTorch's error for in-place writes on a leaf.  Under recording an
    in-place operator rebinds the array to the recorded result (the
    JAX package's ``_inplace``), and its gradient still reaches the
    leaf that ``attach_grad`` marked.
  * ``attach_grad`` marks the tensor as a leaf with a gradient buffer
    and a ``grad_req`` (see ``autograd.py``).
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ..base import MXNetError, dtype_of, integer_types, np_dtype, \
    numeric_types
from ..context import cpu, resolve

__all__ = ["NDArray", "wrap_outputs", "array", "zeros", "ones", "full",
           "empty", "arange", "to_numpy"]


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """A copy of a tensor's values on the host, never a view of its
    storage (``.cpu()`` copies a device tensor, a host tensor is cloned),
    as MXNet's and the JAX package's ``asnumpy`` return one.  bf16 comes
    back as ml_dtypes' bfloat16 with the same bits, which is what the JAX
    package's ``asnumpy`` returns for a bf16 array; without ml_dtypes
    installed, as float32 (every bf16 value is exact in it)."""
    t = t.detach()
    host = t.cpu() if t.device.type != "cpu" else t.clone()
    if t.dtype == torch.bfloat16:
        bits = host.contiguous().view(torch.int16).numpy()
        dt = np_dtype(torch.bfloat16)
        return bits.view(dt) if not isinstance(dt, str) \
            else host.float().numpy()
    return host.numpy()


def _key(key):
    if isinstance(key, NDArray):
        return key._data.long()
    if isinstance(key, tuple):
        return tuple(_key(k) for k in key)
    return key


_NARROW = {torch.float64: torch.float32, torch.int64: torch.int32}


class NDArray:
    """An imperative n-dimensional array on one device."""

    __slots__ = ("_data", "_ag_leaf", "__weakref__")

    # make NDArray win over numpy in mixed operators
    __array_priority__ = 1000.0

    def __init__(self, data, ctx=None, dtype=None):
        if isinstance(data, NDArray):
            data = data._data
        if not isinstance(data, torch.Tensor):
            data = torch.as_tensor(np.asarray(data))
            if dtype is None:  # x32, as the JAX package's arrays
                dtype = _NARROW.get(data.dtype)
        if dtype is not None and data.dtype != dtype_of(dtype):
            data = data.to(dtype_of(dtype))
        if ctx is not None and data.device != resolve(ctx):
            data = data.to(resolve(ctx))
        self._data = data
        self._ag_leaf = None

    # ---- core properties -------------------------------------------------
    @property
    def data(self) -> torch.Tensor:
        """The underlying tensor."""
        return self._data

    @property
    def shape(self) -> Tuple[int, ...]:
        return tuple(self._data.shape)

    @property
    def dtype(self):
        return np_dtype(self._data.dtype)

    @property
    def ndim(self) -> int:
        return self._data.dim()

    @property
    def size(self) -> int:
        return self._data.numel()

    @property
    def ctx(self) -> torch.device:
        return self._data.device

    context = ctx

    @property
    def stype(self) -> str:
        return "default"

    def __len__(self):
        if not self.shape:
            raise TypeError("len() of unsized object")
        return self.shape[0]

    def __repr__(self):
        dims = "x".join(map(str, self.shape))
        return f"\n{self.asnumpy()}\n<NDArray {dims} @{self.ctx}>"

    def __bool__(self):
        if self.size != 1:
            raise MXNetError("The truth value of an NDArray with multiple "
                             "elements is ambiguous.")
        return bool(self.asnumpy().item())

    # ---- sync points -----------------------------------------------------
    def asnumpy(self) -> np.ndarray:
        return to_numpy(self._data)

    def asscalar(self):
        if self.size != 1:
            raise MXNetError("The current array is not a scalar")
        return self.asnumpy().item()

    def item(self):
        return self.asscalar()

    def wait_to_read(self):
        if self._data.is_cuda:
            torch.cuda.synchronize(self._data.device)
        return self

    def __array__(self, dtype=None, copy=None):
        a = self.asnumpy()
        return a.astype(dtype) if dtype is not None else a

    def tolist(self):
        return self.asnumpy().tolist()

    # ---- conversions / movement ----------------------------------------
    def astype(self, dtype, copy: bool = True) -> "NDArray":
        dt = dtype_of(dtype)
        if not copy and self._data.dtype == dt:
            return self
        return self._op("cast", dtype=dt)

    def copy(self) -> "NDArray":
        """A copy off the autograd graph (the JAX package's copy is not
        recorded either)."""
        return NDArray(self._data.detach().clone())

    def copyto(self, other):
        if not isinstance(other, NDArray):
            return self.as_in_context(other)
        with torch.no_grad():
            other._data.copy_(self._data)
        return other

    def as_in_context(self, ctx) -> "NDArray":
        dev = resolve(ctx)
        if dev == self.ctx:
            return self
        from .. import autograd

        with torch.set_grad_enabled(autograd.is_recording()):
            return NDArray(self._data.to(dev))

    as_in_ctx = as_in_context

    # ---- autograd hooks --------------------------------------------------
    def attach_grad(self, grad_req: str = "write", stype=None):
        """Mark this array as a leaf with a zeroed gradient buffer of its
        shape and dtype."""
        from .. import autograd

        autograd.mark_variables([self], [None], grad_req)

    @property
    def grad(self) -> Optional["NDArray"]:
        leaf = self._ag_leaf
        g = getattr(leaf, "_mx_grad", None) if leaf is not None else None
        return NDArray(g) if g is not None else None

    @property
    def grad_req(self) -> str:
        from .. import autograd

        leaf = self._ag_leaf
        return autograd.grad_req_of(leaf) if leaf is not None else "null"

    def zero_grad(self):
        g = self.grad
        if g is not None:
            g._data.zero_()

    def backward(self, out_grad=None, retain_graph=False, train_mode=True):
        from .. import autograd

        autograd.backward([self], [out_grad] if out_grad is not None
                          else None, retain_graph=retain_graph,
                          train_mode=train_mode)

    def detach(self) -> "NDArray":
        return NDArray(self._data.detach())

    # ---- op plumbing -----------------------------------------------------
    def _op(self, name, *others, **attrs):
        from ..ops.registry import invoke

        return invoke(name, self, *others, **attrs)

    def _binary(self, scalar_op, bcast_op, o):
        if isinstance(o, numeric_types):
            return self._op(scalar_op, scalar=o)
        return self._op(bcast_op, o if isinstance(o, NDArray)
                        else NDArray(o, ctx=self.ctx))

    def _rbinary(self, rscalar_op, bcast_op, o):
        if isinstance(o, numeric_types):
            return self._op(rscalar_op, scalar=o)
        return NDArray(o, ctx=self.ctx)._op(bcast_op, self)

    def __add__(self, o):
        return self._binary("_plus_scalar", "broadcast_add", o)

    def __radd__(self, o):
        return self.__add__(o)

    def __sub__(self, o):
        return self._binary("_minus_scalar", "broadcast_sub", o)

    def __rsub__(self, o):
        return self._rbinary("_rminus_scalar", "broadcast_sub", o)

    def __mul__(self, o):
        return self._binary("_mul_scalar", "broadcast_mul", o)

    def __rmul__(self, o):
        return self.__mul__(o)

    def __truediv__(self, o):
        return self._binary("_div_scalar", "broadcast_div", o)

    def __rtruediv__(self, o):
        return self._rbinary("_rdiv_scalar", "broadcast_div", o)

    def __mod__(self, o):
        return self._binary("_mod_scalar", "broadcast_mod", o)

    def __pow__(self, o):
        return self._binary("_power_scalar", "broadcast_power", o)

    def __rpow__(self, o):
        return self._rbinary("_rpower_scalar", "broadcast_power", o)

    def __neg__(self):
        return self._op("negative")

    def __abs__(self):
        return self._op("abs")

    def __matmul__(self, o):
        return self._op("matmul", o if isinstance(o, NDArray)
                        else NDArray(o, ctx=self.ctx))

    def _inplace(self, r: "NDArray") -> "NDArray":
        """Make ``r`` this array's value.  Under recording, when ``r`` is
        part of a graph, the array is rebound to it (the gradient flows
        through to the leaf it came from), as it is when ``r`` has
        another shape, or another dtype and this array is no view (an
        int32 array divided in place becomes float32, as in the JAX
        package); otherwise ``r`` is written into the array's own
        storage under no_grad, through any view."""
        from .. import autograd

        t = self._data
        if (autograd.is_recording() and r._data.requires_grad) \
                or r._data.shape != t.shape \
                or (r._data.dtype != t.dtype and t._base is None):
            self._data = r._data
        else:
            with torch.no_grad():
                t.copy_(r._data)
        return self

    def __iadd__(self, o):
        return self._inplace(self + o)

    def __isub__(self, o):
        return self._inplace(self - o)

    def __imul__(self, o):
        return self._inplace(self * o)

    def __itruediv__(self, o):
        return self._inplace(self / o)

    # comparisons
    def __eq__(self, o):
        if o is None:
            return False
        return self._binary("_equal_scalar", "broadcast_equal", o)

    def __ne__(self, o):
        if o is None:
            return True
        return self._binary("_not_equal_scalar", "broadcast_not_equal", o)

    def __gt__(self, o):
        return self._binary("_greater_scalar", "broadcast_greater", o)

    def __ge__(self, o):
        return self._binary("_greater_equal_scalar",
                            "broadcast_greater_equal", o)

    def __lt__(self, o):
        return self._binary("_lesser_scalar", "broadcast_lesser", o)

    def __le__(self, o):
        return self._binary("_lesser_equal_scalar", "broadcast_lesser_equal",
                            o)

    __hash__ = object.__hash__

    # ---- shape ops -------------------------------------------------------
    def reshape(self, *shape, **kwargs):
        """A view of the new shape where the layout allows one; MXNet's
        special codes 0, -1, -2, -3, -4 are resolved against the current
        shape."""
        if len(shape) == 1 and isinstance(shape[0], (list, tuple)):
            shape = tuple(shape[0])
        shape = tuple(kwargs.get("shape", shape))
        concrete = self._concrete_shape(shape)
        if concrete is None:
            raise MXNetError(f"cannot reshape {self.shape} to {shape}")
        return self._op("reshape", shape=concrete)

    def _concrete_shape(self, shape):
        """Resolve every reference reshape code — 0 (copy dim), -1
        (infer), -2 (copy rest), -3 (merge two), -4 (split) — against
        the current shape; None when unresolvable."""
        cur = list(self.shape)
        shape = list(shape)
        out = []
        si = k = 0
        try:
            while k < len(shape):
                s = shape[k]
                if not isinstance(s, integer_types):
                    return None
                s = int(s)
                if s == 0:
                    out.append(cur[si])
                    si += 1
                elif s == -2:
                    out.extend(cur[si:])
                    si = len(cur)
                elif s == -3:
                    out.append(cur[si] * cur[si + 1])
                    si += 2
                elif s == -4:
                    a, b = int(shape[k + 1]), int(shape[k + 2])
                    if a == -1:
                        a = cur[si] // b
                    if b == -1:
                        b = cur[si] // a
                    out.extend([a, b])
                    si += 1
                    k += 2
                elif s < -4:
                    return None
                else:
                    out.append(s)
                    if s != -1:
                        si += 1
                k += 1
        except (IndexError, ZeroDivisionError):
            return None
        total = 1
        for d in cur:
            total *= d
        if out.count(-1) == 1:
            known = 1
            for d in out:
                if d != -1:
                    known *= d
            if known == 0 or total % known:
                return None
            out[out.index(-1)] = total // known
        elif -1 in out:
            return None
        prod = 1
        for d in out:
            prod *= d
        return tuple(out) if prod == total else None

    def reshape_like(self, other):
        return self.reshape(other.shape)

    def transpose(self, *axes):
        if len(axes) == 1 and isinstance(axes[0], (list, tuple)):
            axes = tuple(axes[0])
        return self._op("transpose", axes=tuple(axes) if axes else None)

    @property
    def T(self):
        return self.transpose()

    def flatten(self):
        return self._op("flatten")

    def expand_dims(self, axis):
        return self._op("expand_dims", axis=axis)

    def squeeze(self, axis=None):
        return self._op("squeeze", axis=axis)

    def slice_axis(self, axis, begin, end):
        return self._op("slice_axis", axis=axis, begin=begin, end=end)

    def pick(self, index, axis=-1, keepdims=False):
        return self._op("pick", index if isinstance(index, NDArray)
                        else NDArray(index, ctx=self.ctx), axis=axis,
                        keepdims=keepdims)

    # ---- reductions ------------------------------------------------------
    def sum(self, axis=None, keepdims=False):
        return self._op("sum", axis=_norm_axis(axis), keepdims=keepdims)

    def mean(self, axis=None, keepdims=False):
        return self._op("mean", axis=_norm_axis(axis), keepdims=keepdims)

    def max(self, axis=None, keepdims=False):
        return self._op("max", axis=_norm_axis(axis), keepdims=keepdims)

    def min(self, axis=None, keepdims=False):
        return self._op("min", axis=_norm_axis(axis), keepdims=keepdims)

    def norm(self, ord=2, axis=None, keepdims=False):  # noqa: A002
        return self._op("norm", ord=ord, axis=_norm_axis(axis),
                        keepdims=keepdims)

    def argmax(self, axis=None, keepdims=False):
        return self._op("argmax", axis=axis, keepdims=keepdims)

    # ---- indexing --------------------------------------------------------
    def __getitem__(self, key):
        """Basic keys give views that write through; an NDArray key
        gathers."""
        from .. import autograd

        with torch.set_grad_enabled(autograd.is_recording()):
            return NDArray(self._data[_key(key)])

    def __setitem__(self, key, value):
        """Sliced assignment into the array's own storage, under
        no_grad: it writes through views and never records."""
        v = value._data if isinstance(value, NDArray) else value
        t = self._data
        with torch.no_grad():
            if not isinstance(v, torch.Tensor):
                v = torch.as_tensor(np.asarray(v))
            t[_key(key)] = v.to(device=t.device, dtype=t.dtype)

    def __iter__(self):
        for i in range(len(self)):
            yield self[i]


def _norm_axis(axis):
    if axis is None:
        return None
    if isinstance(axis, (list, tuple)):
        return tuple(axis)
    return int(axis)


def wrap_outputs(out):
    """A function's result (a tensor or a tuple/list of them) as
    NDArray(s); several outputs come back as a list."""
    if isinstance(out, (tuple, list)):
        return [NDArray(o) for o in out]
    return NDArray(out)


# ---- creation functions ----------------------------------------------------
# ctx defaults to gpu(0) and raises without CUDA: pass ctx=cpu()

def array(source, ctx=None, dtype=None) -> NDArray:
    """An NDArray on ``ctx`` from an NDArray, tensor or array-like.
    Without ``dtype``, float64 narrows to float32 and int64 to int32, as
    in the JAX package."""
    dev = resolve(ctx)
    if isinstance(source, NDArray):
        out = source.astype(dtype) if dtype is not None else source.copy()
        return out.as_in_context(dev)
    if isinstance(source, torch.Tensor):
        t = source.detach()
    else:
        src = np.asarray(source)
        if src.dtype.name == "bfloat16":  # ml_dtypes arrays: same bits
            t = torch.from_numpy(
                np.ascontiguousarray(src).view(np.int16)).view(
                    torch.bfloat16)
        else:
            t = torch.from_numpy(np.ascontiguousarray(src))
    if dtype is None:
        dtype = _NARROW.get(t.dtype, t.dtype)
    return NDArray(t.to(device=dev, dtype=dtype_of(dtype), copy=True))


def _shape(shape):
    return (shape,) if isinstance(shape, integer_types) else tuple(shape)


def zeros(shape, ctx=None, dtype=None) -> NDArray:
    return NDArray(torch.zeros(_shape(shape), dtype=dtype_of(dtype),
                               device=resolve(ctx)))


def ones(shape, ctx=None, dtype=None) -> NDArray:
    return NDArray(torch.ones(_shape(shape), dtype=dtype_of(dtype),
                              device=resolve(ctx)))


def full(shape, val, ctx=None, dtype=None) -> NDArray:
    return NDArray(torch.full(_shape(shape), val, dtype=dtype_of(dtype),
                              device=resolve(ctx)))


def empty(shape, ctx=None, dtype=None) -> NDArray:
    return zeros(shape, ctx=ctx, dtype=dtype)


def arange(start, stop=None, step=1.0, repeat=1, ctx=None,
           dtype=None) -> NDArray:
    if stop is None:
        start, stop = 0, start
    out = torch.arange(start, stop, step, dtype=dtype_of(dtype),
                       device=resolve(ctx))
    if repeat > 1:
        out = out.repeat_interleave(repeat)
    return NDArray(out)


def concatenate(arrays, axis=0) -> NDArray:
    """The arrays joined along ``axis`` (the registered ``concat``)."""
    from ..ops.registry import invoke

    return invoke("concat", *arrays, dim=axis)


def _cpu_array(a) -> NDArray:
    """A host array as an NDArray on the CPU (the data pipeline's
    arrays, which the caller moves with as_in_context)."""
    return array(a, ctx=cpu())
