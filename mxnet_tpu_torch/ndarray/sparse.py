"""Sparse NDArrays: RowSparseNDArray and CSRNDArray (counterpart of
``mxnet_tpu/ndarray/sparse.py``).

Storage:

  * ``RowSparseNDArray`` keeps the JAX package's layout: a dense backing
    of the full shape plus the authoritative sorted ``indices`` of the
    stored rows, so an explicitly stored row may hold zeros and every
    dense op reads the backing as it is.
  * ``CSRNDArray`` keeps the compact triple (``data``, ``indices``,
    ``indptr``) on its device and builds the dense view only when asked
    (``todense``, ``asnumpy``, an op with no CSR form).  The JAX package
    keeps a dense backing here too, because XLA has no sparse storage;
    a CSR batch of a million-feature data set would be tens of GB dense
    against a few MB compact.  ``dot(csr, dense)`` and
    ``dot(csr, dense, transpose_a=True)`` run on the compact form as a
    gather and an ``index_add_`` (accumulated in float64 for fp32 data,
    so the card's result does not depend on the order of its atomics).

Where the JAX package's dense backing shows through, the port returns
what the JAX package returns: an elementwise op on two row-sparse
arrays computes over the whole backing (a ``divide`` gives 0/0 in the
rows neither side stores) and keeps the merged indices; a position given
twice to ``csr_matrix`` keeps both entries in ``indices``, each reading
the value given last, which counts once in the dense view and in
``dot``.  Index arrays are int64.
"""
from __future__ import annotations

import numpy as np
import torch

from ..base import MXNetError, dtype_of, np_dtype
from ..context import Context, as_context, resolve
from .ndarray import NDArray, array as _dense_array, to_numpy

__all__ = ["BaseSparseNDArray", "RowSparseNDArray", "CSRNDArray",
           "csr_matrix", "row_sparse_array", "zeros", "empty", "array",
           "cast_storage", "retain", "dot", "add", "subtract", "multiply",
           "divide", "add_n"]

def _default_dtype(values: np.ndarray, dtype):
    if dtype is not None:
        return dtype_of(dtype)
    return torch.float32 if values.dtype == np.float64 \
        else dtype_of(values.dtype)


def _host(x) -> np.ndarray:
    if isinstance(x, NDArray):
        return x.asnumpy()
    if isinstance(x, torch.Tensor):
        return to_numpy(x)
    return np.asarray(x)


def _as_tensor(a: np.ndarray, dtype, dev) -> torch.Tensor:
    a = np.ascontiguousarray(a)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    return t.to(device=dev, dtype=dtype)


class BaseSparseNDArray(NDArray):
    """The storage-typed arrays' common methods."""

    __slots__ = ("_aux",)

    def tostype(self, stype: str):
        if stype == self.stype:
            return self
        if stype == "default":
            return self.todense()
        return cast_storage(self, stype)

    def todense(self) -> NDArray:
        return NDArray(self._data)

    def asnumpy(self):
        return to_numpy(self._data)

    def _deny(self, what):
        raise MXNetError(f"{what} is not supported for {self.stype} "
                         "storage; call .tostype('default') first")

    def __iadd__(self, o):
        self._deny("inplace arithmetic")

    def __setitem__(self, key, value):
        if key is Ellipsis or (isinstance(key, slice)
                               and key == slice(None)):
            if isinstance(value, BaseSparseNDArray):
                value.copyto(self)
            elif isinstance(value, NDArray):
                cast_storage(value, self.stype).copyto(self)
            else:
                cast_storage(_dense_array(value, ctx=self.ctx),
                             self.stype).copyto(self)
            return
        self._deny("sliced assignment")

    def __repr__(self):
        dims = "x".join(map(str, self.shape))
        return f"\n<{type(self).__name__} {dims} @{self.ctx}>"

    def copyto(self, other):
        if not isinstance(other, NDArray):
            return self.as_in_context(other)
        if isinstance(other, BaseSparseNDArray):
            src = self if other.stype == self.stype \
                else cast_storage(self, other.stype)
            src = src.as_in_context(other.ctx)
            other._assign(src)
            return other
        # sparse -> dense copies the dense view
        with torch.no_grad():
            other._data.copy_(self._data)
        return other


class RowSparseNDArray(BaseSparseNDArray):
    """Values for a subset of rows: a dense backing of the full shape
    and ``indices``, the sorted int64 ids of the stored rows.  ``.data``
    is the (num_stored, *row_shape) block of the stored rows."""

    __slots__ = ()

    def __init__(self, dense: torch.Tensor, indices: torch.Tensor):
        NDArray.__init__(self, dense)
        self._aux = {"indices": indices.to(device=dense.device,
                                           dtype=torch.int64)}

    @property
    def stype(self):
        return "row_sparse"

    @property
    def indices(self) -> NDArray:
        return NDArray(self._aux["indices"])

    @property
    def data(self) -> NDArray:
        return NDArray(self._data.index_select(0, self._aux["indices"]))

    def _assign(self, src: "RowSparseNDArray"):
        self._data = src._data.clone()
        self._aux = {"indices": src._aux["indices"].clone()}

    def copy(self):
        return RowSparseNDArray(self._data.detach().clone(),
                                self._aux["indices"].clone())

    def astype(self, dtype, copy=True):
        dt = dtype_of(dtype)
        if not copy and self._data.dtype == dt:
            return self
        return RowSparseNDArray(self._data.to(dt), self._aux["indices"])

    def as_in_context(self, ctx):
        dev = resolve(ctx)
        if dev == self._data.device:
            return self
        return RowSparseNDArray(self._data.to(dev),
                                self._aux["indices"].to(dev))

    def retain(self, rsp_indices):
        return retain(self, rsp_indices)


class CSRNDArray(BaseSparseNDArray):
    """A compressed sparse row matrix kept compact: ``data`` (the nnz
    values), ``indices`` (their column ids) and ``indptr`` (row
    pointers, rows + 1), all on the array's device."""

    __slots__ = ("_values", "_live", "_shape")

    def __init__(self, values: torch.Tensor, indices: torch.Tensor,
                 indptr: torch.Tensor, shape, live=None):
        dev = values.device
        self._values = values
        self._aux = {"indices": indices.to(device=dev, dtype=torch.int64),
                     "indptr": indptr.to(device=dev, dtype=torch.int64)}
        # entries that count in the dense view and in dot: None when
        # every position is given once, else False on each entry a later
        # one of the same position overrides
        self._live = None if live is None else live.to(dev)
        self._shape = tuple(int(s) for s in shape)
        self._ag_leaf = None
        self._ctx = None

    # ---- what NDArray reads from the dense payload -------------------------
    @property
    def _data(self) -> torch.Tensor:
        """The dense view, built on request (an op with no CSR form)."""
        # an entry a later one overrides holds that one's value, so the
        # writes agree whatever their order
        vals = self._values
        dense = vals.new_zeros(self._shape)
        if vals.numel():
            dense.index_put_((self._row_ids(), self._aux["indices"]), vals)
        return dense

    @_data.setter
    def _data(self, value):
        raise MXNetError("a CSRNDArray has no dense payload to rebind: "
                         "assign through csr[:] = value")

    @property
    def shape(self):
        return self._shape

    @property
    def dtype(self):
        return np_dtype(self._values.dtype)

    @property
    def ndim(self) -> int:
        return len(self._shape)

    @property
    def size(self) -> int:
        return int(np.prod(self._shape))

    @property
    def ctx(self) -> Context:
        return as_context(self._values.device)

    context = ctx

    @property
    def stype(self):
        return "csr"

    @property
    def indices(self) -> NDArray:
        return NDArray(self._aux["indices"])

    @property
    def indptr(self) -> NDArray:
        return NDArray(self._aux["indptr"])

    @property
    def data(self) -> NDArray:
        return NDArray(self._values)

    def nbytes_compact(self) -> int:
        """Bytes the compact form holds on its device."""
        ts = [self._values, self._aux["indices"], self._aux["indptr"]]
        if self._live is not None:
            ts.append(self._live)
        return sum(t.numel() * t.element_size() for t in ts)

    def _mvals(self) -> torch.Tensor:
        v = self._values
        if self._live is None:
            return v
        return torch.where(self._live, v, torch.zeros((), dtype=v.dtype,
                                                      device=v.device))

    def _row_ids(self) -> torch.Tensor:
        indptr = self._aux["indptr"]
        m = indptr.numel() - 1
        return torch.repeat_interleave(
            torch.arange(m, device=indptr.device), indptr.diff(),
            output_size=self._aux["indices"].numel())

    def asnumpy(self):
        values = to_numpy(self._values)
        cols = self._aux["indices"].cpu().numpy()
        indptr = self._aux["indptr"].cpu().numpy()
        rows = np.repeat(np.arange(len(indptr) - 1), np.diff(indptr))
        dense = np.zeros(self._shape, dtype=values.dtype)
        dense[rows, cols] = values
        return dense

    def asscipy(self):
        import scipy.sparse as sps

        return sps.csr_matrix((to_numpy(self._values),
                               self._aux["indices"].cpu().numpy(),
                               self._aux["indptr"].cpu().numpy()),
                              shape=self._shape)

    def _assign(self, src: "CSRNDArray"):
        self._values = src._values.clone()
        self._aux = {k: v.clone() for k, v in src._aux.items()}
        self._live = None if src._live is None else src._live.clone()
        self._shape = src._shape

    def copy(self):
        return CSRNDArray(self._values.clone(), self._aux["indices"].clone(),
                          self._aux["indptr"].clone(), self._shape,
                          None if self._live is None else self._live.clone())

    def astype(self, dtype, copy=True):
        dt = dtype_of(dtype)
        if not copy and self._values.dtype == dt:
            return self
        return CSRNDArray(self._values.to(dt), self._aux["indices"],
                          self._aux["indptr"], self._shape, self._live)

    def as_in_context(self, ctx):
        dev = resolve(ctx)
        if dev == self._values.device:
            return self
        return CSRNDArray(self._values.to(dev),
                          self._aux["indices"].to(dev),
                          self._aux["indptr"].to(dev), self._shape,
                          None if self._live is None else
                          self._live.to(dev))

    def __getitem__(self, key):
        """Rows ``key`` (an int or a slice) as a CSR matrix of the
        nonzeros of those rows, as the JAX package's dense slice
        recompressed gives them."""
        if isinstance(key, int):
            key = slice(key, key + 1)
        if not isinstance(key, slice):
            raise MXNetError("CSRNDArray only supports int/slice row "
                             "indexing")
        dev = self._values.device
        m = self._shape[0]
        rows = torch.arange(m, device=dev)[key]
        pos = torch.full((m,), -1, dtype=torch.int64, device=dev)
        pos[rows] = torch.arange(rows.numel(), device=dev)
        r = pos[self._row_ids()]
        keep = r >= 0
        dense = self._values.new_zeros((rows.numel(), self._shape[1]))
        dense.index_put_((r[keep], self._aux["indices"][keep]),
                         self._values[keep])
        return _csr_from_dense(dense)


# ---------------------------------------------------------------------------
# construction
# ---------------------------------------------------------------------------

def row_sparse_array(arg1, shape=None, ctx=None, dtype=None):
    """A RowSparseNDArray from ``(data, indices)`` or a dense array;
    ``ctx`` defaults to the current context."""
    dev = resolve(ctx)
    if isinstance(arg1, tuple) and len(arg1) == 2 \
            and not np.isscalar(arg1[0]):
        values, indices = _host(arg1[0]), _host(arg1[1])
        dt = _default_dtype(values, dtype)
        indices = np.asarray(indices, np.int64).reshape(-1)
        order = np.argsort(indices)
        indices, values = indices[order], values[order]
        if shape is None:
            nrows = int(indices[-1]) + 1 if indices.size else 0
            shape = (nrows,) + tuple(values.shape[1:])
        dense = np.zeros(shape, dtype=values.dtype)
        if indices.size:
            dense[indices] = values
        return RowSparseNDArray(_as_tensor(dense, dt, dev),
                                torch.from_numpy(indices).to(dev))
    nd = arg1 if isinstance(arg1, NDArray) else _dense_array(
        arg1, ctx=dev, dtype=dtype)
    return cast_storage(nd, "row_sparse")


def _last_writer(rows: np.ndarray, cols: np.ndarray, values: np.ndarray,
                 ncols: int):
    """For positions given more than once: each entry's value becomes
    the value given last at its position, and ``live`` marks that last
    entry (None when no position repeats)."""
    key = rows.astype(np.int64) * max(ncols, 1) + cols
    if np.unique(key).size == key.size:
        return values, None
    n = key.size
    _, first_rev, inv = np.unique(key[::-1], return_index=True,
                                  return_inverse=True)
    last = n - 1 - first_rev            # last entry of each position
    values = values[last[inv[::-1]]]
    live = np.zeros(n, bool)
    live[last] = True
    return values, live


def csr_matrix(arg1, shape=None, ctx=None, dtype=None):
    """A CSRNDArray from ``(data, indices, indptr)``, ``(data, (row,
    col))``, a scipy.sparse matrix or a dense array; ``ctx`` defaults
    to the current context."""
    try:
        import scipy.sparse as sps
    except ImportError:  # pragma: no cover — scipy ships with the stack
        sps = None
    if sps is not None and sps.issparse(arg1):
        csr = arg1.tocsr()
        return csr_matrix((csr.data, csr.indices, csr.indptr),
                          shape=csr.shape, ctx=ctx, dtype=dtype)
    dev = resolve(ctx)
    if isinstance(arg1, tuple) and len(arg1) == 3:
        values = _host(arg1[0]).reshape(-1)
        indices = np.asarray(_host(arg1[1]), np.int64).reshape(-1)
        indptr = np.asarray(_host(arg1[2]), np.int64).reshape(-1)
        dt = _default_dtype(values, dtype)
        if shape is None:
            ncols = int(indices.max()) + 1 if indices.size else 0
            shape = (len(indptr) - 1, ncols)
        rows = np.repeat(np.arange(len(indptr) - 1), np.diff(indptr))
        values, live = _last_writer(rows, indices, values, shape[1])
        return CSRNDArray(
            _as_tensor(values, dt, dev), torch.from_numpy(indices).to(dev),
            torch.from_numpy(indptr).to(dev), shape,
            None if live is None else torch.from_numpy(live))
    if isinstance(arg1, tuple) and len(arg1) == 2 \
            and isinstance(arg1[1], tuple):
        values, (row, col) = arg1
        m = sps.coo_matrix((np.asarray(values),
                            (np.asarray(row), np.asarray(col))),
                           shape=shape).tocsr()
        return csr_matrix(m, shape=shape, ctx=ctx, dtype=dtype)
    nd = arg1 if isinstance(arg1, NDArray) else _dense_array(
        arg1, ctx=dev, dtype=dtype)
    return cast_storage(nd, "csr")


def zeros(stype, shape, ctx=None, dtype=None):
    """An all-zero array of storage ``stype`` (nothing stored)."""
    dev = resolve(ctx)
    if isinstance(shape, int):
        shape = (shape,)
    dt = dtype_of(dtype)
    if stype == "row_sparse":
        return RowSparseNDArray(torch.zeros(shape, dtype=dt, device=dev),
                                torch.zeros((0,), dtype=torch.int64,
                                            device=dev))
    if stype == "csr":
        return CSRNDArray(torch.zeros((0,), dtype=dt, device=dev),
                          torch.zeros((0,), dtype=torch.int64, device=dev),
                          torch.zeros((shape[0] + 1,), dtype=torch.int64,
                                      device=dev), shape)
    if stype == "default":
        return NDArray(torch.zeros(shape, dtype=dt, device=dev))
    raise MXNetError(f"unknown storage type {stype!r}")


def empty(stype, shape, ctx=None, dtype=None):
    return zeros(stype, shape, ctx=ctx, dtype=dtype)


def array(source, ctx=None, dtype=None):
    """A sparse array from another one (a scipy.sparse matrix
    included)."""
    try:
        import scipy.sparse as sps

        if sps.issparse(source):
            return csr_matrix(source, ctx=ctx, dtype=dtype)
    except ImportError:  # pragma: no cover
        pass
    if isinstance(source, BaseSparseNDArray):
        out = source.copy()
        if dtype is not None:
            out = out.astype(dtype)
        return out.as_in_context(ctx) if ctx is not None else out
    raise MXNetError("sparse.array expects a sparse input; use nd.array "
                     "for dense sources")


# ---------------------------------------------------------------------------
# storage casts and structural ops
# ---------------------------------------------------------------------------

def _csr_from_dense(dense: torch.Tensor) -> CSRNDArray:
    if dense.dim() != 2:
        raise MXNetError("csr storage requires a 2-D array")
    nz = (dense != 0).nonzero()
    rows, cols = nz[:, 0], nz[:, 1]
    counts = torch.bincount(rows, minlength=dense.shape[0])
    indptr = torch.zeros(dense.shape[0] + 1, dtype=torch.int64,
                         device=dense.device)
    indptr[1:] = counts.cumsum(0)
    return CSRNDArray(dense[rows, cols], cols, indptr, dense.shape)


def cast_storage(arr: NDArray, stype: str):
    """``arr`` in storage ``stype``: 'default', 'row_sparse' (the rows
    with a nonzero) or 'csr' (the nonzeros of a 2-D array)."""
    if stype == arr.stype:
        return arr
    if stype == "default":
        return NDArray(arr._data)
    dense = arr._data
    if stype == "row_sparse":
        if dense.dim() < 1:
            raise MXNetError("row_sparse needs ndim >= 1")
        nz_rows = (dense.reshape(dense.shape[0], -1) != 0).any(1) \
            .nonzero().reshape(-1)
        return RowSparseNDArray(dense, nz_rows)
    if stype == "csr":
        return _csr_from_dense(dense)
    raise MXNetError(f"unknown storage type {stype!r}")


def retain(rsp: RowSparseNDArray, indices):
    """Only the rows of ``indices`` that ``rsp`` stores."""
    if not isinstance(rsp, RowSparseNDArray):
        raise MXNetError("retain expects a RowSparseNDArray")
    dev = rsp._data.device
    keep = torch.as_tensor(_host(indices).astype(np.int64).reshape(-1),
                           device=dev)
    n = rsp.shape[0]
    mask = torch.zeros(n, dtype=torch.bool, device=dev)
    mask[keep] = True
    dense = torch.where(mask.reshape((-1,) + (1,) * (rsp.ndim - 1)),
                        rsp._data, torch.zeros((), dtype=rsp._data.dtype,
                                               device=dev))
    stored = torch.zeros(n, dtype=torch.bool, device=dev)
    stored[rsp._aux["indices"]] = True
    new_idx = torch.sort(keep[stored[keep]]).values if keep.numel() \
        else keep
    return RowSparseNDArray(dense, new_idx)


# ---------------------------------------------------------------------------
# math
# ---------------------------------------------------------------------------

# the accumulation dtype of a CSR product: an fp32 product of two fp32
# values is exact in float64, and the float64 sum rounds once, so the
# result does not depend on the order in which the card's atomics add
# the terms (the card and the CPU agree)
_ACC = {torch.float32: torch.float64, torch.float16: torch.float32,
        torch.bfloat16: torch.float32}


def dot(lhs, rhs, transpose_a=False, transpose_b=False):
    """``lhs @ rhs`` (``lhs``ᵀ with transpose_a, ``rhs``ᵀ with
    transpose_b).  A CSR ``lhs`` runs on its compact form: the products
    of its nonzeros summed into the output rows with ``index_add_``, in
    float64 for fp32 data (``_ACC``)."""
    if not isinstance(lhs, NDArray):
        raise MXNetError("sparse.dot lhs must be NDArray/CSRNDArray")
    b = rhs._data if isinstance(rhs, NDArray) \
        else torch.as_tensor(np.asarray(rhs))
    if transpose_b:
        b = b.transpose(-1, -2)
    if not isinstance(lhs, CSRNDArray):
        a = lhs._data
        if transpose_a:
            a = a.transpose(-1, -2)
        return NDArray(torch.matmul(a, b))
    vec = b.dim() == 1
    b2 = b.reshape(b.shape[0], -1)
    vals, cols, rows = lhs._mvals(), lhs._aux["indices"], lhs._row_ids()
    dt = torch.promote_types(vals.dtype, b2.dtype)
    acc = _ACC.get(dt, dt)
    if transpose_a:
        src, dst, n = rows, cols, lhs.shape[1]
    else:
        src, dst, n = cols, rows, lhs.shape[0]
    contrib = vals.to(acc)[:, None] * b2.index_select(0, src).to(acc)
    out = torch.zeros((n, b2.shape[1]), dtype=acc, device=b2.device)
    out.index_add_(0, dst, contrib)
    out = out.to(dt)
    return NDArray(out.reshape(-1) if vec else out)


def _ew(fn, lhs, rhs):
    ref = lhs if isinstance(lhs, NDArray) else rhs
    ld = lhs._data if isinstance(lhs, NDArray) else NDArray(
        lhs, ctx=ref.ctx)._data
    rd = rhs._data if isinstance(rhs, NDArray) else NDArray(
        rhs, ctx=ref.ctx)._data
    out = fn(ld, rd)
    lstype = getattr(lhs, "stype", "default")
    rstype = getattr(rhs, "stype", "default")
    # a same-stype elementwise op keeps the stype
    if lstype == rstype == "row_sparse" and tuple(out.shape) == lhs.shape:
        merged = torch.unique(torch.cat([lhs._aux["indices"],
                                         rhs._aux["indices"]]))
        return RowSparseNDArray(out, merged)
    if lstype == rstype == "csr" and tuple(out.shape) == lhs.shape:
        return _csr_from_dense(out)
    return NDArray(out)


def add(lhs, rhs):
    return _ew(torch.add, lhs, rhs)


def subtract(lhs, rhs):
    return _ew(torch.sub, lhs, rhs)


def multiply(lhs, rhs):
    return _ew(torch.mul, lhs, rhs)


def divide(lhs, rhs):
    return _ew(torch.true_divide, lhs, rhs)


def add_n(*args):
    out = args[0]
    for a in args[1:]:
        out = add(out, a)
    return out
