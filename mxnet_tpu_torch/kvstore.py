"""KVStore in local mode (counterpart of ``mxnet_tpu/kvstore.py``'s
``'local'`` and ``'device'`` stores): ``init``, ``push``, ``pull``,
``pushpull`` and ``row_sparse_pull`` over a list of values per key
(NDArrays or tensors), the values summed on the first one's device.

Row-sparse values reduce to a row-sparse sum with the merged indices of
all of them; with an optimizer set (``set_optimizer``/``set_updater``)
a push runs the update on the stored value (a lazy SGD update touches
only the gradient's rows), and the optimizer's states go to a file with
``save_optimizer_states``.  ``pull`` refuses a sparse ``out``
(``row_sparse_pull`` fills one).

The distributed stores (``dist_sync``, ``dist_device_sync``,
``dist_async``) and the collective ones (``nccl``, ``xla``) raise: the
port's data parallelism is ``parallel.SPMDTrainer`` over a process group,
and the KVStore over it is ROADMAP queue A item 7, as is gradient
compression.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Union

import torch

from .base import MXNetError
from .ndarray.ndarray import NDArray

__all__ = ["KVStore", "create"]

_LOCAL = ("local", "device")
_QUEUED = ("dist_sync", "dist_device_sync", "dist_async", "dist", "nccl",
           "xla")


def _as_list(x):
    return list(x) if isinstance(x, (list, tuple)) else [x]


def _nd(v) -> NDArray:
    return v if isinstance(v, NDArray) else NDArray(v)


def _key_int(k) -> int:
    try:
        return int(k)
    except (TypeError, ValueError):
        return abs(hash(k)) % (2 ** 31)


class KVStore:
    def __init__(self, kind: str):
        self._kind = kind
        self._store: Dict[Union[int, str], NDArray] = {}
        self._updater: Optional[Callable] = None

    @property
    def type(self) -> str:
        return self._kind

    @property
    def rank(self) -> int:
        return 0

    @property
    def num_workers(self) -> int:
        return 1

    def _normalize(self, key, value):
        keys = _as_list(key)
        if value is None:
            return keys, [None] * len(keys)
        if len(keys) == 1:
            return keys, [value]
        vals = _as_list(value)
        if len(vals) != len(keys):
            raise MXNetError("key/value length mismatch")
        return keys, vals

    def _check(self, k):
        if k not in self._store:
            raise MXNetError(f"kvstore key {k} not initialized")

    def init(self, key, value):
        for k, v in zip(*self._normalize(key, value)):
            v = _nd(_as_list(v)[0])
            self._store[k] = v.copy()

    def _reduce(self, vals) -> NDArray:
        """The sum of one key's values on the first one's device: a
        row-sparse sum with the merged indices when every value is
        row-sparse."""
        from .ndarray.sparse import RowSparseNDArray

        vals = [_nd(v) for v in vals]
        if len(vals) == 1:
            return vals[0].copy()
        dev = vals[0]._data.device
        acc = vals[0]._data.detach().clone()
        for v in vals[1:]:
            acc += v._data.detach().to(dev)
        if all(isinstance(v, RowSparseNDArray) for v in vals):
            merged = torch.unique(torch.cat(
                [v._aux["indices"].to(dev) for v in vals]))
            return RowSparseNDArray(acc, merged)
        return NDArray(acc)

    def _publish(self, k, agg: NDArray):
        """Run the updater on the stored value, or store ``agg``."""
        if self._updater is not None:
            self._check(k)
            self._updater(_key_int(k), agg, self._store[k])
        else:
            self._store[k] = agg

    def push(self, key, value, priority: int = 0):
        """Store the sum of each key's values (or apply it through the
        updater)."""
        for k, v in zip(*self._normalize(key, value)):
            self._publish(k, self._reduce(_as_list(v)))

    @staticmethod
    def _write(dst, src: NDArray):
        from .ndarray.sparse import BaseSparseNDArray

        if isinstance(dst, BaseSparseNDArray):
            raise MXNetError("pull with a sparse out is not supported; use "
                             "row_sparse_pull (ref: KVStoreLocal::PullImpl)")
        with torch.no_grad():
            (dst._data if isinstance(dst, NDArray) else dst).copy_(
                src._data)

    def pull(self, key, out=None, priority: int = 0, ignore_sparse=True):
        for k, o in zip(*self._normalize(key, out)):
            self._check(k)
            for dst in _as_list(o):
                self._write(dst, self._store[k])

    def pushpull(self, key, value, out=None, priority: int = 0):
        """The sum of each key's values written into every output (into
        the values themselves without ``out``); with an updater, the
        updated stored value."""
        keys, values = self._normalize(key, value)
        _, outs = self._normalize(key, out if out is not None else value)
        for k, v, o in zip(keys, values, outs):
            agg = self._reduce(_as_list(v))
            if self._updater is not None:
                self._publish(k, agg)
                agg = self._store[k]
            for dst in _as_list(o):
                self._write(dst, agg)

    def row_sparse_pull(self, key, out=None, priority=0, row_ids=None):
        """Pull only the rows ``row_ids`` asks for: a row-sparse ``out``
        gets them as its stored rows (sorted, without repeats) and
        zeros elsewhere; a dense ``out`` gets the same dense values."""
        from .ndarray.sparse import CSRNDArray, RowSparseNDArray

        if row_ids is None:
            return self.pull(key, out, priority)
        keys, outs = self._normalize(key, out)
        _, rid_groups = self._normalize(key, row_ids)
        for k, o, rid_group in zip(keys, outs, rid_groups):
            self._check(k)
            src = self._store[k]._data
            for dst, rid in zip(_as_list(o), _as_list(rid_group)):
                if isinstance(dst, CSRNDArray):
                    raise MXNetError("row_sparse_pull fills a row_sparse "
                                     "or dense out, not a csr one")
                rid = rid._data if isinstance(rid, NDArray) \
                    else torch.as_tensor(rid)
                uniq = torch.unique(rid.to(src.device, torch.int64))
                full = torch.zeros_like(src)
                full.index_copy_(0, uniq, src.index_select(0, uniq))
                dev = dst._data.device
                if isinstance(dst, RowSparseNDArray):
                    dst._data = full.to(dev)
                    dst._aux = {"indices": uniq.to(dev)}
                else:
                    with torch.no_grad():
                        dst._data.copy_(full)

    # ---- the optimizer -----------------------------------------------------
    def set_optimizer(self, optimizer):
        """Apply ``optimizer`` to every push (the store keeps its
        states)."""
        from . import optimizer as opt_mod

        self._updater = opt_mod.get_updater(optimizer)

    def set_updater(self, updater: Callable):
        self._updater = updater

    def save_optimizer_states(self, fname: str, dump_optimizer=False):
        if self._updater is None:
            raise MXNetError("no optimizer set on kvstore")
        with open(fname, "wb") as f:
            f.write(self._updater.get_states(dump_optimizer))

    def load_optimizer_states(self, fname: str):
        if self._updater is None:
            raise MXNetError("no optimizer set on kvstore")
        # the states go where the stored weights are
        ctx = next(iter(self._store.values())).ctx if self._store else None
        with open(fname, "rb") as f:
            self._updater.set_states(f.read(), ctx=ctx)

    def set_gradient_compression(self, compression_params: dict):
        if self._kind == "local":
            raise MXNetError(
                "gradient compression is not supported on 'local' "
                "kvstore (ref: KVStoreLocal::SetGradientCompression)")
        raise MXNetError("gradient compression is not ported (ROADMAP "
                         "queue A item 7)")

    def barrier(self):
        pass

    def __repr__(self):
        return f"KVStore(type={self._kind}, keys={len(self._store)})"


def create(name: str = "local") -> KVStore:
    """A local store ('local' or 'device'); the others raise."""
    if name in _QUEUED:
        raise MXNetError(f"kvstore {name!r} is not ported: the port's "
                         "local stores are 'local' and 'device'; the "
                         "distributed KVStore is ROADMAP queue A item 7 "
                         "(data parallel training: parallel.SPMDTrainer)")
    if name not in _LOCAL:
        raise MXNetError(f"unknown kvstore type {name!r}; valid: "
                         f"{sorted(_LOCAL + _QUEUED)}")
    return KVStore(name)
