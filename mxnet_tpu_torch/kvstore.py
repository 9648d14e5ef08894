"""KVStore in local mode (counterpart of ``mxnet_tpu/kvstore.py``'s
``'local'`` and ``'device'`` stores): ``init``, ``push``, ``pull`` and
``pushpull`` over a list of values per key (NDArrays or tensors), the
values summed on the first one's device.

The distributed stores (``dist_sync``, ``dist_device_sync``,
``dist_async``) and the collective ones (``nccl``, ``xla``) raise: the
port's data parallelism is ``parallel.SPMDTrainer`` over a process group,
and the KVStore over it is ROADMAP queue A item 7, as is gradient
compression.
"""
from __future__ import annotations

from typing import Dict, Union

import torch

from .base import MXNetError

__all__ = ["KVStore", "create"]

_LOCAL = ("local", "device")
_QUEUED = ("dist_sync", "dist_device_sync", "dist_async", "dist", "nccl",
           "xla")


def _as_list(x):
    return list(x) if isinstance(x, (list, tuple)) else [x]


def _tensor(v) -> torch.Tensor:
    from .ndarray.ndarray import NDArray

    return v._data if isinstance(v, NDArray) else v


class KVStore:
    def __init__(self, kind: str):
        self._kind = kind
        self._store: Dict[Union[int, str], torch.Tensor] = {}

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

    def init(self, key, value):
        for k, v in zip(*self._normalize(key, value)):
            self._store[k] = _tensor(_as_list(v)[0]).detach().clone()

    def _reduce(self, vals) -> torch.Tensor:
        ts = [_tensor(v).detach() for v in _as_list(vals)]
        acc = ts[0].clone()
        for t in ts[1:]:
            acc += t.to(acc.device)
        return acc

    def _check(self, k):
        if k not in self._store:
            raise MXNetError(f"kvstore key {k} not initialized")

    def push(self, key, value, priority: int = 0):
        """Store the sum of each key's values."""
        for k, v in zip(*self._normalize(key, value)):
            self._store[k] = self._reduce(v)

    def pull(self, key, out=None, priority: int = 0, ignore_sparse=True):
        for k, o in zip(*self._normalize(key, out)):
            self._check(k)
            for dst in _as_list(o):
                with torch.no_grad():
                    _tensor(dst).copy_(self._store[k])

    def pushpull(self, key, value, out=None, priority: int = 0):
        """The sum of each key's values written into every output (into
        the values themselves without ``out``)."""
        keys, values = self._normalize(key, value)
        _, outs = self._normalize(key, out if out is not None else value)
        for k, v, o in zip(keys, values, outs):
            agg = self._reduce(v)
            for dst in _as_list(o):
                with torch.no_grad():
                    _tensor(dst).copy_(agg)

    def set_gradient_compression(self, compression_params: dict):
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
