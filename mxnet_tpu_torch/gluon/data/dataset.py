"""Datasets (counterpart of ``mxnet_tpu/gluon/data/dataset.py``):
Dataset with transform/transform_first/take/shard/filter, ArrayDataset,
SimpleDataset.  RecordFileDataset waits with RecordIO (ROADMAP queue A
item 8)."""
from __future__ import annotations

from typing import Sequence

from ...base import MXNetError

__all__ = ["Dataset", "ArrayDataset", "SimpleDataset"]


class Dataset:
    def __getitem__(self, idx):
        raise NotImplementedError

    def __len__(self):
        raise NotImplementedError

    def filter(self, fn):
        return SimpleDataset([self[i] for i in range(len(self))
                              if fn(self[i])])

    def take(self, count):
        return _TakenDataset(self, count)

    def shard(self, num_shards, index):
        return _ShardedDataset(self, num_shards, index)

    def transform(self, fn, lazy=True):
        t = _LazyTransformDataset(self, fn)
        if lazy:
            return t
        return SimpleDataset([t[i] for i in range(len(t))])

    def transform_first(self, fn, lazy=True):
        return self.transform(_TransformFirst(fn), lazy)


class _TransformFirst:
    def __init__(self, fn):
        self._fn = fn

    def __call__(self, x, *args):
        if args:
            return (self._fn(x),) + args
        return self._fn(x)


class _LazyTransformDataset(Dataset):
    def __init__(self, data, fn):
        self._data = data
        self._fn = fn

    def __len__(self):
        return len(self._data)

    def __getitem__(self, idx):
        item = self._data[idx]
        if isinstance(item, tuple):
            return self._fn(*item)
        return self._fn(item)


class _TakenDataset(Dataset):
    def __init__(self, data, count):
        self._data = data
        self._count = min(count, len(data))

    def __len__(self):
        return self._count

    def __getitem__(self, idx):
        if idx >= self._count:
            raise IndexError
        return self._data[idx]


class _ShardedDataset(Dataset):
    def __init__(self, data, num_shards, index):
        self._data = data
        self._num = num_shards
        self._index = index

    def __len__(self):
        n = len(self._data)
        return n // self._num + (1 if self._index < n % self._num else 0)

    def __getitem__(self, idx):
        return self._data[idx * self._num + self._index]


class ArrayDataset(Dataset):
    """Zip of equal-length arrays (ref: dataset.py::ArrayDataset)."""

    def __init__(self, *args):
        if not args:
            raise MXNetError("needs at least one array")
        self._length = len(args[0])
        for a in args:
            if len(a) != self._length:
                raise MXNetError("all arrays must have the same length")
        self._data = args

    def __len__(self):
        return self._length

    def __getitem__(self, idx):
        if len(self._data) == 1:
            return self._data[0][idx]
        return tuple(d[idx] for d in self._data)


class SimpleDataset(Dataset):
    def __init__(self, data: Sequence):
        self._data = data

    def __len__(self):
        return len(self._data)

    def __getitem__(self, idx):
        return self._data[idx]
