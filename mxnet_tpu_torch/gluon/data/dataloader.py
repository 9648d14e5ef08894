"""DataLoader (counterpart of ``mxnet_tpu/gluon/data/dataloader.py``),
single-process: ``num_workers=0`` builds each batch in the calling
thread.  Batches are NDArrays on the CPU, as MXNet's loader returns
them; the training loop moves them with ``as_in_context``.  The worker
pools (threads, spawned processes) and the shared-memory transport are
ROADMAP queue A item 8 and raise.
"""
from __future__ import annotations

import numpy as np
import torch

from ...base import MXNetError
from ...ndarray.ndarray import NDArray, _cpu_array
from .sampler import BatchSampler, RandomSampler, SequentialSampler

__all__ = ["DataLoader", "default_batchify_fn"]


def _stack_narrow(data):
    """Stack host samples, narrowing float64 to float32 and int64 to
    int32 (the JAX package's one policy)."""
    arr = np.asarray(data)
    if arr.dtype == np.float64:
        arr = arr.astype(np.float32)
    if arr.dtype == np.int64:
        arr = arr.astype(np.int32)
    return arr


def default_batchify_fn(data):
    """Stack samples into a batch: NDArrays along a new axis 0, tuples
    field by field, anything else through numpy."""
    if isinstance(data[0], NDArray):
        return NDArray(torch.stack([d._data for d in data]))
    if isinstance(data[0], tuple):
        return tuple(default_batchify_fn(list(d)) for d in zip(*data))
    return _cpu_array(_stack_narrow(data))


class DataLoader:
    def __init__(self, dataset, batch_size=None, shuffle=False, sampler=None,
                 last_batch=None, batch_sampler=None, batchify_fn=None,
                 num_workers=0, pin_memory=False, prefetch=None,
                 thread_pool=False, timeout=120, worker_pool=None,
                 worker_transport="shm"):
        if num_workers or thread_pool or worker_pool is not None:
            raise MXNetError("DataLoader worker pools (num_workers > 0, "
                             "thread_pool, worker_pool) and their shared-"
                             "memory transport are ROADMAP queue A item 8; "
                             "the port loads with num_workers=0")
        self._dataset = dataset
        if batch_sampler is None:
            if batch_size is None:
                raise MXNetError("batch_size is required when batch_sampler "
                                 "is not given")
            if sampler is None:
                sampler = RandomSampler(len(dataset)) if shuffle \
                    else SequentialSampler(len(dataset))
            elif shuffle:
                raise MXNetError("shuffle must be False with explicit sampler")
            batch_sampler = BatchSampler(sampler, batch_size,
                                         last_batch or "keep")
        elif (batch_size is not None or shuffle or sampler is not None
              or last_batch is not None):
            raise MXNetError("batch_size/shuffle/sampler/last_batch must not "
                             "be set with explicit batch_sampler")
        self._batch_sampler = batch_sampler
        self._batchify_fn = batchify_fn or default_batchify_fn

    def __iter__(self):
        for indices in self._batch_sampler:
            yield self._batchify_fn([self._dataset[i] for i in indices])

    def __len__(self):
        return len(self._batch_sampler)
