"""Engine front-end knobs: ``bulk``, ``set_bulk_size`` and the engine
type (counterpart of ``mxnet_tpu/engine.py``).

PyTorch dispatches work to a CUDA stream asynchronously, as PjRt does in
the JAX package, so the default engine needs nothing from this module.
Under ``MXNET_ENGINE_TYPE=NaiveEngine`` the imperative invoke path
(``ops.registry.invoke``) synchronises the stream of each op's outputs
after the op — inside a :func:`bulk` scope only once, at the scope's
exit, for the devices the scope's ops wrote to.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Set

import torch

from .util import env

__all__ = ["bulk", "set_bulk_size", "current_engine_type", "in_bulk"]

_STATE = threading.local()


def _bulk_depth() -> int:
    return getattr(_STATE, "depth", 0)


def _track(tensors) -> None:
    pend = getattr(_STATE, "pending", None)
    if pend is not None:
        pend.update(t.device for t in tensors
                    if isinstance(t, torch.Tensor) and t.is_cuda)


def _synchronize(devices) -> None:
    for dev in devices:
        torch.cuda.current_stream(dev).synchronize()


def in_bulk() -> bool:
    return _bulk_depth() > 0


def current_engine_type() -> str:
    """``MXNET_ENGINE_TYPE``: 'ThreadedEnginePerDevice' (asynchronous
    dispatch, the default) or 'NaiveEngine' (synchronous)."""
    return env.get_str("MXNET_ENGINE_TYPE")


_bulk_size = 15  # the reference's default bulking size


def set_bulk_size(size: int) -> int:
    """Set the bulk size; returns the previous one."""
    global _bulk_size
    prev = _bulk_size
    _bulk_size = int(size)
    return prev


@contextlib.contextmanager
def bulk(size: int = 15):
    """Bulking scope: defers NaiveEngine's synchronisation to the scope's
    exit; under the default engine it changes nothing."""
    prev_depth = _bulk_depth()
    prev_pending = getattr(_STATE, "pending", None)
    _STATE.depth = prev_depth + 1
    _STATE.pending = set()
    try:
        yield
    finally:
        pending: Set[torch.device] = _STATE.pending
        _STATE.depth = prev_depth
        _STATE.pending = prev_pending
        if pending and current_engine_type() == "NaiveEngine":
            _synchronize(pending)
