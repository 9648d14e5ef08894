"""Device contexts of the port: ``cpu()`` and ``gpu(i)`` are
``torch.device`` objects.

Counterpart of ``mxnet_tpu/context.py``.  Devices are explicit: the
default context is ``gpu(0)`` when CUDA is present, and with no CUDA
device the default does not exist (``current_context`` raises) — the
port never falls back to the CPU silently.  A caller that wants the CPU
passes ``cpu()``.
"""
from __future__ import annotations

from typing import Union

import torch

from .base import MXNetError

__all__ = ["cpu", "gpu", "tpu", "current_context", "resolve"]

DeviceLike = Union[None, str, torch.device]


def cpu(device_id: int = 0) -> torch.device:
    return torch.device("cpu")


def gpu(device_id: int = 0) -> torch.device:
    return torch.device("cuda", int(device_id))


def tpu(device_id: int = 0):
    raise MXNetError("tpu() has no meaning in mxnet_tpu_torch, which runs "
                     "on CUDA devices: use gpu(i), or cpu() for tests")


def current_context() -> torch.device:
    """gpu(0) when CUDA is present; raises otherwise."""
    if not torch.cuda.is_available():
        raise MXNetError("no CUDA device is available and none was asked "
                         "for: pass ctx=cpu() to run on the CPU")
    return gpu(0)


def resolve(ctx: DeviceLike = None) -> torch.device:
    """The device an entry point runs on: ``ctx`` when given, else
    :func:`current_context`."""
    if ctx is None:
        return current_context()
    dev = torch.device(ctx)
    if dev.type == "cuda" and dev.index is None:
        dev = gpu(0)
    return dev
