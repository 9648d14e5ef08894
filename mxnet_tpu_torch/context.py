"""Device contexts: ``cpu()`` and ``gpu(i)`` are :class:`Context` objects
with a thread-local ``with ctx:`` scope.

Counterpart of ``mxnet_tpu/context.py``: the same ``device_type`` /
``device_id`` / ``device_typeid`` and type-id tables, equality, hashing
and ``repr`` (``gpu(0)``).  A Context maps onto a ``torch.device``
(:attr:`Context.torch_device`, the counterpart of ``jax_device``):
``gpu(i)`` is ``cuda:i``; ``cpu()``, ``cpu_pinned()`` and
``cpu_shared()`` are the host.  The port has one host device, so two
CPU contexts share it; an NDArray keeps the Context it was placed on
beside its tensor, so a replica on ``cpu(1)`` still says ``cpu(1)``, as
on the JAX package's virtual CPU devices.  ``torch.device`` cannot be
subclassed, so code that hands a context to PyTorch goes through
:func:`resolve`, which takes a Context, a ``torch.device`` or a string.
Where a caller asks for replicas (``Parameter.initialize(ctx=[...])``,
``split_and_load``, ``Module(context=[...])``), :func:`context_list`
takes a list of contexts.

Devices are explicit: the default context is the innermost ``with
ctx:`` scope, else ``MXNET_DEFAULT_CONTEXT`` (``cpu`` or ``gpu``), else
``gpu(0)`` when CUDA is present; with no CUDA device that default does
not exist (``current_context`` raises) — the port never falls back to
the CPU silently.  A caller that wants the CPU passes ``cpu()``.
"""
from __future__ import annotations

import threading
from typing import List, Union

import torch

from .base import MXNetError

__all__ = ["Context", "cpu", "gpu", "tpu", "cpu_pinned", "cpu_shared",
           "num_gpus", "current_context", "resolve", "as_context",
           "context_list"]

_HOST_TYPES = ("cpu", "cpu_pinned", "cpu_shared")
_TPU_MSG = ("tpu() has no meaning in mxnet_tpu_torch, which runs on CUDA "
            "devices: use gpu(i), or cpu() for tests")


class Context:
    """A device context; ``device_type`` is one of 'cpu', 'gpu',
    'cpu_pinned', 'cpu_shared' (and 'tpu', which names no device of
    the port)."""

    # the reference's DeviceType ids (kCPU=1, kGPU=2, kCPUPinned=3,
    # kCPUShared=5) and the JAX package's kTPU=6
    devtype2mask = {"cpu": 1, "gpu": 2, "cpu_pinned": 3, "cpu_shared": 5,
                    "tpu": 6}
    devmask2type = {v: k for k, v in devtype2mask.items()}

    _scope = threading.local()

    def __init__(self, device_type, device_id: int = 0):
        if isinstance(device_type, Context):
            device_type, device_id = (device_type.device_type,
                                      device_type.device_id)
        if device_type not in self.devtype2mask:
            raise MXNetError(f"unknown device type {device_type!r}")
        self.device_type = device_type
        self.device_id = int(device_id)

    @property
    def device_typeid(self) -> int:
        return self.devtype2mask[self.device_type]

    def __eq__(self, other):
        return (isinstance(other, Context)
                and self.device_type == other.device_type
                and self.device_id == other.device_id)

    def __hash__(self):
        return hash((self.device_type, self.device_id))

    def __repr__(self):
        return f"{self.device_type}({self.device_id})"

    __str__ = __repr__

    # ---- the with-stack --------------------------------------------------
    @classmethod
    def _stack(cls) -> List["Context"]:
        st = getattr(cls._scope, "stack", None)
        if st is None:
            st = cls._scope.stack = []
        return st

    def __enter__(self):
        self._stack().append(self)
        return self

    def __exit__(self, *exc):
        self._stack().pop()
        return False

    # ---- the torch mapping -----------------------------------------------
    @property
    def torch_device(self) -> torch.device:
        if self.device_type in _HOST_TYPES:
            return torch.device("cpu")
        if self.device_type == "tpu":
            raise MXNetError(_TPU_MSG)
        return torch.device("cuda", self.device_id)

    def empty_cache(self):
        """Release the caching allocator's unused blocks on this card
        (``torch.cuda.empty_cache`` under the device); a no-op on the
        host."""
        if self.device_type == "gpu" and torch.cuda.is_available():
            with torch.cuda.device(self.device_id):
                torch.cuda.empty_cache()


def cpu(device_id: int = 0) -> Context:
    return Context("cpu", device_id)


def gpu(device_id: int = 0) -> Context:
    return Context("gpu", device_id)


def cpu_pinned(device_id: int = 0) -> Context:
    return Context("cpu_pinned", device_id)


def cpu_shared(device_id: int = 0) -> Context:
    return Context("cpu_shared", device_id)


def tpu(device_id: int = 0):
    raise MXNetError(_TPU_MSG)


def num_gpus() -> int:
    """The number of CUDA devices this process sees."""
    return torch.cuda.device_count()


def _default_gpu() -> Context:
    if not torch.cuda.is_available():
        raise MXNetError("no CUDA device is available and none was asked "
                         "for: pass ctx=cpu() to run on the CPU")
    return gpu(0)


def current_context() -> Context:
    """The innermost ``with ctx:`` scope's context; else the one
    ``MXNET_DEFAULT_CONTEXT`` names (``cpu`` or ``gpu``); else gpu(0)
    when CUDA is present, raising otherwise."""
    st = Context._stack()
    if st:
        return st[-1]
    from .util import env

    forced = env.get_str("MXNET_DEFAULT_CONTEXT")
    if forced:
        if forced == "cpu":
            return cpu(0)
        if forced == "gpu":
            return _default_gpu()
        raise MXNetError(f"MXNET_DEFAULT_CONTEXT={forced!r}: the port's "
                         "contexts are 'cpu' and 'gpu'")
    return _default_gpu()


def as_context(dev) -> Context:
    """The Context of a ``torch.device`` (or anything :func:`resolve`
    takes)."""
    if isinstance(dev, Context):
        return dev
    dev = resolve(dev)
    return gpu(dev.index or 0) if dev.type == "cuda" else cpu(0)


def resolve(ctx: Union[None, str, torch.device, Context] = None
            ) -> torch.device:
    """The ``torch.device`` an entry point runs on: ``ctx``'s (a
    Context, a ``torch.device`` or a device string) when given, else
    :func:`current_context`'s."""
    if ctx is None:
        return current_context().torch_device
    if isinstance(ctx, (list, tuple)):
        if len(ctx) != 1:
            raise MXNetError(
                f"{len(ctx)} contexts given where one device is asked "
                "for; replicas over several contexts are made by "
                "Parameter.initialize(ctx=[...]), split_and_load and "
                "Module(context=[...])")
        ctx = ctx[0]
    if isinstance(ctx, Context):
        return ctx.torch_device
    dev = torch.device(ctx)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", 0)
    return dev


def context_list(ctx=None) -> List[Context]:
    """The contexts a caller asks for replicas on, in order: ``ctx`` (a
    Context, ``torch.device``, string, or a list of them) as Contexts,
    else ``[current_context()]``."""
    if ctx is None:
        return [current_context()]
    if not isinstance(ctx, (list, tuple)):
        ctx = [ctx]
    if not ctx:
        raise MXNetError("an empty list of contexts")
    return [as_context(c) for c in ctx]
