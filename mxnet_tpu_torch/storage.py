"""Device-memory introspection and allocator knobs (counterpart of
``mxnet_tpu/storage.py``; ref: src/storage/** pooled_storage_manager, the
``MXNET_GPU_MEM_POOL_*`` variables and ``mx.context.gpu_memory_info``).

Allocation belongs to PyTorch's caching allocator; this module exposes
what a user needs when a model runs out of memory:

* :func:`memory_info` -> ``(free_bytes, total_bytes)`` of a card
  (``torch.cuda.mem_get_info``, the reference's ``cudaMemGetInfo``).
* :func:`live_array_bytes` -> ``(count, bytes)`` live on a device: on a
  card the caching allocator's current allocation count and allocated
  bytes; on the host a walk of the live tensors the garbage collector
  tracks (``gc.get_objects()``), each storage counted once, so views
  add nothing.  The host walk visits every tracked object: it is slow,
  a diagnostic, not for a loop.
* :func:`memory_summary` / :func:`memory_summaries` -> the allocator's
  statistics (``torch.cuda.memory_stats``) with the live accounting.
* :func:`configure` -> the reference's pool knobs, with the same
  before-initialisation contract: ``pool_reserve_pct`` becomes
  ``torch.cuda.set_per_process_memory_fraction((100 - pct) / 100)`` on
  every card, and ``preallocate`` one allocation of that share of the
  current card, released into the caching allocator (which keeps it
  reserved), both at the process's first CUDA use.
  ``MXNET_GPU_MEM_POOL_RESERVE`` sets the reserve at import.
"""
from __future__ import annotations

import gc
from typing import Dict, Optional, Tuple

import torch

from .base import MXNetError
from .util import env

__all__ = ["memory_info", "memory_summary", "memory_summaries",
           "configure", "live_array_bytes"]

# what configure() and the knob ask of the first CUDA use
_POOL = {"fraction": None, "preallocate": False}
_HOOKED = False
_PREALLOC_SLACK = 64 << 20  # bytes left below the limit for the context


def _context(ctx=None):
    from .context import as_context, current_context

    return as_context(ctx if ctx is not None else current_context())


def _host_walk() -> Tuple[int, int]:
    """(tensors, bytes) of the live tensors on the host, each storage
    once."""
    seen = set()
    n = total = 0
    for obj in gc.get_objects():
        # type(), not isinstance(): isinstance reads __class__, which some
        # tracked objects answer with a deprecation warning
        if issubclass(type(obj), torch.Tensor) and obj.device.type == "cpu":
            st = obj.untyped_storage()
            n += 1
            if st.data_ptr() not in seen:
                seen.add(st.data_ptr())
                total += st.nbytes()
    return n, total


def live_array_bytes(ctx=None) -> Tuple[int, int]:
    """(count, bytes) live on ``ctx``'s device: the caching allocator's
    current allocations on a card, the live tensors on the host."""
    c = _context(ctx)
    if c.device_type == "gpu":
        st = torch.cuda.memory_stats(c.device_id)
        return (int(st.get("allocation.all.current", 0)),
                int(st.get("allocated_bytes.all.current", 0)))
    return _host_walk()


def memory_summaries(devices=None) -> Dict[object, Tuple[int, int]]:
    """{context: (count, bytes)} for ``devices`` (default: every card this
    process sees, or cpu() without one), as :func:`live_array_bytes`."""
    from .context import cpu, gpu

    if devices is None:
        n = torch.cuda.device_count()
        devices = [gpu(i) for i in range(n)] if n else [cpu()]
    return {_context(d): live_array_bytes(d) for d in devices}


def memory_info(ctx=None) -> Tuple[int, int]:
    """(free_bytes, total_bytes) of ``ctx``'s card (ref:
    mx.context.gpu_memory_info).  The host reports no allocator figures:
    a cpu() context raises, naming its live tensors."""
    c = _context(ctx)
    if c.device_type != "gpu":
        n, used = live_array_bytes(c)
        raise MXNetError(
            f"device {c} does not report allocator statistics; live "
            f"tensors on it: {n} / {used} bytes (storage.memory_summary)")
    free, total = torch.cuda.mem_get_info(c.device_id)
    return int(free), int(total)


def memory_summary(ctx=None) -> Dict[str, object]:
    """The allocator's statistics (a card's; none on the host) and the
    live accounting of :func:`live_array_bytes`."""
    c = _context(ctx)
    stats = dict(torch.cuda.memory_stats(c.device_id)) \
        if c.device_type == "gpu" else {}
    n, used = live_array_bytes(c)
    return {"device": str(c), "platform": c.device_type,
            "allocator_stats": stats, "live_arrays": n,
            "live_array_bytes": used}


def _apply_pool() -> None:
    """Runs inside PyTorch's CUDA initialisation (``torch.cuda._lazy_call``):
    the per-process fraction on every card, then the preallocation on
    the current one."""
    frac = _POOL["fraction"]
    if frac is not None:
        for i in range(torch.cuda.device_count()):
            torch.cuda.set_per_process_memory_fraction(frac, i)
    if _POOL["preallocate"]:
        dev = torch.cuda.current_device()
        free, total = torch.cuda.mem_get_info(dev)
        nbytes = min(int((1.0 if frac is None else frac) * total),
                     int(free)) - _PREALLOC_SLACK
        if nbytes > 0:
            block = torch.empty(nbytes, dtype=torch.uint8,
                                device=torch.device("cuda", dev))
            del block


def _hook() -> None:
    global _HOOKED
    if not _HOOKED:
        _HOOKED = True
        torch.cuda._lazy_call(_apply_pool)


def _fraction(pct) -> float:
    if not 0 <= pct < 100:
        raise MXNetError("pool_reserve_pct must be in [0, 100)")
    return (100 - pct) / 100.0


def configure(pool_reserve_pct: Optional[int] = None,
              preallocate: Optional[bool] = None) -> None:
    """Set the allocator knobs; must run before the process's first CUDA
    use (the reference's contract for ``MXNET_GPU_MEM_POOL_*``).

    pool_reserve_pct: percent of each card's memory kept out of the
        caching allocator (ref: MXNET_GPU_MEM_POOL_RESERVE).
    preallocate: take the pool up front (one allocation of the allowed
        share, kept reserved by the caching allocator) instead of
        growing it on demand.
    """
    if torch.cuda.is_initialized():
        raise MXNetError(
            "storage.configure must be called before the first CUDA use "
            "(same before-init contract as the reference's "
            "MXNET_GPU_MEM_POOL_* variables)")
    if pool_reserve_pct is not None:
        _POOL["fraction"] = _fraction(pool_reserve_pct)
    if preallocate is not None:
        _POOL["preallocate"] = bool(preallocate)
    _hook()


def _env_pool_reserve_default() -> None:
    """The reference's variable, read at import."""
    reserve = env.get_int("MXNET_GPU_MEM_POOL_RESERVE")
    if reserve is not None:
        _POOL["fraction"] = _fraction(reserve)
        _hook()


_env_pool_reserve_default()
