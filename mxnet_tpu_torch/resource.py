"""Per-device resource manager (counterpart of ``mxnet_tpu/resource.py``,
the reference's ``src/resource.cc`` ``ResourceManager``).

- ``random`` — one ``torch.Generator`` per :class:`Context`, on the
  context's device, seeded by folding the device type and id into the
  root seed (the JAX package folds them into a threefry key).  A reseed
  resets the generators in place, so a generator already handed out
  follows it.  ``mx.random.seed`` and ``random.generator`` go through
  here.
- ``parallel_random`` — ``n`` independent generators for ops that draw
  many streams, seeded from one draw of the device's stream.
- ``temp_space`` — reusable host staging scratch per (context, thread),
  grow-only, the reference's temp-space discipline.
- ``cudnn_dropout_desc`` is refused: the port's dropout draws from the
  device's generator and keeps no descriptor state.

The streams are Philox (CUDA) and Mersenne Twister (CPU), not threefry:
draws do not match the JAX package's, only their properties do.
"""
from __future__ import annotations

import hashlib
import threading
import zlib
from typing import Dict, List, Tuple

import numpy as np
import torch

from .base import MXNetError
from .context import Context, as_context, current_context

__all__ = ["ResourceManager", "resource_manager"]

_KINDS = ("temp_space", "random", "parallel_random")
_SEED_MASK = (1 << 63) - 1


def _fold(root: int, *parts: int) -> int:
    """A 63-bit seed from the root seed and the folded-in integers,
    stable across processes (sha256, not ``hash``)."""
    h = hashlib.sha256(":".join(str(int(p)) for p in (root,) + parts)
                       .encode())
    return int.from_bytes(h.digest()[:8], "little") & _SEED_MASK


def _ctx_key(ctx) -> Tuple[str, int]:
    ctx = current_context() if ctx is None else as_context(ctx)
    return ctx.device_type, ctx.device_id


class ResourceManager:
    """Owns the per-context resources; one process-wide instance
    (:func:`resource_manager`)."""

    def __init__(self, root_seed: int = 0):
        self._lock = threading.Lock()
        self._root_seed = int(root_seed)
        self._rand: Dict[Tuple[str, int], torch.Generator] = {}
        self._tls = threading.local()

    @property
    def root_seed(self) -> int:
        return self._root_seed

    # -- random -------------------------------------------------------------
    def _derive(self, key: Tuple[str, int], root: int = None) -> int:
        return _fold(self._root_seed if root is None else root,
                     zlib.crc32(key[0].encode()) & 0x7FFFFFFF, key[1])

    def seed(self, seed_state: int, ctx=None) -> None:
        """Reseed the device streams: every one from the new root
        without ``ctx``, else only ``ctx``'s (the reference's
        MXRandomSeedContext).  Generators are reset in place."""
        with self._lock:
            if ctx is None:
                self._root_seed = int(seed_state)
                for key, g in self._rand.items():
                    g.manual_seed(self._derive(key))
                return
            key = _ctx_key(ctx)
            g = self._rand.get(key)
            if g is None:
                g = self._rand[key] = torch.Generator(
                    device=Context(*key).torch_device)
            g.manual_seed(self._derive(key, root=int(seed_state)))

    def random(self, ctx=None) -> torch.Generator:
        """The device's generator."""
        key = _ctx_key(ctx)
        with self._lock:
            g = self._rand.get(key)
            if g is None:
                g = self._rand[key] = torch.Generator(
                    device=Context(*key).torch_device)
                g.manual_seed(self._derive(key))
            return g

    def parallel_random(self, n: int, ctx=None) -> List[torch.Generator]:
        """``n`` independent generators on the device, seeded from one
        draw of its stream."""
        g = self.random(ctx)
        base = int(torch.randint(0, 1 << 62, (1,), generator=g,
                                 device=g.device).item())
        seeds = [_fold(base, lane) for lane in range(int(n))]
        if len(set(seeds)) != len(seeds):  # 2^-63 a pair
            raise MXNetError("parallel_random: two lanes drew one seed")
        return [torch.Generator(device=g.device).manual_seed(s)
                for s in seeds]

    def rng_state(self) -> dict:
        """A JSON-able snapshot of the root seed and every device
        stream's state: a resumed job continues the streams."""
        with self._lock:
            return {"root_seed": self._root_seed,
                    "streams": {f"{k[0]}:{k[1]}": g.get_state().tolist()
                                for k, g in self._rand.items()}}

    def set_rng_state(self, state: dict) -> None:
        """Restore an :meth:`rng_state` snapshot in place; a device the
        snapshot has not seen derives its stream from the restored root
        as usual."""
        with self._lock:
            self._root_seed = int(state["root_seed"])
            for name, raw in state.get("streams", {}).items():
                dev_type, _, dev_id = name.rpartition(":")
                key = (dev_type, int(dev_id))
                g = self._rand.get(key)
                if g is None:
                    g = self._rand[key] = torch.Generator(
                        device=Context(*key).torch_device)
                g.set_state(torch.tensor(raw, dtype=torch.uint8))

    # -- temp space ---------------------------------------------------------
    def temp_space(self, nbytes: int, ctx=None) -> np.ndarray:
        """Host staging scratch, reused across requests of one (context,
        thread) and grown monotonically: a uint8 view of ``nbytes``
        whose contents do not survive the next request."""
        key = _ctx_key(ctx)
        pool = getattr(self._tls, "pool", None)
        if pool is None:
            pool = self._tls.pool = {}
        buf = pool.get(key)
        if buf is None or buf.nbytes < nbytes:
            buf = pool[key] = np.empty((max(int(nbytes), 1),), np.uint8)
        return buf[:nbytes]

    # -- the front door (the reference's Resource::Request) -----------------
    def request(self, kind: str, ctx=None, **kw):
        if kind == "temp_space":
            return self.temp_space(kw.get("nbytes", 0), ctx)
        if kind == "random":
            return self.random(ctx)
        if kind == "parallel_random":
            return self.parallel_random(kw.get("n", 1), ctx)
        if kind == "cudnn_dropout_desc":
            raise MXNetError(
                "resource kind 'cudnn_dropout_desc' is not served: the "
                "port's dropout draws from the device's torch.Generator "
                "and keeps no descriptor state")
        raise MXNetError(
            f"unknown resource kind {kind!r}; expected one of {_KINDS}")


_MANAGER = None
_MANAGER_LOCK = threading.Lock()


def resource_manager() -> ResourceManager:
    global _MANAGER
    if _MANAGER is None:
        with _MANAGER_LOCK:
            if _MANAGER is None:
                _MANAGER = ResourceManager()
    return _MANAGER
