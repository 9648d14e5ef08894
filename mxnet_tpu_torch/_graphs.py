"""Compiled execution of the port: one CUDA graph per signature, replayed
per call.

The JAX package compiles three things once per input signature and
runs the executable per call: a hybridized block's forward (``CachedOp``,
``gluon/block.py``), the whole ``SPMDTrainer`` step (``_get_step``,
``parallel/spmd.py``) and ``gluon.Trainer``'s update over every parameter
(``optimizer/fused.py``'s ``FusedUpdater``).  On the card the counterpart
of "compile once, replay per call" is a CUDA graph, and this module holds
what the three sites share:

* :class:`ExecutableCache` — one per site, process-wide: entries by
  (owner, slot) with the full signature beside them, LRU eviction past
  ``MXNET_FUSED_CACHE_MAX`` (and past ``per_owner_max`` entries of one
  owner), and the JAX package's build accounting (``compile_stats()``,
  ``parallel.spmd.step_compile_stats()``).  A slot is what the caller
  keys on (input shapes and dtypes); the signature adds what a capture
  bakes in, down to the address of every tensor it reads or writes in
  place, so a parameter, buffer, state or gradient whose storage moved
  (``load_parameters``, ``cast``, a rebound gradient buffer) misses: the
  slot's old entry is evicted and a new one built and counted.  A graph
  is never replayed onto stale addresses.
* Building an entry on a CUDA device (:class:`Graphed`): the function
  first runs once, eagerly, on a side stream — this is the call's own
  result, and it runs every first-use cost (the ``nvcc`` build of
  ``_kernels``, ``cudaFuncSetAttribute``, cuBLAS handles) outside any
  capture — then it is captured into a ``torch.cuda.CUDAGraph`` in
  ``capture_error_mode="thread_local"`` (the serving batcher captures on
  its own thread).  The entry keeps static input buffers (each call
  copies its inputs in) and the static outputs (each call returns fresh
  copies: a caller holding call N's result never sees call N+1's).  One
  owner's graphs share one memory pool (``torch.cuda.graph_pool_handle``);
  they replay one at a time.  Generators the function draws from are
  registered with the graph (``random.register_graph``), so replays draw
  fresh masks.  The kernels' launch counters count what the capture
  recorded on every replay (``_kernels.capture_tally``).
* Building an entry on the CPU: the same function runs eagerly, each
  call; CPU tensors never reach the card, so the tests hold the cache's
  logic (hits, builds, eviction, stats) on the CPU.
* A build that fails raises: nothing falls back to eager quietly.
  :func:`no_capture` runs the calling thread's sites eagerly, without
  the cache (the comparisons of ``chip_smoke.py`` use it).
"""
from __future__ import annotations

import itertools
import threading
import time
import weakref
from contextlib import contextmanager
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch

from . import _kernels
from . import random as _random
from .util import env as _env

__all__ = ["ExecutableCache", "Graphed", "capture_enabled", "no_capture",
           "owner_token", "tensor_key"]


_TICKS = itertools.count(1)


class _Local(threading.local):
    def __init__(self):
        self.eager = 0


_LOCAL = _Local()


def capture_enabled() -> bool:
    """False inside :func:`no_capture` on this thread."""
    return _LOCAL.eager == 0


@contextmanager
def no_capture():
    """Run this thread's captured sites eagerly: the hybridized forward
    and the two trainers' steps skip the cache (the eager path that a
    captured one is held against)."""
    _LOCAL.eager += 1
    try:
        yield
    finally:
        _LOCAL.eager -= 1


def tensor_key(t: torch.Tensor) -> Tuple:
    """What a capture bakes in of a tensor it reads or writes: its
    address, dtype, shape and strides."""
    return (t.data_ptr(), t.dtype, tuple(t.shape), t.stride())


def _fresh(out):
    """Copies of the tensors of ``out`` (a tensor, or nested tuples and
    lists of them)."""
    if isinstance(out, torch.Tensor):
        return out.clone()
    if isinstance(out, (tuple, list)):
        return type(out)(_fresh(o) for o in out)
    return out


def _tensors(out):
    if isinstance(out, torch.Tensor):
        yield out
    elif isinstance(out, (tuple, list)):
        for o in out:
            yield from _tensors(o)


class _Eager:
    """An entry on the CPU: the function, run each call."""

    graph = None

    def __call__(self, make_fn, inputs):
        return make_fn()(*inputs)


_SIDE: Dict[int, torch.cuda.Stream] = {}
_SIDE_LOCK = threading.Lock()
# one capture at a time in the process (torch.cuda.graph's own rule)
_CAPTURE_LOCK = threading.Lock()


def _side_stream(device: torch.device):
    with _SIDE_LOCK:
        s = _SIDE.get(device.index)
        if s is None:
            s = _SIDE[device.index] = torch.cuda.Stream(device)
        return s


class Graphed:
    """One captured call: static inputs, the graph, static outputs, and
    the kernel launches its capture recorded."""

    def __init__(self, device, graph, static_in, static_out, launches,
                 pool_bytes, capture_s):
        self.device = device
        self.graph = graph
        self.static_in = static_in
        self.static_out = static_out
        self.launches = launches
        self.pool_bytes = pool_bytes
        self.capture_s = capture_s
        self._lock = threading.Lock()

    @classmethod
    def build(cls, make_fn, inputs, device, pool=None, generators=()):
        """Warm up (the call's own result), then capture.  Returns
        (entry, warm-up outputs)."""
        fn = make_fn()
        with torch.cuda.device(device):
            cur = torch.cuda.current_stream(device)
            static_in = [torch.empty_like(a, device=device).copy_(
                a, non_blocking=True) for a in inputs]
            side = _side_stream(device)
            side.wait_stream(cur)
            with torch.cuda.stream(side):
                first = fn(*static_in)
            cur.wait_stream(side)
            for t in _tensors(first):
                t.record_stream(cur)
            graph = torch.cuda.CUDAGraph()
            for g in generators:
                _random.register_graph(graph, g)
            t0 = time.perf_counter()
            with _CAPTURE_LOCK, _kernels.capture_tally() as tally:
                with torch.cuda.graph(graph, pool=pool, stream=side,
                                      capture_error_mode="thread_local"):
                    r0 = torch.cuda.memory_reserved(device)
                    static_out = fn(*static_in)
                pool_bytes = torch.cuda.memory_reserved(device) - r0
            cur.wait_stream(side)
            dt = time.perf_counter() - t0
        return cls(device, graph, static_in, static_out, dict(tally),
                   pool_bytes, dt), first

    def __call__(self, make_fn, inputs):
        with self._lock, torch.cuda.device(self.device):
            for s, a in zip(self.static_in, inputs):
                s.copy_(a, non_blocking=True)
            self.graph.replay()
            _kernels.add_launches(self.launches)
            return _fresh(self.static_out)


class _Entry:
    __slots__ = ("fn", "sig", "tick", "owner")

    def __init__(self, fn, sig, owner):
        self.fn = fn
        self.sig = sig
        self.owner = owner
        self.tick = next(_TICKS)


_OWNER_TOKENS: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()
_OWNER_NEXT = itertools.count(1)
_OWNER_LOCK = threading.Lock()


def owner_token(owner) -> int:
    """A number for ``owner`` (a trainer, an updater, a block) that no
    other live object gets."""
    with _OWNER_LOCK:
        tok = _OWNER_TOKENS.get(owner)
        if tok is None:
            tok = _OWNER_TOKENS[owner] = next(_OWNER_NEXT)
        return tok


class ExecutableCache:
    """The captured entries of one site and their build accounting (see
    the module docstring)."""

    def __init__(self, site: str, per_owner_max: Optional[int] = None):
        self.site = site
        self.data: Dict[Tuple, _Entry] = {}
        self.lock = threading.RLock()
        self.per_owner_max = per_owner_max
        self.compiles = 0
        self.seconds = 0.0
        self.evictions = 0
        self.eager = 0
        self._pools: Dict[int, Any] = {}
        self._finalizers: Dict[int, Any] = {}

    def stats(self) -> Dict[str, float]:
        """The JAX package's keys (``count`` builds, ``seconds_total``
        spent building them, ``cache_loads`` always 0: there is no
        persistent tier, ``evictions``, ``size``) and ``eager``: calls
        this site ran eagerly because capture does not apply (a step over
        a process group).  Each entry's capture seconds and pool bytes
        are on its ``Graphed`` (:meth:`entries`)."""
        with self.lock:
            return {"count": self.compiles, "seconds_total": self.seconds,
                    "cache_loads": 0, "evictions": self.evictions,
                    "size": len(self.data), "eager": self.eager}

    def note_eager(self) -> None:
        with self.lock:
            self.eager += 1

    def _evict_locked(self, key) -> None:
        if self.data.pop(key, None) is not None:
            self.evictions += 1

    def drop_owner(self, tok: int) -> None:
        """Forget a dead owner's entries and pool (not evictions)."""
        with self.lock:
            for key in [k for k in self.data if k[0] == tok]:
                del self.data[key]
            self._pools.pop(tok, None)
            self._finalizers.pop(tok, None)

    def entries(self, owner) -> List:
        """The live entries of ``owner`` (Graphed or the CPU marker)."""
        tok = owner_token(owner)
        with self.lock:
            return [e.fn for k, e in self.data.items() if k[0] == tok]

    def run(self, owner, slot, sig, make_fn, inputs: Sequence, device,
            generators=()):
        """Call the entry of ``(owner, slot)`` when its signature is
        ``sig``; else build one (evicting the slot's stale entry), which
        runs the call once.  ``make_fn()`` returns the function of the
        inputs.  Returns the call's outputs (fresh tensors)."""
        tok = owner_token(owner)
        key = (tok, slot)
        with self.lock:
            ent = self.data.get(key)
            if ent is not None and ent.sig == sig:
                ent.tick = next(_TICKS)
                fn = ent.fn
            else:
                fn = None
                if ent is not None:
                    self._evict_locked(key)
        if fn is not None:
            return fn(make_fn, inputs)
        t0 = time.perf_counter()
        if device.type == "cuda":
            with self.lock:
                pool = self._pools.get(tok)
                if pool is None:
                    pool = self._pools[tok] = torch.cuda.graph_pool_handle()
            fn, out = Graphed.build(make_fn, inputs, device, pool,
                                    generators)
        else:
            fn, out = _Eager(), make_fn()(*inputs)
        dt = time.perf_counter() - t0
        with self.lock:
            self.compiles += 1
            self.seconds += dt
            self.data[key] = _Entry(fn, sig, tok)
            if tok not in self._finalizers:
                self._finalizers[tok] = weakref.finalize(
                    owner, self.drop_owner, tok)
            self._trim_locked(tok, key)
        return out

    def _trim_locked(self, tok, keep) -> None:
        caps = [(lambda k: True, _env.get_int("MXNET_FUSED_CACHE_MAX"))]
        if self.per_owner_max:
            caps.append((lambda k: k[0] == tok, self.per_owner_max))
        for match, cap in caps:
            while True:
                mine = [(e.tick, k) for k, e in self.data.items()
                        if match(k) and k != keep]
                if not cap or len(mine) + 1 <= cap or not mine:
                    break
                self._evict_locked(min(mine)[1])

