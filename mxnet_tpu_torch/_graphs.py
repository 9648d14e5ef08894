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
* The eager-entry rule: a function that runs Python a replay cannot
  repeat — a ``Custom`` op's forward and backward, a ``while_loop`` or
  ``cond`` that reads its predicate from the device — says so through
  :func:`note_host_python`.  When the warm-up call of a signature (the
  eager call before any capture, in :meth:`ExecutableCache.run` and in
  :meth:`ExecutableCache.run_train`) did, the signature is built as an
  eager entry: the function runs on every call, as it does on the CPU,
  and is never captured.  Each call that ran such Python is counted in
  ``stats()["custom_eager"]``, on the card and on the CPU alike.  A
  signature whose function never calls it is captured as before.

The training-mode entry (:meth:`ExecutableCache.run_train`, the
hybridized forward under ``autograd.record()``) is a forward graph and a
backward graph behind one ``torch.autograd.Function`` (:class:`TrainPair`
on the card, :class:`EagerPair` on the CPU, with the same bookkeeping):

* Warm-up: on the card, the calls of a signature run eagerly on the
  side stream (each its own result, forward and backward) until one of
  them has finished its backward, so that every first-use cost of both
  directions lands outside a capture.  Build, at the next call: the
  forward is captured (the generators registered) and, from its outputs,
  the backward (``torch.autograd.grad`` into static gradients), both
  into one private memory pool of the pair: the saved activations live
  there between the two replays.  The build call replays, and so does
  every later one.
* Forward: the inputs are copied into static buffers, the forward graph
  replays (BatchNorm's running statistics are updated once, in place, in
  it) and the outputs are returned as fresh copies.  Backward: the
  cotangents are copied into static buffers (an output the loss does not
  use gets zeros), the backward graph replays, and the static gradients
  of the parameters and inputs that require one go back to autograd.
* A pair is busy from its forward to its backward (or until the
  outputs' graph is dropped): a second forward of the signature in
  flight takes another pair (a counted build), never the first one's
  activations.  A second backward through a consumed pair raises.
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

__all__ = ["ExecutableCache", "Graphed", "TrainPair", "EagerPair",
           "capture_enabled", "no_capture", "note_host_python",
           "owner_token", "tensor_key",
           "segment", "segment_value", "in_segment",
           "segment_recomputing"]


_TICKS = itertools.count(1)


class _Local(threading.local):
    def __init__(self):
        self.eager = 0
        self.host = 0


_LOCAL = _Local()


def note_host_python() -> None:
    """Say that the running function executes Python that a CUDA graph's
    replay cannot repeat (see the module docstring's eager-entry rule)."""
    _LOCAL.host += 1


def _host_calls() -> int:
    return _LOCAL.host


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
        """Warm up (the call's own result), then capture — unless the
        warm-up ran Python a replay cannot repeat, when the entry is an
        eager one.  Returns (entry, warm-up outputs)."""
        fn = make_fn()
        with torch.cuda.device(device):
            cur = torch.cuda.current_stream(device)
            static_in = [torch.empty_like(a, device=device).copy_(
                a, non_blocking=True) for a in inputs]
            side = _side_stream(device)
            side.wait_stream(cur)
            h0 = _host_calls()
            with torch.cuda.stream(side):
                first = fn(*static_in)
            cur.wait_stream(side)
            for t in _tensors(first):
                t.record_stream(cur)
            if _host_calls() != h0:
                return _Eager(), first
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


# ---------------------------------------------------------------------------
# the training-mode entry: a forward graph and a backward graph
# ---------------------------------------------------------------------------

def _flatten(out, acc):
    """The tensors of ``out`` (a tensor or nested tuples and lists of
    them) into ``acc``; returns the structure to rebuild it."""
    if isinstance(out, torch.Tensor):
        acc.append(out)
        return None
    if isinstance(out, (tuple, list)):
        return (type(out), [_flatten(o, acc) for o in out])
    raise TypeError(f"a hybridized forward returned {type(out).__name__}; "
                    "tensors, tuples and lists of them are captured")


def _unflatten(tree, it):
    if tree is None:
        return next(it)
    kind, items = tree
    return kind(_unflatten(t, it) for t in items)


class _Lease:
    """One forward's hold on a pair, kept by the autograd node: released
    by the backward, or when the node is dropped without one."""

    def __init__(self, pair, token):
        self.pair = pair
        self.token = token
        self.consumed = False

    def __del__(self):
        self.pair.release(self.token)


class _PairBase:
    """What :class:`TrainPair` and :class:`EagerPair` share: the busy
    flag and the autograd function."""

    def __init__(self):
        self._lock = threading.Lock()
        self._token = 0
        self.busy = False

    def try_acquire(self):
        with self._lock:
            if self.busy:
                return None
            self.busy = True
            self._token += 1
            return self._token

    def release(self, token):
        with self._lock:
            if self._token == token:
                self.busy = False

    def apply(self, token, params, inputs):
        """The call through the autograd function; returns the outputs in
        the function's structure."""
        flat = _TrainFn.apply(self, token, len(params), *params, *inputs)
        return _unflatten(self.tree, iter(flat))


class _TrainFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, pair, token, n_params, *tensors):
        outs = pair.forward(tensors[:n_params], tensors[n_params:])
        ctx.lease = _Lease(pair, token)
        ctx.n_in = len(tensors)
        ctx.set_materialize_grads(False)
        ctx.mark_non_differentiable(
            *[o for o, r in zip(outs, pair.out_req) if not r])
        return tuple(outs)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, *cts):
        from .base import MXNetError

        lease = ctx.lease
        if lease.consumed:
            raise MXNetError(
                "a second backward through a captured hybridized forward: "
                "its activations were released by the first; run the "
                "forward again")
        lease.consumed = True
        try:
            grads = lease.pair.backward(cts)
        finally:
            lease.pair.release(lease.token)
        return (None, None, None) + tuple(grads)


def _aliases(params):
    """A leaf of its own for each parameter, on its storage: the
    function's graph differentiates these, so it never meets the
    parameters' accumulators, which the graph around the call owns (on
    its stream)."""
    return [p.detach().requires_grad_() for p in params]


def _grads_for(params, inputs, in_req, grads):
    """Static gradients in the order of the function's tensors (a None
    for an input that requires none)."""
    it = iter(grads)
    out = [next(it) for _ in params]
    out += [next(it) if r else None for r in in_req]
    return out


class EagerPair(_PairBase):
    """The training-mode entry on the CPU (and a warm-up call on the
    card): the forward runs eagerly each call and keeps its graph; the
    backward takes its gradients with ``torch.autograd.grad``.  Its
    function is ``fn(param_aliases, *inputs)``: it runs the forward with
    the parameters swapped for the aliases (:func:`_aliases`)."""

    graph = None

    def __init__(self, make_fn, in_req, stream=None, on_backward=None):
        super().__init__()
        self.fn = make_fn()
        self.in_req = in_req
        self.tree = None
        self.out_req = None
        self._saved = None
        # the warm-up calls of a signature on the card: on the side stream
        self._stream = stream
        self._on_backward = on_backward

    @contextmanager
    def _on_stream(self):
        if self._stream is None:
            yield
            return
        cur = torch.cuda.current_stream(self._stream.device)
        self._stream.wait_stream(cur)
        with torch.cuda.stream(self._stream):
            yield
        cur.wait_stream(self._stream)

    def forward(self, params, inputs):
        inner = [x.detach().requires_grad_(r)
                 for x, r in zip(inputs, self.in_req)]
        aliases = _aliases(params)
        with self._on_stream(), torch.enable_grad():
            out = self.fn(aliases, *inner)
        flat = []
        self.tree = _flatten(out, flat)
        self.out_req = [o.requires_grad for o in flat]
        self._saved = (flat, aliases, inner)
        if self._stream is not None:
            cur = torch.cuda.current_stream(self._stream.device)
            for o in flat:
                o.record_stream(cur)
        return [o.detach() for o in flat]

    def backward(self, cts):
        flat, params, inner = self._saved
        self._saved = None
        outs = [o for o, r in zip(flat, self.out_req) if r]
        cts = [torch.zeros_like(o) if c is None else c
               for o, c, r in zip(flat, cts, self.out_req) if r]
        wrt = list(params) + [x for x, r in zip(inner, self.in_req) if r]
        with self._on_stream():
            grads = torch.autograd.grad(outs, wrt, cts, allow_unused=True) \
                if outs and wrt else [None] * len(wrt)
        if self._on_backward is not None:
            self._on_backward()
        return _grads_for(params, inner, self.in_req, grads)

    def release(self, token):
        with self._lock:
            if self._token == token:
                self._saved = None
                self.busy = False


class TrainPair(_PairBase):
    """The training-mode entry on a CUDA device (see the module
    docstring)."""

    def __init__(self, device, tree, out_req, static_in, static_out,
                 static_ct, static_grads, fwd, bwd, tallies, pool_bytes,
                 capture_s):
        super().__init__()
        self.device = device
        self.tree = tree
        self.out_req = out_req
        self.static_in = static_in
        self.static_out = static_out
        self.static_ct = static_ct
        self.static_grads = static_grads
        self.graph, self.bwd_graph = fwd, bwd
        self.launches, self.bwd_launches = tallies
        self.pool_bytes = pool_bytes
        self.capture_s = capture_s

    @classmethod
    def build(cls, make_fn, params, inputs, in_req, device, generators=()):
        """Capture the forward and the backward graphs into one private
        pool (a warm-up call of the signature has run before)."""
        fn = make_fn()
        with torch.cuda.device(device):
            cur = torch.cuda.current_stream(device)
            static_in = [torch.empty_like(a, device=device).copy_(
                a.detach(), non_blocking=True).requires_grad_(r)
                for a, r in zip(inputs, in_req)]
            aliases = _aliases(params)
            wrt = aliases + [x for x, r in zip(static_in, in_req) if r]
            side = _side_stream(device)
            side.wait_stream(cur)
            pool = torch.cuda.graph_pool_handle()
            fwd, bwd = torch.cuda.CUDAGraph(), torch.cuda.CUDAGraph()
            for g in generators:
                _random.register_graph(fwd, g)
            t0 = time.perf_counter()
            r0 = torch.cuda.memory_reserved(device)
            with _CAPTURE_LOCK:
                with _kernels.capture_tally() as t_fwd:
                    with torch.cuda.graph(fwd, pool=pool, stream=side,
                                          capture_error_mode="thread_local"):
                        with torch.enable_grad():
                            flat = []
                            tree = _flatten(fn(aliases, *static_in), flat)
                out_req = [o.requires_grad for o in flat]
                outs = [o for o, r in zip(flat, out_req) if r]
                with _kernels.capture_tally() as t_bwd:
                    with torch.cuda.graph(bwd, pool=pool, stream=side,
                                          capture_error_mode="thread_local"):
                        static_ct = [torch.empty_like(o) if r else None
                                     for o, r in zip(flat, out_req)]
                        grads = torch.autograd.grad(
                            outs, wrt, [c for c in static_ct if c is not None],
                            allow_unused=True) if outs and wrt \
                            else [None] * len(wrt)
            pool_bytes = torch.cuda.memory_reserved(device) - r0
            cur.wait_stream(side)
            dt = time.perf_counter() - t0
        static_out = [o.detach() for o in flat]
        return cls(device, tree, out_req, static_in, static_out, static_ct,
                   _grads_for(params, static_in, in_req, grads), fwd, bwd,
                   (dict(t_fwd), dict(t_bwd)), pool_bytes, dt)

    def forward(self, params, inputs):
        with torch.cuda.device(self.device):
            for s, a in zip(self.static_in, inputs):
                s.detach().copy_(a, non_blocking=True)
            self.graph.replay()
            _kernels.add_launches(self.launches)
            return [o.clone() for o in self.static_out]

    def backward(self, cts):
        with torch.cuda.device(self.device):
            for s, c in zip(self.static_ct, cts):
                if s is None:
                    continue
                if c is None:
                    s.zero_()
                else:
                    s.copy_(c, non_blocking=True)
            self.bwd_graph.replay()
            _kernels.add_launches(self.bwd_launches)
            return list(self.static_grads)


class _TrainEntry:
    """The pairs of one training-mode signature, and whether a warm-up
    call has finished its backward (on the card)."""

    def __init__(self):
        self.pairs: List[_PairBase] = []
        self.warm = False
        self.host = False  # the eager-entry rule applies

    def set_warm(self):
        self.warm = True


# ---------------------------------------------------------------------------
# gradient mirroring: what a checkpoint segment's recompute must repeat
# ---------------------------------------------------------------------------

class _SegLocal(threading.local):
    def __init__(self):
        self.seg = None


_SEG = _SegLocal()


class _Segment:
    """The values a mirror segment's first pass drew or read (dropout
    masks, BatchNorm's running mean before its update), handed back in
    order to its recompute, which must give the same bits and must not
    update the running statistics again."""

    def __init__(self):
        self.values = []
        self.passes = 0
        self.cursor = 0

    @contextmanager
    def run(self):
        self.passes += 1
        self.cursor = 0
        old, _SEG.seg = _SEG.seg, self
        try:
            yield self
        finally:
            _SEG.seg = old

    @property
    def recomputing(self) -> bool:
        return self.passes > 1


def segment() -> _Segment:
    """A new segment (``with seg.run():`` around each of its passes)."""
    return _Segment()


def segment_value(make):
    """``make()`` outside a segment and in its first pass (kept), the
    kept value in its recompute."""
    seg = _SEG.seg
    if seg is None:
        return make()
    if seg.recomputing:
        v = seg.values[seg.cursor]
        seg.cursor += 1
        return v
    v = make()
    seg.values.append(v)
    return v


def in_segment() -> bool:
    return _SEG.seg is not None


def segment_recomputing() -> bool:
    """True inside the recompute of a mirror segment."""
    seg = _SEG.seg
    return seg is not None and seg.recomputing


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
        self.custom_eager = 0
        self._pools: Dict[int, Any] = {}
        self._finalizers: Dict[int, Any] = {}

    def stats(self) -> Dict[str, float]:
        """The JAX package's keys (``count`` builds, ``seconds_total``
        spent building them, ``cache_loads`` always 0: there is no
        persistent tier, ``evictions``, ``size``), ``eager``: calls
        this site ran eagerly because capture does not apply (a step over
        a process group), and ``custom_eager``: calls whose function ran
        Python a replay cannot repeat, each run eagerly (the eager-entry
        rule of the module docstring).  Each entry's capture seconds and
        pool bytes are on its ``Graphed`` (:meth:`entries`)."""
        with self.lock:
            return {"count": self.compiles, "seconds_total": self.seconds,
                    "cache_loads": 0, "evictions": self.evictions,
                    "size": len(self.data), "eager": self.eager,
                    "custom_eager": self.custom_eager}

    def note_eager(self) -> None:
        with self.lock:
            self.eager += 1

    def _counted(self, call):
        """``(call(), host)``: ``host`` says whether the call ran Python a
        replay cannot repeat, when it is counted in ``custom_eager``."""
        h0 = _host_calls()
        out = call()
        host = _host_calls() != h0
        if host:
            with self.lock:
                self.custom_eager += 1
        return out, host

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
            out = []
            for k, e in self.data.items():
                if k[0] == tok:
                    out += e.fn.pairs if isinstance(e.fn, _TrainEntry) \
                        else [e.fn]
            return out

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
            return self._counted(lambda: fn(make_fn, inputs))[0]
        t0 = time.perf_counter()
        if device.type == "cuda":
            with self.lock:
                pool = self._pools.get(tok)
                if pool is None:
                    pool = self._pools[tok] = torch.cuda.graph_pool_handle()
            (fn, out), _ = self._counted(lambda: Graphed.build(
                make_fn, inputs, device, pool, generators))
        else:
            fn, out = _Eager(), self._counted(lambda: make_fn()(*inputs))[0]
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

    def run_train(self, owner, slot, sig, make_fn, params, inputs, in_req,
                  device, generators=()):
        """The training-mode call of ``(owner, slot)`` (see the module
        docstring): a free pair of the entry whose signature is ``sig``,
        else a warm-up call (on the card, until one has finished its
        backward), else a new pair (a counted build; a stale entry is
        evicted first).  ``params`` are the tensors gradients flow to,
        ``in_req`` says which inputs require one."""
        tok = owner_token(owner)
        key = (tok, slot)
        with self.lock:
            ent = self.data.get(key)
            if ent is not None and ent.sig != sig:
                self._evict_locked(key)
                ent = None
            if ent is None:
                ent = self.data[key] = _Entry(_TrainEntry(), sig, tok)
                if tok not in self._finalizers:
                    self._finalizers[tok] = weakref.finalize(
                        owner, self.drop_owner, tok)
                self._trim_locked(tok, key)
            ent.tick = next(_TICKS)
            entry = ent.fn
            for pair in entry.pairs:
                token = pair.try_acquire()
                if token is not None:
                    return self._counted(
                        lambda: pair.apply(token, params, inputs))[0]
            warm, host = entry.warm, entry.host
        if device.type == "cuda" and not warm and not host:
            pair = EagerPair(make_fn, in_req, stream=_side_stream(device),
                             on_backward=entry.set_warm)
            token = pair.try_acquire()
            out, host = self._counted(
                lambda: pair.apply(token, params, inputs))
            if host:
                # the eager-entry rule: this pair is the signature's
                # entry, and no capture is ever built for it
                with self.lock:
                    self.compiles += 1
                    entry.host = True
                    entry.pairs.append(pair)
            return out
        t0 = time.perf_counter()
        if device.type == "cuda" and not host:
            pair = TrainPair.build(make_fn, params, inputs, in_req, device,
                                   generators)
        else:
            pair = EagerPair(make_fn, in_req)
        token = pair.try_acquire()
        dt = time.perf_counter() - t0
        with self.lock:
            self.compiles += 1
            self.seconds += dt
            entry.pairs.append(pair)
        return self._counted(lambda: pair.apply(token, params, inputs))[0]

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

