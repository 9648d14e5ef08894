"""DataLoader (counterpart of ``mxnet_tpu/gluon/data/dataloader.py``).

Batches are NDArrays on the CPU, as MXNet's loader returns them; the
training loop moves them with ``as_in_context``.  Three ways to build
them, the JAX package's:

  * ``num_workers=0``: in the calling thread;
  * ``worker_pool="thread"`` (the default pool, and ``thread_pool=True``):
    N worker threads and a reorder buffer, so batches arrive in sampler
    order; the parallelism pays where ``__getitem__`` releases the GIL
    (numpy, decoding);
  * ``worker_pool="process"``: a persistent pool of ``spawn``ed processes
    (never forked: the parent may hold a CUDA context).  The children
    run on the CPU only (``CUDA_VISIBLE_DEVICES`` is emptied in each),
    and send numpy batches back through POSIX shared memory
    (``worker_transport="shm"``, the reference's CPUSharedStorage role:
    the child writes the arrays into a segment and ships its name; the
    parent copies them out and unlinks it) or pickled through the pool's
    pipe (``"pipe"``).  Segments still in flight when the iterator stops
    (an early ``break``, an error, a timeout) are reclaimed.

A batch that takes longer than ``timeout`` seconds raises; a worker that
dies (a thread that exits without publishing, a child process that is
killed) raises :class:`WorkerDied` in the consumer at once.  An
exception in ``__getitem__`` re-raises in the consumer.  ``prefetch``
(default ``MXNET_PREFETCH_DEPTH``, else 2 x num_workers) bounds the
batches in flight.  :meth:`DataLoader.resume_from` starts the next
epoch at a given batch.

Random transforms (``vision.transforms``) draw, inside a loader, from
the batch's own generator: at the start of each epoch the loader draws
one seed from numpy's global generator (after the sampler's order), and
batch i draws from ``RandomState(seed + i)``, whichever thread or
process builds it.  So a loader gives the same batches with any number
of workers and either pool under the same ``np.random.seed``.  Outside
a loader a transform draws from numpy's global generator, as in the
JAX package.  The JAX package's chaos, telemetry and sanitizer hooks
are ROADMAP queue A item 10.
"""
from __future__ import annotations

import os
import queue
import threading
import time
import weakref
from collections import deque
from contextlib import contextmanager

import numpy as np
import torch

from ...base import MXNetError
from ...ndarray.ndarray import NDArray, _cpu_array
from ...util import env as _env
from .sampler import BatchSampler, RandomSampler, SequentialSampler

__all__ = ["DataLoader", "WorkerDied", "default_batchify_fn",
           "default_mp_batchify_fn", "batch_rng"]


class WorkerDied(MXNetError):
    """A DataLoader worker (thread or spawned process) exited abnormally;
    raised in the consumer, ``worker`` the thread name or child pid."""

    def __init__(self, msg: str, worker=None):
        super().__init__(msg)
        self.worker = worker


class _BatchRng(threading.local):
    rng = None


_BATCH_RNG = _BatchRng()


def batch_rng():
    """The generator of the batch this thread is building inside a
    loader (a ``numpy.random.RandomState``), None outside one."""
    return _BATCH_RNG.rng


@contextmanager
def _seeded(seed):
    old, _BATCH_RNG.rng = _BATCH_RNG.rng, np.random.RandomState(seed)
    try:
        yield
    finally:
        _BATCH_RNG.rng = old


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


default_mp_batchify_fn = default_batchify_fn


def _numpy_batchify(data):
    """A child process's batchify: the stacking and dtype rules of
    ``default_batchify_fn``, producing numpy (NDArrays are made in the
    parent)."""
    if isinstance(data[0], tuple):
        return tuple(_numpy_batchify(list(d)) for d in zip(*data))
    if isinstance(data[0], NDArray):
        data = [d.asnumpy() for d in data]
    return _stack_narrow(data)


def _to_numpy(x):
    if isinstance(x, NDArray):
        return x.asnumpy()
    if isinstance(x, torch.Tensor):
        return x.numpy()
    if isinstance(x, tuple):
        return tuple(_to_numpy(e) for e in x)
    return x


def _all_arrays(x):
    if isinstance(x, tuple):
        return all(_all_arrays(e) for e in x)
    return isinstance(x, np.ndarray)


# ---------------------------------------------------------------------------
# shared-memory transport
# ---------------------------------------------------------------------------

def _shm_pack(out):
    """numpy tree -> (segment name, spec); the spec mirrors the tuples
    with ('a', shape, dtype, offset) leaves.  The child detaches its
    resource-tracker registration (the parent owns the segment) and
    unlinks the segment itself if packing fails."""
    from multiprocessing import resource_tracker, shared_memory

    flat = []

    def walk(x):
        if isinstance(x, tuple):
            return ("t", tuple(walk(e) for e in x))
        a = np.ascontiguousarray(x)
        flat.append(a)
        return ("a", a.shape, a.dtype.str, None)

    spec = walk(out)
    shm = shared_memory.SharedMemory(create=True,
                                     size=max(sum(a.nbytes for a in flat),
                                              1))
    try:
        offs, off = [], 0
        for a in flat:
            np.ndarray(a.shape, a.dtype, buffer=shm.buf, offset=off)[...] = a
            offs.append(off)
            off += a.nbytes
    except BaseException:
        shm.close()
        shm.unlink()
        raise
    it = iter(offs)

    def fix(s):
        if s[0] == "t":
            return ("t", tuple(fix(e) for e in s[1]))
        return ("a", s[1], s[2], next(it))

    spec = fix(spec)
    resource_tracker.unregister(shm._name, "shared_memory")
    shm.close()
    return shm.name, spec


def _shm_unpack(name, spec):
    """Copy the segment's arrays out into CPU NDArrays, then unlink it."""
    from multiprocessing import shared_memory

    shm = shared_memory.SharedMemory(name=name)
    try:
        def walk(s):
            if s[0] == "t":
                return tuple(walk(e) for e in s[1])
            _, shape, dt, off = s
            view = np.ndarray(shape, dtype=np.dtype(dt), buffer=shm.buf,
                              offset=off)
            return _cpu_array(np.array(view))  # a copy before the unlink

        return walk(spec)
    finally:
        shm.close()
        shm.unlink()


def _unlink(name):
    from multiprocessing import shared_memory

    try:
        seg = shared_memory.SharedMemory(name=name)
    except FileNotFoundError:
        return
    seg.close()
    seg.unlink()


def _drain_shm(pending, timeout):
    """Reclaim the segments of results still in flight; ``timeout`` is
    the wait for each (a live batch still packing must be waited out, or
    its segment leaks)."""
    for res in pending:
        try:
            out = res.get(timeout)
        except Exception:
            continue  # a failed batch packed nothing
        if isinstance(out, tuple) and len(out) == 3 and out[0] == "__shm__":
            _unlink(out[1])


# the spawned child's state: one dataset and batchify per process
_MP_STATE: dict = {}


def _mp_init(dataset, batchify_fn, transport):
    # children never touch the card: CUDA is initialized lazily, so an
    # empty device list here makes any CUDA call in a child fail
    os.environ["CUDA_VISIBLE_DEVICES"] = ""
    torch.set_num_threads(1)
    _MP_STATE.update(dataset=dataset, batchify=batchify_fn,
                     transport=transport)


def _mp_make_batch(indices, seed):
    ds, bfn = _MP_STATE["dataset"], _MP_STATE["batchify"]
    with _seeded(seed):
        out = _to_numpy(bfn([ds[i] for i in indices]))
    if _MP_STATE["transport"] == "shm" and _all_arrays(out):
        return ("__shm__",) + _shm_pack(out)
    return out


class DataLoader:
    def __init__(self, dataset, batch_size=None, shuffle=False, sampler=None,
                 last_batch=None, batch_sampler=None, batchify_fn=None,
                 num_workers=0, pin_memory=False, prefetch=None,
                 thread_pool=False, timeout=120, worker_pool=None,
                 worker_transport="shm"):
        self._dataset = dataset
        self._timeout = timeout
        if worker_pool is None or thread_pool:
            worker_pool = "thread"
        if worker_pool not in ("thread", "process"):
            raise MXNetError("worker_pool must be 'thread' or 'process'")
        if worker_transport not in ("shm", "pipe"):
            raise MXNetError("worker_transport must be 'shm' or 'pipe'")
        self._worker_pool = worker_pool
        self._worker_transport = worker_transport
        self._pool = None  # the persistent spawn pool, made at first use
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
        self._num_workers = max(0, num_workers)
        if prefetch is None:
            prefetch = _env.get_int("MXNET_PREFETCH_DEPTH")
        self._prefetch = max(0, prefetch if prefetch is not None
                             else 2 * self._num_workers)
        self._resume_from = 0

    def resume_from(self, batch_idx: int) -> None:
        """The next ``__iter__`` starts at batch ``batch_idx`` (0-based),
        building none before it; one-shot.  With ``shuffle=True`` the
        caller restores numpy's global generator first."""
        self._resume_from = max(0, int(batch_idx))

    def _make_batch(self, indices, seed):
        with _seeded(seed):
            return self._batchify_fn([self._dataset[i] for i in indices])

    def _epoch(self):
        """(start, batches from it, the epoch's seed)."""
        start, self._resume_from = self._resume_from, 0
        batches = list(self._batch_sampler)
        seed = int(np.random.randint(0, 2 ** 31 - 1))
        return start, batches, seed

    def __iter__(self):
        start, batches, seed = self._epoch()
        todo = [(i, batches[i], (seed + i) % 2 ** 32)
                for i in range(start, len(batches))]
        if self._num_workers == 0:
            return (self._make_batch(ind, s) for _, ind, s in todo)
        if self._worker_pool == "process":
            return self._process_iter(todo)
        return self._threaded_iter(todo)

    # ---- the spawn pool --------------------------------------------------
    def _get_pool(self):
        if self._pool is None:
            import multiprocessing as mp

            bfn = self._batchify_fn
            if bfn is default_batchify_fn:
                bfn = _numpy_batchify  # NDArrays are made in the parent
            self._pool = mp.get_context("spawn").Pool(
                self._num_workers, initializer=_mp_init,
                initargs=(self._dataset, bfn, self._worker_transport))
            # ended with the loader, or at exit while the interpreter is
            # whole
            self._finalizer = weakref.finalize(self, self._pool.terminate)
        return self._pool

    def _result_or_dead(self, res, pool, worker_pids):
        """``res.get`` in short waits that watch the children: a dead one
        raises :class:`WorkerDied` at once."""
        import multiprocessing as mp

        deadline = time.monotonic() + self._timeout
        while True:
            remaining = deadline - time.monotonic()
            try:
                return res.get(min(0.5, max(remaining, 0.01)))
            except mp.TimeoutError:
                current = {w.pid for w in pool._pool}
                dead = sorted((worker_pids - current)
                              | {w.pid for w in pool._pool
                                 if not w.is_alive()})
                if dead:
                    raise WorkerDied(
                        f"DataLoader worker process(es) {dead} died "
                        "abnormally; their batches are lost (the pool is "
                        "discarded: iterate again to go on)",
                        worker=dead[0]) from None
                if remaining <= 0:
                    raise MXNetError(f"DataLoader worker timed out after "
                                     f"{self._timeout}s") from None

    def _process_iter(self, todo):
        """Batches in sampler order over the persistent spawn pool; a
        child's exception re-raises here."""
        pool = self._get_pool()
        worker_pids = {w.pid for w in pool._pool}
        window = max(self._prefetch, self._num_workers, 2)
        pending: deque = deque()
        it = iter(todo)
        failed = died = False
        try:
            for _, ind, s in [next(it) for _ in range(min(window,
                                                          len(todo)))]:
                pending.append(pool.apply_async(_mp_make_batch, (ind, s)))
            while pending:
                res = pending.popleft()
                try:
                    out = self._result_or_dead(res, pool, worker_pids)
                except BaseException as e:
                    pending.appendleft(res)  # it may still bring a segment
                    failed = True
                    if isinstance(e, WorkerDied):
                        died = True
                        self._finalizer()  # terminates the pool
                        self._pool = None
                    raise
                nxt = next(it, None)
                if nxt is not None:
                    pending.append(pool.apply_async(_mp_make_batch,
                                                    (nxt[1], nxt[2])))
                yield self._wrap_np(out)
        finally:
            # an early break or the epoch's end waits out live batches;
            # after a failure the wait is capped (after a terminated pool
            # nothing more arrives)
            _drain_shm(pending, 2 if died else min(self._timeout, 15)
                       if failed else self._timeout)

    @staticmethod
    def _wrap_np(out):
        if isinstance(out, tuple):
            if len(out) == 3 and out[0] == "__shm__":
                return _shm_unpack(out[1], out[2])
            return tuple(DataLoader._wrap_np(o) for o in out)
        if isinstance(out, np.ndarray):
            return _cpu_array(out)
        return out

    # ---- the thread pool -------------------------------------------------
    def _threaded_iter(self, todo):
        """N worker threads take (position, indices, seed) from a queue
        and publish into a reorder buffer keyed by position, so batches
        come out in sampler order.  A thread that exits without
        publishing raises :class:`WorkerDied` here."""
        window = max(self._prefetch, self._num_workers, 2)
        task_q: "queue.Queue" = queue.Queue()
        done: dict = {}
        done_cv = threading.Condition()
        stop = threading.Event()

        def worker():
            while True:
                item = task_q.get()
                if item is None or stop.is_set():
                    return
                pos, ind, seed = item
                try:
                    result = ("ok", self._make_batch(ind, seed))
                except BaseException as e:
                    result = ("err", e)
                with done_cv:
                    done[pos] = result
                    done_cv.notify_all()

        n = len(todo)
        submitted = min(window, n)
        for pos in range(submitted):
            task_q.put((pos,) + tuple(todo[pos][1:]))
        threads = [threading.Thread(target=worker, daemon=True,
                                    name=f"mx-dataloader-worker-{i}")
                   for i in range(self._num_workers)]
        for t in threads:
            t.start()
        try:
            for pos in range(n):
                deadline = time.monotonic() + self._timeout
                with done_cv:
                    while pos not in done:
                        dead = [t.name for t in threads if not t.is_alive()]
                        if dead:
                            raise WorkerDied(
                                f"DataLoader worker thread(s) {dead} exited "
                                f"abnormally; batch {todo[pos][0]} will "
                                "never arrive", worker=dead[0])
                        remaining = deadline - time.monotonic()
                        if remaining <= 0:
                            raise MXNetError(
                                f"DataLoader worker timed out after "
                                f"{self._timeout}s (batch {todo[pos][0]})")
                        done_cv.wait(timeout=min(0.2, remaining))
                    kind, payload = done.pop(pos)
                if kind == "err":
                    raise payload
                if submitted < n:
                    task_q.put((submitted,) + tuple(todo[submitted][1:]))
                    submitted += 1
                yield payload
        finally:
            stop.set()
            for _ in threads:
                task_q.put(None)

    def __len__(self):
        return len(self._batch_sampler)
