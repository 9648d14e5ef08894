"""DynamicBatcher: coalesce concurrent requests into padded, bucketed
batches (counterpart of ``mxnet_tpu/serving/batcher.py``).

One batcher per (model, version), one background thread each.  Requests
of the same group — identical non-batch input shapes and dtypes — are
concatenated along dim 0, padded with zero rows up to the next bucket,
moved to the model's device and run in one launch; the outputs are
sliced back per request.  A batch launches when it is full or when its
oldest request has waited `batch_timeout_ms`; expired deadlines fail
with DeadlineExceeded before launch, never silently dropped.
"""
from __future__ import annotations

import threading
import time
from collections import OrderedDict, deque
from concurrent.futures import Future
from typing import List, Optional

import torch

from . import DeadlineExceeded, ServerClosed, ServingConfig, ServingError

__all__ = ["DynamicBatcher"]


def _dtype_name(dt) -> str:
    return str(dt).replace("torch.", "")


class _Request:
    __slots__ = ("xs", "rows", "future", "deadline", "enq")

    def __init__(self, xs, rows, deadline):
        self.xs, self.rows = xs, rows
        self.deadline = deadline
        self.future: Future = Future()
        self.enq = time.monotonic()


class DynamicBatcher:
    """Background-thread batcher over one repository entry."""

    def __init__(self, entry, config: Optional[ServingConfig] = None):
        self._entry = entry
        self._config = config or ServingConfig()
        self._buckets = entry.allowed_buckets(self._config.ladder())
        self._max_rows = min(self._config.max_batch_size, self._buckets[-1])
        self._timeout_s = self._config.batch_timeout_ms / 1e3
        self._specs = entry.input_specs()
        self._cv = threading.Condition()
        self._groups: "OrderedDict[tuple, deque]" = OrderedDict()
        self._closing = False
        self._thread = threading.Thread(
            target=self._loop, daemon=True,
            name=f"mx-batcher-{entry.name}-v{entry.version}")
        self._thread.start()

    # ---- submission ---------------------------------------------------

    def submit(self, inputs, deadline: Optional[float] = None) -> Future:
        """Enqueue one request (inputs carry their own leading batch dim);
        returns a Future of the model's outputs (tensors on the model's
        device)."""
        xs, rows = self._validate(inputs)
        req = _Request(xs, rows, deadline)
        key = tuple((str(v.dtype), tuple(v.shape[1:])) for v in xs)
        with self._cv:
            if self._closing:
                raise ServerClosed(
                    f"model {self._entry.name!r}: server is shutting "
                    f"down, not accepting new requests")
            self._groups.setdefault(key, deque()).append(req)
            self._cv.notify()
        return req.future

    def _validate(self, inputs):
        specs = self._specs
        if len(inputs) != len(specs):
            raise ServingError(f"model {self._entry.name!r} takes "
                               f"{len(specs)} inputs, got {len(inputs)}")
        xs, rows = [], None
        for x, w in zip(inputs, specs):
            v = x if isinstance(x, torch.Tensor) else torch.as_tensor(x)
            want, got = w["shape"], list(v.shape)
            if _dtype_name(v.dtype) != w["dtype"]:
                raise ServingError(f"input dtype {_dtype_name(v.dtype)} != "
                                   f"exported {w['dtype']}")
            if len(got) != len(want) or got[1:] != want[1:]:
                raise ServingError(f"input shape {got} != exported {want} "
                                   f"(dim 0 = rows; other dims are fixed)")
            if rows is not None and got[0] != rows:
                raise ServingError(f"all inputs must share the row count, "
                                   f"got {rows} and {got[0]}")
            rows = got[0]
            xs.append(v)
        if rows < 1:
            raise ServingError("request must carry at least one row")
        if rows > self._max_rows:
            raise ServingError(f"request rows {rows} > max_batch_size "
                               f"{self._max_rows}; split the request")
        return xs, rows

    # ---- batching loop ------------------------------------------------

    def _loop(self):
        while True:
            with self._cv:
                while not self._groups and not self._closing:
                    self._cv.wait()
                if self._closing and not self._groups:
                    return
                now = time.monotonic()
                expired = self._pop_expired_locked(now)
                batch = self._take_due_locked(now)
                if batch is None and not expired:
                    wake = self._next_event_locked()
                    if wake is not None:
                        self._cv.wait(timeout=max(wake - now, 1e-4))
            for r in expired:
                try:
                    r.future.set_exception(DeadlineExceeded(
                        f"model {self._entry.name!r}: deadline expired "
                        f"after {(time.monotonic() - r.enq) * 1e3:.1f}ms "
                        f"in queue"))
                except Exception:
                    continue  # beaten by a concurrent Future.cancel()
                self._entry.metrics.bump("deadline_expired")
            if batch is not None:
                self._run_batch(*batch)

    def _pop_expired_locked(self, now) -> List[_Request]:
        out: List[_Request] = []
        for key in list(self._groups):
            q = self._groups[key]
            alive = deque(r for r in q
                          if r.deadline is None or r.deadline > now)
            out.extend(r for r in q
                       if r.deadline is not None and r.deadline <= now)
            if alive:
                self._groups[key] = alive
            else:
                del self._groups[key]
        return out

    def _take_due_locked(self, now):
        for key in list(self._groups):
            q = self._groups[key]
            full = sum(r.rows for r in q) >= self._max_rows
            timed_out = (now - q[0].enq) >= self._timeout_s
            if not (full or timed_out or self._closing):
                continue
            take, taken_rows = [], 0
            while q and taken_rows + q[0].rows <= self._max_rows:
                r = q.popleft()
                # False: the client cancelled while queued
                if not r.future.set_running_or_notify_cancel():
                    continue
                take.append(r)
                taken_rows += r.rows
            if not q:
                del self._groups[key]
            if take:
                return take, taken_rows
        return None

    def _next_event_locked(self) -> Optional[float]:
        t = None
        for q in self._groups.values():
            cand = q[0].enq + self._timeout_s
            t = cand if t is None else min(t, cand)
            for r in q:
                if r.deadline is not None:
                    t = min(t, r.deadline)
        return t

    def _run_batch(self, reqs: List[_Request], rows: int):
        entry = self._entry
        m = entry.metrics
        try:
            bucket = next(b for b in self._buckets if b >= rows)
            xs = []
            for i in range(len(self._specs)):
                v = torch.cat([r.xs[i] for r in reqs], dim=0)
                if bucket > rows:
                    pad = v.new_zeros((bucket - rows,) + tuple(v.shape[1:]))
                    v = torch.cat([v, pad], dim=0)
                xs.append(v)
            leaves = entry.execute(bucket, xs)
            m.bump("batches")
            m.bump("batched_rows", rows)
            m.bump("padded_rows", bucket)
            off = 0
            for r in reqs:
                cut = [o[off:off + r.rows] for o in leaves]
                off += r.rows
                r.future.set_result(entry.served.decode_outputs(cut))
        except Exception as e:  # noqa: BLE001 — delivered to every request
            for r in reqs:
                if not r.future.done():
                    m.bump("failed")
                    r.future.set_exception(e)

    # ---- lifecycle ----------------------------------------------------

    def close(self, drain: bool = True,
              timeout: Optional[float] = None) -> None:
        """Stop admission.  drain=True completes everything queued;
        drain=False fails queued requests with ServerClosed.  `timeout`
        is a hard drain deadline: past it every request still queued
        fails with ServerClosed and close() returns."""
        with self._cv:
            self._closing = True
            dropped: List[_Request] = []
            if not drain:
                for q in self._groups.values():
                    dropped.extend(q)
                self._groups.clear()
            self._cv.notify_all()
        self._fail_requests(dropped, "server shut down before this "
                            "request ran")
        self._thread.join(timeout)
        if self._thread.is_alive() and drain:
            with self._cv:
                stuck: List[_Request] = []
                for q in self._groups.values():
                    stuck.extend(q)
                self._groups.clear()
                self._cv.notify_all()
            self._entry.metrics.bump("drain_timeouts")
            self._fail_requests(
                stuck, f"drain deadline ({timeout:.1f}s) expired with a "
                f"batch still executing; this queued request was "
                f"abandoned")

    def _fail_requests(self, reqs: List[_Request], why: str) -> None:
        for r in reqs:
            try:
                r.future.set_exception(ServerClosed(
                    f"model {self._entry.name!r}: {why}"))
            except Exception:
                pass  # already done or concurrently cancelled
