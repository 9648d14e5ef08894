"""DynamicBatcher: coalesce concurrent requests into padded, bucketed
batches (counterpart of ``mxnet_tpu/serving/batcher.py``).

One batcher per (model, version), one background thread each.  Requests
of the same *group* — identical seed, identical non-batch input shapes
and dtypes — are concatenated along dim 0, padded with zero rows up to
the next bucket, moved to the model's device and run in one launch; the
outputs are sliced back per request.  A batch launches when it is full
or when its oldest request has waited `batch_timeout_ms`; expired
deadlines fail with DeadlineExceeded before launch, never silently
dropped.

The launch runs under the resilience stack: every attempt feeds the
entry's circuit breaker, and a TRANSIENT failure retries under the
retry policy while the batch's earliest deadline allows.

Stochastic caveat (as in the JAX package): the per-launch seed is shared
by every row of a coalesced batch, so a forward that draws from it sees
draws that depend on the row's offset and bucket; requests with
different seeds never share a launch.
"""
from __future__ import annotations

import threading
import time
from collections import OrderedDict, deque
from concurrent.futures import Future
from typing import List, Optional

import torch

from .. import profiler as _prof
from ..resilience import retry as _retry
from ..telemetry import instruments as _ins
from ..telemetry import tracing as _tracing
from . import DeadlineExceeded, ServerClosed, ServingConfig, ServingError

__all__ = ["DynamicBatcher"]


def _dtype_name(dt) -> str:
    return str(dt).replace("torch.", "")


class _Request:
    __slots__ = ("xs", "rows", "seed", "future", "deadline", "enq",
                 "enq_pc", "trace")

    def __init__(self, xs, rows, seed, deadline, trace=None):
        self.xs, self.rows, self.seed = xs, rows, seed
        self.deadline = deadline
        self.future: Future = Future()
        self.enq = time.monotonic()
        # perf_counter twin of enq: span timestamps share the profiler's
        # clock, monotonic stays the deadline clock
        self.enq_pc = time.perf_counter()
        self.trace = trace  # (trace_id, admission_span_id) or None


class DynamicBatcher:
    """Background-thread batcher over one repository entry."""

    def __init__(self, entry, config: Optional[ServingConfig] = None):
        self._entry = entry
        self._config = config or ServingConfig()
        self._buckets = entry.allowed_buckets(self._config.ladder())
        self._max_rows = min(self._config.max_batch_size, self._buckets[-1])
        self._timeout_s = self._config.batch_timeout_ms / 1e3
        self._specs = entry.input_specs()
        # transient executor failures retry (deadline-aware) under this
        # policy; ServingConfig.execute_retries overrides the env knob
        self._retry_policy = _retry.RetryPolicy(
            max_attempts=self._config.execute_retries) \
            if self._config.execute_retries is not None \
            else _retry.default_policy()
        self._cv = threading.Condition()
        # group key -> FIFO of requests (OrderedDict: oldest group first)
        self._groups: "OrderedDict[tuple, deque]" = OrderedDict()
        self._closing = False
        self._thread = threading.Thread(
            target=self._loop, daemon=True,
            name=f"mx-batcher-{entry.name}-v{entry.version}")
        self._thread.start()

    # ---- submission ---------------------------------------------------

    def submit(self, inputs, seed: int = 0,
               deadline: Optional[float] = None, trace=None) -> Future:
        """Enqueue one request (inputs carry their own leading batch dim);
        returns a Future of the model's outputs (tensors on the model's
        device).  `trace` is the request's (trace_id, admission_span_id)
        pair — queue-wait/execute spans on the batcher thread link back
        to it."""
        xs, rows = self._validate(inputs)
        req = _Request(xs, rows, int(seed), deadline, trace=trace)
        key = self._group_key(xs, req.seed)
        with self._cv:
            if self._closing:
                raise ServerClosed(
                    f"model {self._entry.name!r}: server is shutting "
                    f"down, not accepting new requests")
            self._groups.setdefault(key, deque()).append(req)
            if trace is not None:
                # flow arrow emitted BEFORE the batcher thread can wake
                # and emit the matching flow_end
                _tracing.flow_start(trace[0])
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

    @staticmethod
    def _group_key(xs, seed):
        """Requests share a launch only with the same seed (one per
        launch) and the same non-batch shapes and dtypes."""
        return (("seed", seed),) + tuple(
            ("b", str(v.dtype), tuple(v.shape[1:])) for v in xs)

    # ---- batching loop ------------------------------------------------

    def _loop(self):
        while True:
            # dropped before the wait: the last batch's requests (their
            # futures hold the outputs, on the card) must not outlive it
            expired: List[_Request] = []
            batch = None
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
        """Earliest future instant the loop must act on: a group's
        flush-due time or a request deadline."""
        t = None
        for q in self._groups.values():
            cand = q[0].enq + self._timeout_s
            t = cand if t is None else min(t, cand)
            for r in q:
                if r.deadline is not None:
                    t = min(t, r.deadline)
        return t

    def _trace_batch_start(self, reqs: List[_Request], rows: int):
        """Emit per-request queue-wait spans + flow ends, and open the
        batch-assembly span (on the first traced request's trace id; its
        `traces` arg lists every member).  Spans exist only during a
        profiler capture."""
        if not _prof._running:
            return None
        now = time.perf_counter()
        primary = None
        member_traces = []
        for r in reqs:
            if r.trace is None:
                continue
            member_traces.append(r.trace[0])
            if primary is None:
                primary = r.trace
            _tracing.record_complete(
                "queue-wait", "serving", r.enq_pc, now - r.enq_pc,
                trace_id=r.trace[0], parent_id=r.trace[1])
            _tracing.flow_end(r.trace[0])
        return _tracing.Span(
            "batch-assembly", "serving",
            trace_id=primary[0] if primary else None,
            parent_id=primary[1] if primary else None,
            args={"rows": rows, "traces": member_traces})

    @staticmethod
    def _next_span(phase, name, args=None):
        tr, par = phase.trace_id, phase.parent_id
        phase.finish()
        return _tracing.Span(name, "serving", trace_id=tr, parent_id=par,
                             args=args)

    def _run_batch(self, reqs: List[_Request], rows: int):
        entry = self._entry
        m = entry.metrics
        phase = self._trace_batch_start(reqs, rows)
        try:
            bucket = next(b for b in self._buckets if b >= rows)
            xs = []
            for i in range(len(self._specs)):
                v = torch.cat([r.xs[i] for r in reqs], dim=0)
                if bucket > rows:
                    pad = v.new_zeros((bucket - rows,) + tuple(v.shape[1:]))
                    v = torch.cat([v, pad], dim=0)
                xs.append(v)
            if phase is not None:
                phase = self._next_span(phase, "execute", {"bucket": bucket})
            leaves = self._execute_resilient(bucket, xs, reqs)
            m.bump("batches")
            m.bump("batched_rows", rows)
            m.bump("padded_rows", bucket)
            _ins.serving_occupancy(entry.name, entry.version).set(
                rows / bucket)
            if phase is not None:
                phase = self._next_span(phase, "respond")
            served = entry.served
            off = 0
            for r in reqs:
                cut = [o[off:off + r.rows] for o in leaves]
                off += r.rows
                r.future.set_result(served.decode_outputs(cut))
        except Exception as e:  # noqa: BLE001 — delivered to every request
            for r in reqs:
                if not r.future.done():
                    m.bump("failed")
                    r.future.set_exception(e)
        finally:
            if phase is not None:
                phase.finish()

    def _execute_resilient(self, bucket: int, xs, reqs: List[_Request]):
        """The executor launch under the resilience stack: every
        attempt's outcome feeds the entry's circuit breaker (that's how
        consecutive failures trip it), and a TRANSIENT failure retries
        with backoff while the batch's earliest request deadline allows.
        Non-transient errors fail immediately; the breaker counts them
        all the same."""
        entry = self._entry

        def attempt():
            leaves = entry.execute(bucket, xs, seed=reqs[0].seed)
            entry.breaker.record_success()
            return leaves

        deadline = min((r.deadline for r in reqs
                        if r.deadline is not None), default=None)
        try:
            return self._retry_policy.call(
                attempt, site="serving.execute", deadline=deadline,
                on_failure=lambda e: entry.breaker.record_failure())
        except _retry.RetryExhausted:
            entry.metrics.bump("retries_exhausted")
            raise

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
