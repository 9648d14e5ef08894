"""InferenceServer: bounded admission + per-model batchers + metrics
(counterpart of ``mxnet_tpu/serving/server.py``).

The server owns one DynamicBatcher per (model, version) it has seen
traffic for, and an admission bound over everything accepted but not
yet completed: at `max_queue` the next submit fails fast with
ServerOverloaded (HTTP 503 semantics).  A request may carry
`timeout_ms`; if it expires while queued the caller gets
DeadlineExceeded.  `shutdown(drain=True)`
stops admission, lets accepted requests finish within a hard deadline,
then stops the batcher threads; `drain=False` fails queued requests with
ServerClosed.
"""
from __future__ import annotations

import threading
import time
from concurrent.futures import Future
from typing import Dict, Optional

from ..util import env
from . import ServerClosed, ServerOverloaded, ServingConfig
from .batcher import DynamicBatcher
from .repository import ModelRepository

__all__ = ["InferenceServer"]


class InferenceServer:
    def __init__(self, repository: ModelRepository,
                 config: Optional[ServingConfig] = None):
        self.repository = repository
        self.config = config or ServingConfig()
        self._lock = threading.Lock()
        self._batchers: Dict[tuple, DynamicBatcher] = {}
        self._pending = 0
        self._pending_per: Dict[tuple, int] = {}
        self._closed = False

    # ---- request path -------------------------------------------------

    def _admit_locked(self, m) -> None:
        if self._closed:
            raise ServerClosed("server is shut down")
        if self._pending >= self.config.max_queue:
            m.bump("rejected")
            raise ServerOverloaded(
                f"admission queue full ({self._pending} pending >= "
                f"max_queue {self.config.max_queue}); retry with backoff")

    def submit(self, model: str, inputs, version: Optional[int] = None,
               timeout_ms: Optional[float] = None) -> Future:
        """Admit one request; returns a Future of the model's outputs."""
        entry = self.repository.get(model, version)
        m = entry.metrics
        key = (entry.name, entry.version)
        with self._lock:
            self._admit_locked(m)
            self._pending += 1
            self._pending_per[key] = self._pending_per.get(key, 0) + 1
            m.bump("requests")
            m.gauge("queue_depth", self._pending_per[key])
        released = []

        def _release():
            with self._lock:
                if released:
                    return
                released.append(True)
                self._pending -= 1
                self._pending_per[key] -= 1
                m.gauge("queue_depth", self._pending_per[key])

        t0 = time.monotonic()
        deadline = None if timeout_ms is None else t0 + timeout_ms / 1e3

        def _done(f: Future):
            _release()
            if f.cancelled() or f.exception() is not None:
                return  # failures are counted at the batcher
            m.bump("completed")
            m.observe_latency(time.monotonic() - t0)

        try:
            entry.served  # lazy import, outside every server lock
            with self._lock:
                if self._closed:
                    raise ServerClosed("server is shut down")
                batcher = self._batchers.get(key)
                if batcher is None:
                    batcher = DynamicBatcher(entry, self.config)
                    self._batchers[key] = batcher
            fut = batcher.submit(inputs, deadline=deadline)
            fut.add_done_callback(_done)
        except BaseException:
            _release()  # admitted but never enqueued: free the slot
            raise
        return fut

    def infer(self, model: str, inputs, version: Optional[int] = None,
              timeout_ms: Optional[float] = None):
        """Blocking single call (submit + result)."""
        return self.submit(model, inputs, version=version,
                           timeout_ms=timeout_ms).result()

    # ---- observability ------------------------------------------------

    def metrics(self) -> dict:
        """Admission state and every model's metrics snapshot (JSON-able)."""
        with self._lock:
            state = {"pending": self._pending,
                     "max_queue": self.config.max_queue,
                     "closed": self._closed}
        state["models"] = [e.metrics.snapshot()
                           for e in self.repository.entries()]
        return state

    # ---- lifecycle ----------------------------------------------------

    def shutdown(self, drain: bool = True,
                 timeout: Optional[float] = None) -> None:
        """Stop admission now; drain=True completes accepted work within
        `timeout` seconds, else the MXNET_DRAIN_TIMEOUT_MS knob (shared
        across batchers)."""
        if timeout is None:
            timeout = env.get_float("MXNET_DRAIN_TIMEOUT_MS") / 1e3
        deadline = time.monotonic() + timeout
        with self._lock:
            self._closed = True
            batchers = list(self._batchers.values())
        for b in batchers:
            b.close(drain=drain,
                    timeout=max(deadline - time.monotonic(), 0.0))

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.shutdown(drain=True)
        return False
