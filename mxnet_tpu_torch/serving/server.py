"""InferenceServer: bounded admission + per-model batchers + metrics
(counterpart of ``mxnet_tpu/serving/server.py``).

The server owns one DynamicBatcher per (model, version) it has seen
traffic for, and an admission bound over everything accepted but not
yet completed: at `max_queue` the next submit fails fast with
ServerOverloaded (HTTP 503 semantics).  A model whose circuit breaker is
open answers ModelUnavailable (503 for that model only).  A request may
carry `timeout_ms` (or inherit `config.default_timeout_ms`); if it
expires while queued the caller gets DeadlineExceeded.

Shutdown: `shutdown(drain=True)` stops admission, lets accepted requests
finish within a hard deadline, then stops the batcher threads;
`drain=False` fails queued requests with ServerClosed.
"""
from __future__ import annotations

import json
import threading
import time
from concurrent.futures import Future
from typing import Dict, Optional

from .. import profiler as _prof
from ..telemetry import tracing as _tracing
from ..util import env
from . import (ModelUnavailable, ServerClosed, ServerOverloaded,
               ServingConfig)
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
        # entries whose breaker already took this config's overrides
        self._breaker_configured: set = set()

    # ---- request path -------------------------------------------------

    def _admit_locked(self, m) -> None:
        """Raise the 503-class error a submit would get right now.
        Caller holds self._lock; touches nothing on the (possibly cold)
        artifact."""
        if self._closed:
            raise ServerClosed("server is shut down")
        if self._pending >= self.config.max_queue:
            if m is not None:
                m.bump("rejected")
            raise ServerOverloaded(
                f"admission queue full ({self._pending} pending >= "
                f"max_queue {self.config.max_queue}); retry with backoff")

    def _breaker_gate(self, entry, consume: bool) -> None:
        """Raise ModelUnavailable (503 this model, nothing else) while
        the entry's circuit breaker refuses traffic.  `consume=True`
        (the submit path) takes the half-open probe slot; the advisory
        front-end check must not.  Config overrides land lazily — the
        breaker exists before any batcher does."""
        cfg = self.config
        if cfg.breaker_threshold is not None \
                or cfg.breaker_cooldown_ms is not None:
            key = (entry.name, entry.version)
            with self._lock:
                needs_cfg = key not in self._breaker_configured
                if needs_cfg:
                    self._breaker_configured.add(key)
            if needs_cfg:
                entry.breaker.configure(
                    threshold=cfg.breaker_threshold,
                    cooldown_s=None if cfg.breaker_cooldown_ms is None
                    else cfg.breaker_cooldown_ms / 1e3)
        ok = entry.breaker.allow() if consume \
            else entry.breaker.would_allow()
        if not ok:
            entry.metrics.bump("breaker_rejected")
            raise ModelUnavailable(
                f"model {entry.name!r} v{entry.version} is unavailable: "
                f"circuit breaker is {entry.breaker.state()} after "
                f"repeated executor failures; retry after the cooldown "
                f"(the server itself is healthy)")

    def check_admission(self, entry=None) -> None:
        """Cheap advisory fail-fast for front ends: raises
        ServerClosed/ServerOverloaded/ModelUnavailable exactly as
        submit() would, WITHOUT importing the artifact, so load shedding
        stays cheap for cold models; submit() still re-checks."""
        with self._lock:
            self._admit_locked(entry.metrics if entry is not None
                               else None)
        if entry is not None:
            self._breaker_gate(entry, consume=False)

    def submit(self, model: str, inputs, version: Optional[int] = None,
               seed: int = 0,
               timeout_ms: Optional[float] = None) -> Future:
        """Admit one request; returns a Future of the model's outputs.
        Raises ServerOverloaded when the admission queue is full,
        ModelUnavailable while the model's breaker is open and
        ServerClosed after shutdown begins."""
        entry = self.repository.get(model, version)
        m = entry.metrics
        key = (entry.name, entry.version)
        # breaker first: an OPEN model's 503 must not consume an
        # admission slot, and a half-open probe is granted HERE
        self._breaker_gate(entry, consume=True)
        # a fresh trace root per request; spans record only during a
        # capture, so scrape-only telemetry pays no per-request spans
        adm = None
        if _prof._running:
            adm = _tracing.Span(
                "admission", "serving", root=True,
                args={"model": entry.name, "version": entry.version})
        try:
            with self._lock:
                self._admit_locked(m)
                self._pending += 1
                self._pending_per[key] = self._pending_per.get(key, 0) + 1
                m.bump("requests")
                m.gauge("queue_depth", self._pending_per[key])
        except BaseException:
            entry.breaker.abandon_probe()  # never reached the executor
            if adm is not None:
                adm.finish()
            raise
        # rollover pin: this request finishes on THIS entry even if a
        # version swap retires it mid-flight
        entry.begin_use()
        released = []

        def _release():
            with self._lock:
                if released:
                    return
                released.append(True)
                self._pending -= 1
                self._pending_per[key] -= 1
                m.gauge("queue_depth", self._pending_per[key])
            entry.end_use()  # outside self._lock (entry has its own)

        t0 = time.monotonic()
        if timeout_ms is None:
            timeout_ms = self.config.default_timeout_ms
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
                # re-checked: a batcher born after shutdown's snapshot
                # would never be closed
                if self._closed:
                    raise ServerClosed("server is shut down")
                batcher = self._batchers.get(key)
                if batcher is None:
                    batcher = DynamicBatcher(entry, self.config)
                    self._batchers[key] = batcher
            fut = batcher.submit(
                inputs, seed=seed, deadline=deadline,
                trace=(adm.trace_id, adm.span_id)
                if adm is not None else None)
            fut.add_done_callback(_done)
        except BaseException:
            _release()  # admitted but never enqueued: free the slot
            entry.breaker.abandon_probe()
            raise
        finally:
            if adm is not None:
                adm.finish()
        fut.trace_id = adm.trace_id if adm is not None else None
        return fut

    def infer(self, model: str, inputs, version: Optional[int] = None,
              seed: int = 0, timeout_ms: Optional[float] = None):
        """Blocking single call (submit + result)."""
        return self.submit(model, inputs, version=version, seed=seed,
                           timeout_ms=timeout_ms).result()

    # ---- observability ------------------------------------------------

    def pending(self) -> int:
        with self._lock:
            return self._pending

    @property
    def draining(self) -> bool:
        """True once shutdown has begun — the /healthz drain signal."""
        with self._lock:
            return self._closed

    def metrics(self) -> dict:
        """Admission state and every model's metrics snapshot (JSON-able)."""
        with self._lock:
            state = {"pending": self._pending,
                     "max_queue": self.config.max_queue,
                     "closed": self._closed}
        state["models"] = [e.metrics.snapshot()
                           for e in self.repository.entries()]
        return state

    def dumps(self, indent: Optional[int] = 1) -> str:
        """JSON metrics snapshot (profiler.dumps analogue)."""
        return json.dumps(self.metrics(), indent=indent)

    # ---- lifecycle ----------------------------------------------------

    def shutdown(self, drain: bool = True,
                 timeout: Optional[float] = None) -> None:
        """Stop admission now; drain=True completes accepted work within
        a hard deadline shared across batchers: `timeout`, else
        config.drain_timeout_s, else the MXNET_DRAIN_TIMEOUT_MS knob.
        Past it every still-queued request fails with ServerClosed."""
        if timeout is None:
            timeout = self.config.drain_timeout_s
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
