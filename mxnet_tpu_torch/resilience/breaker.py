"""Per-model circuit breaker: degrade, don't die.

Counterpart of ``mxnet_tpu/resilience/breaker.py``, the same state
machine and instruments.

A model whose executor keeps failing (poisoned artifact, OOM loop,
driver wedge) must cost its own 503s — not take the process, and with
it every healthy model, down with it.  Standard three-state breaker:

    CLOSED     normal; consecutive failures are counted, any success
               resets the count.
    OPEN       after `threshold` consecutive failures; `allow()` is
               False (submit answers 503 ModelUnavailable without
               touching the executor) until `cooldown_s` elapses.
    HALF_OPEN  one probe request is let through after the cooldown;
               success closes the breaker, failure re-opens it (fresh
               cooldown).

Feedback comes from the batcher's launch path (`record_success` /
`record_failure` around the executor), the gate from the server's
submit path (`allow()`), so queued requests behind a trip still fail
fast.  State transitions bump ``mx_breaker_state{model,version}``
(0 closed / 1 half-open / 2 open) and ``mx_breaker_open_total``.
"""
from __future__ import annotations

import threading
import time
from typing import Optional

__all__ = ["CircuitBreaker", "CLOSED", "OPEN", "HALF_OPEN"]

CLOSED, HALF_OPEN, OPEN = "closed", "half-open", "open"
_STATE_CODE = {CLOSED: 0, HALF_OPEN: 1, OPEN: 2}


class CircuitBreaker:
    def __init__(self, name: str = "", version=0,
                 threshold: Optional[int] = None,
                 cooldown_s: Optional[float] = None):
        from ..util import env

        self._name, self._version = name, version
        self._threshold = threshold if threshold is not None \
            else env.get_int("MXNET_BREAKER_THRESHOLD")
        self._cooldown_s = cooldown_s if cooldown_s is not None \
            else env.get_float("MXNET_BREAKER_COOLDOWN_MS") / 1e3
        self._lock = threading.Lock()
        self._state = CLOSED
        self._failures = 0          # consecutive, in CLOSED
        self._opened_at = 0.0
        self._probe_out = False     # a HALF_OPEN probe is in flight
        self._probe_at = 0.0        # when it was granted (staleness)

    def configure(self, threshold: Optional[int] = None,
                  cooldown_s: Optional[float] = None) -> None:
        """Late override (ServingConfig beats the env default)."""
        with self._lock:
            if threshold is not None:
                self._threshold = int(threshold)
            if cooldown_s is not None:
                self._cooldown_s = float(cooldown_s)

    # ---- gate ----------------------------------------------------------

    def allow(self) -> bool:
        """May a request proceed right now?  OPEN past its cooldown
        transitions to HALF_OPEN and admits exactly ONE probe; further
        requests stay rejected until the probe resolves.  CONSUMES the
        probe slot — the authoritative submit-path gate.  A probe that
        never resolves (its request died before the executor) goes
        stale after cooldown+30s so the breaker cannot wedge."""
        with self._lock:
            if self._state == CLOSED:
                return True
            now = time.monotonic()
            if self._state == OPEN:
                if now - self._opened_at < self._cooldown_s:
                    return False
                self._set_state_locked(HALF_OPEN)
                self._probe_out = True
                self._probe_at = now
                return True
            # HALF_OPEN: one probe at a time
            if self._probe_out and \
                    now - self._probe_at < self._cooldown_s + 30.0:
                return False
            self._probe_out = True
            self._probe_at = now
            return True

    def would_allow(self) -> bool:
        """Advisory, NON-consuming twin of :meth:`allow` (front-end
        fail-fast checks must not burn the half-open probe slot)."""
        with self._lock:
            if self._state == CLOSED:
                return True
            now = time.monotonic()
            if self._state == OPEN:
                return now - self._opened_at >= self._cooldown_s
            return not self._probe_out or \
                now - self._probe_at >= self._cooldown_s + 30.0

    def abandon_probe(self) -> None:
        """The granted probe request died before reaching the executor
        (admission raced shutdown, artifact import failed, client
        cancelled): free the slot so the next request can probe."""
        with self._lock:
            if self._state == HALF_OPEN:
                self._probe_out = False

    # ---- feedback ------------------------------------------------------

    def record_success(self) -> None:
        with self._lock:
            self._failures = 0
            self._probe_out = False
            if self._state != CLOSED:
                self._set_state_locked(CLOSED)

    def record_failure(self) -> None:
        with self._lock:
            if self._state == HALF_OPEN:
                # the probe failed: back to OPEN, fresh cooldown
                self._probe_out = False
                self._trip_locked()
                return
            if self._state == OPEN:
                return  # in-flight stragglers from before the trip
            self._failures += 1
            if self._failures >= self._threshold:
                self._trip_locked()

    # ---- introspection -------------------------------------------------

    def state(self) -> str:
        with self._lock:
            return self._state

    def snapshot(self) -> dict:
        with self._lock:
            return {"state": self._state,
                    "consecutive_failures": self._failures,
                    "threshold": self._threshold,
                    "cooldown_s": self._cooldown_s}

    # ---- internals (caller holds self._lock) ---------------------------

    def _trip_locked(self) -> None:
        self._failures = 0
        self._opened_at = time.monotonic()
        self._set_state_locked(OPEN)
        from ..telemetry import instruments as _ins

        _ins.breaker_open_total(self._name, self._version).inc()

    def _set_state_locked(self, state: str) -> None:
        self._state = state
        from ..telemetry import instruments as _ins

        _ins.breaker_state(self._name, self._version).set(
            _STATE_CODE[state])
