"""Retry policy: jittered exponential backoff with a hard budget.

Counterpart of ``mxnet_tpu/resilience/retry.py``.  One policy object
serves every retryable call site; the port's site so far is serving
execute (``serving/batcher.py``); the collective, kvstore and checkpoint
sites come with the collectives' resilience (ROADMAP queue A item 10).
The contract:

  * only TRANSIENT errors retry.  An error is transient when its class
    carries ``transient = True`` (:class:`chaos.FaultInjected`, and any
    infra error a site marks), or when the site lists its class in
    ``retry_on``.  Everything else re-raises immediately: retrying a
    deterministic bug just triples its latency.
  * each retry bumps ``mx_retry_total{site}`` and every backoff sleep
    ``mx_retry_backoff_seconds_total{site}``.  (The JAX policy also
    hands the sleeps to mxgoodput and an exhaustion to mxblackbox; both
    wait for those packages.)
  * the budget is HARD.  After ``max_attempts`` attempts or once the
    next backoff would overrun ``budget_s`` (or the caller's deadline),
    :class:`RetryExhausted` is raised chained to the last error, with
    every attempt's error in the message.

Defaults come from the ``MXNET_RETRY_*`` knobs (util/env.py).  Jitter
seeding is the JAX package's, so one site and attempt give one delay in
both packages: under an active chaos plan it is the site name's crc32
(bit-identical replay); otherwise the pid is mixed in, so a fleet of
workers hitting the same fault does NOT retry in lockstep.
"""
from __future__ import annotations

import os
import random as _random
import time
import zlib
from dataclasses import dataclass, field
from typing import Callable, Optional, Tuple

from ..base import MXNetError

__all__ = ["RetryPolicy", "RetryExhausted", "default_policy",
           "is_transient"]


class RetryExhausted(MXNetError):
    """All attempts failed; carries the per-attempt error trail."""

    def __init__(self, site: str, errors):
        trail = "; ".join(f"attempt {i + 1}: {type(e).__name__}: {e}"
                          for i, e in enumerate(errors))
        super().__init__(
            f"retry budget exhausted at site '{site}' after "
            f"{len(errors)} attempt(s): {trail}")
        self.site = site
        self.attempts = len(errors)
        self.errors = list(errors)

    def __reduce__(self):
        # custom-arg __init__ needs an explicit recipe or unpickling
        # (e.g. out of a process-pool worker) raises TypeError
        return (RetryExhausted, (self.site, self.errors))


def is_transient(exc: BaseException,
                 retry_on: Tuple[type, ...] = ()) -> bool:
    """A site may retry `exc`: its class opted in (``transient=True``)
    or the site whitelisted the class."""
    return bool(getattr(exc, "transient", False)) or \
        (bool(retry_on) and isinstance(exc, retry_on))


@dataclass
class RetryPolicy:
    """max_attempts — total tries (1 = no retry).
    base_s/max_s/multiplier — exponential delay ladder, capped.
    jitter — ± fraction of the delay (0.5 = 50%), decorrelates a fleet
    retrying in lockstep.
    budget_s — wall-clock ceiling across ALL attempts incl. sleeps."""

    max_attempts: int = field(default=None)
    base_s: float = field(default=None)
    max_s: float = field(default=None)
    multiplier: float = 2.0
    jitter: float = 0.5
    budget_s: float = field(default=None)

    def __post_init__(self):
        from ..util import env

        if self.max_attempts is None:
            self.max_attempts = env.get_int("MXNET_RETRY_MAX_ATTEMPTS")
        if self.base_s is None:
            self.base_s = env.get_float("MXNET_RETRY_BASE_MS") / 1e3
        if self.max_s is None:
            self.max_s = env.get_float("MXNET_RETRY_MAX_MS") / 1e3
        if self.budget_s is None:
            self.budget_s = env.get_float("MXNET_RETRY_BUDGET_MS") / 1e3

    def delay_s(self, attempt: int, rng=None) -> float:
        """Backoff before attempt `attempt+1` (attempt is 1-based count
        of failures so far), jittered."""
        d = min(self.max_s,
                self.base_s * (self.multiplier ** (attempt - 1)))
        if self.jitter and rng is not None:
            d *= 1.0 + self.jitter * (2.0 * rng.random() - 1.0)
        return max(d, 0.0)

    def call(self, fn: Callable, site: str,
             deadline: Optional[float] = None,
             retry_on: Tuple[type, ...] = (),
             on_failure: Optional[Callable] = None):
        """Run ``fn()`` under this policy.  `deadline` is an absolute
        ``time.monotonic()`` instant no attempt may start after.
        `on_failure(exc)` runs on every failed attempt (circuit-breaker
        feedback) before the retry decision."""
        from ..telemetry import instruments as _ins
        from . import chaos as _chaos

        seed = zlib.crc32(site.encode())
        if not _chaos._ACTIVE:
            # decorrelate the fleet: without this every process would
            # sleep the identical "jittered" ladder.  Chaos runs keep
            # the pure site seed for bit-identical replay.
            seed ^= os.getpid()
        rng = _random.Random(seed)
        start = time.monotonic()
        errors = []
        attempt = 0
        while True:
            attempt += 1
            try:
                return fn()
            except BaseException as e:  # noqa: BLE001 — classified below
                if on_failure is not None:
                    on_failure(e)
                errors.append(e)
                if not is_transient(e, retry_on):
                    raise
                if attempt >= self.max_attempts:
                    raise RetryExhausted(site, errors) from e
                delay = self.delay_s(attempt, rng)
                now = time.monotonic()
                over_budget = (now - start) + delay > self.budget_s
                past_deadline = deadline is not None and \
                    now + delay >= deadline
                if over_budget or past_deadline:
                    raise RetryExhausted(site, errors) from e
                _ins.retry_total(site).inc()
                # the sleep is real wall-clock: measure it always (the
                # counter is free)
                t_sleep = time.monotonic()
                time.sleep(delay)
                slept = time.monotonic() - t_sleep
                _ins.retry_backoff_seconds_total(site).inc(slept)


_DEFAULT = None


def default_policy() -> RetryPolicy:
    """The process-wide env-configured policy (constructed lazily so
    the knobs are read once)."""
    global _DEFAULT
    if _DEFAULT is None:
        _DEFAULT = RetryPolicy()
    return _DEFAULT
