"""mxnet_tpu_torch.resilience — the fault layer serving runs on.

Counterpart of ``mxnet_tpu/resilience``, the part serving needs:

  * :mod:`~mxnet_tpu_torch.resilience.chaos` — deterministic fault
    injection behind a zero-overhead flag (``with
    chaos.inject("serving.execute", at=2): ...``), wired into the
    serving repository's artifact import and executor;
  * :mod:`~mxnet_tpu_torch.resilience.retry` — ONE jittered-exponential-
    backoff policy (budget-capped, ``mx_retry_total{site}``-counted),
    applied at serving execute; transient errors retry, everything else
    fails fast;
  * :mod:`~mxnet_tpu_torch.resilience.breaker` — the per-model circuit
    breaker serving uses to degrade (503 one model) instead of dying.

The JAX package's ``elastic``, ``heartbeat``, ``preemption`` and
``autockpt`` come with the collectives' resilience (ROADMAP queue A item
10).
"""
from __future__ import annotations

from . import chaos
from .breaker import CircuitBreaker
from .chaos import FaultInjected
from .retry import RetryExhausted, RetryPolicy, default_policy

__all__ = ["chaos", "FaultInjected", "CircuitBreaker", "RetryPolicy",
           "RetryExhausted", "default_policy"]

# env-driven activation (MXNET_CHAOS=1 + MXNET_CHAOS_SPEC) happens at
# first import so subprocess experiments need no code changes in the
# script under test
chaos._init_from_env()
