"""mxnet_tpu_torch.serving — dynamic-batching inference serving on top of
the deploy artifacts (``contrib/deploy.py``).

Counterpart of ``mxnet_tpu/serving``:

  * `ModelRepository` — loads/versions deploy artifacts lazily, keeps a
    per-bucket executor cache with hit/miss counters (a bucket's
    executor is the served model's forward, one CUDA graph per bucket on
    the card), and swaps versions without downtime (`rollover`);
  * `DynamicBatcher` — coalesces concurrent requests of one group (same
    seed, same non-batch shapes) into padded, bucketed batches, retries
    transient executor failures and feeds the model's circuit breaker;
  * `InferenceServer` — bounded admission, per-request deadlines,
    backpressure (ServerOverloaded), the breaker gate
    (ModelUnavailable) and graceful drain;
  * `serve_http` — the stdlib HTTP front end (predict, `/metrics`,
    `/healthz`, `/statusz`);
  * per-model metrics on the `telemetry` registry (one Prometheus scrape
    sees every model) and in a JSON snapshot; with a profiler capture
    running, each request carries one trace id across its spans.

The JAX package's mxsan tracking, compile-cache wiring and mxprof cost
records wait for those modules (ROADMAP queue A item 10).  Export gives
every input a batch dim and every output batch rows, so the JAX
package's scalar side-inputs and non-batch-major outputs do not occur.

    from mxnet_tpu_torch import serving
    repo = serving.ModelRepository()              # serves on gpu(0)
    repo.add("resnet", "deploy_dir")
    server = serving.InferenceServer(
        repo, serving.ServingConfig(max_batch_size=32, batch_timeout_ms=2))
    y = server.infer("resnet", [x])               # blocking call
    fut = server.submit("resnet", [x])            # concurrent path
    httpd = serving.serve_http(server, port=0)    # httpd.server_address
    server.shutdown(drain=True)
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

from ..base import MXNetError

__all__ = [
    "ServingError", "ServerOverloaded", "DeadlineExceeded", "ServerClosed",
    "ModelNotFound", "ModelUnavailable", "ServingConfig", "ModelRepository",
    "DynamicBatcher", "InferenceServer", "serve_http",
    "default_bucket_ladder",
]


class ServingError(MXNetError):
    """Base class for serving failures; `status` maps to HTTP."""

    status = 500


class ServerOverloaded(ServingError):
    """Admission queue full — the 503 backpressure signal."""

    status = 503


class DeadlineExceeded(ServingError):
    """The request's deadline expired before execution (504)."""

    status = 504


class ServerClosed(ServingError):
    """Submitted after shutdown began (503; drain rejects new work)."""

    status = 503


class ModelNotFound(ServingError):
    """No such model name or version in the repository (404)."""

    status = 404


class ModelUnavailable(ServingError):
    """This model's circuit breaker is OPEN: its executor failed
    `breaker_threshold` consecutive times, so requests for it answer
    503 until a half-open probe succeeds.  Other models — and the
    process, and /healthz — are unaffected: degrade, don't die."""

    status = 503


def default_bucket_ladder(max_batch_size: int) -> List[int]:
    """Powers of two up to max_batch_size (always included)."""
    ladder, b = [], 1
    while b < max_batch_size:
        ladder.append(b)
        b *= 2
    ladder.append(max_batch_size)
    return ladder


@dataclass
class ServingConfig:
    """Batching/admission knobs (one config serves every model; the
    bucket ladder is clamped per model to what its artifact allows).

    max_batch_size    — coalesce at most this many rows per launch.
    batch_timeout_ms  — a non-full batch launches once its oldest
                        request has waited this long.
    buckets           — explicit padded-batch ladder; default is powers
                        of two up to max_batch_size.
    max_queue         — bound on admitted-but-incomplete requests;
                        beyond it submits fail ServerOverloaded.
    default_timeout_ms — per-request deadline when the caller gives
                        none; None = no deadline.
    drain_timeout_s   — hard deadline for shutdown(drain=True); None =
                        the MXNET_DRAIN_TIMEOUT_MS knob.
    breaker_threshold / breaker_cooldown_ms — per-model circuit-breaker
                        overrides (None = the MXNET_BREAKER_* knobs).
    execute_retries   — max attempts for a TRANSIENT executor failure
                        within a batch launch (deadline-aware); None =
                        the MXNET_RETRY_MAX_ATTEMPTS knob.
    """

    max_batch_size: int = 32
    batch_timeout_ms: float = 5.0
    buckets: Optional[List[int]] = None
    max_queue: int = 256
    default_timeout_ms: Optional[float] = None
    drain_timeout_s: Optional[float] = None
    breaker_threshold: Optional[int] = None
    breaker_cooldown_ms: Optional[float] = None
    execute_retries: Optional[int] = None

    def ladder(self) -> List[int]:
        if self.buckets:
            lad = sorted(set(int(b) for b in self.buckets))
            if lad[0] < 1:
                raise ServingError(f"bucket ladder {lad}: sizes must "
                                   f"be >= 1")
            return lad
        return default_bucket_ladder(self.max_batch_size)


from .repository import ModelRepository  # noqa: E402
from .batcher import DynamicBatcher  # noqa: E402
from .server import InferenceServer  # noqa: E402
from .http import serve_http  # noqa: E402
