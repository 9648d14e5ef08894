"""mxnet_tpu_torch.serving — dynamic-batching inference serving on top of
the deploy artifacts (``contrib/deploy.py``).

Counterpart of ``mxnet_tpu/serving``:

  * `ModelRepository` — loads/versions deploy artifacts lazily, keeps a
    per-bucket executor cache with hit/miss counters (PyTorch runs
    eagerly, so a bucket's "executable" is the served model's forward:
    nothing is compiled, the counters stay);
  * `DynamicBatcher` — coalesces concurrent requests into padded,
    bucketed batches and splits the outputs per request;
  * `InferenceServer` — bounded admission, per-request deadlines,
    backpressure (ServerOverloaded) and graceful drain;
  * per-model metrics (QPS, p50/p99 latency, batch occupancy, queue
    depth, rejections) in a JSON snapshot.

The JAX package's hooks into telemetry, resilience (circuit breaker,
retry, chaos), mxsan, the compile cache, rollover and the HTTP front end
are not ported in this slice, nor its per-request seeds (no served layer
draws random numbers), scalar side-inputs and non-batch-major outputs
(a zoo network has neither).

    from mxnet_tpu_torch import serving
    repo = serving.ModelRepository()              # serves on gpu(0)
    repo.add("resnet", "deploy_dir")
    server = serving.InferenceServer(
        repo, serving.ServingConfig(max_batch_size=32, batch_timeout_ms=2))
    y = server.infer("resnet", [x])               # blocking call
    fut = server.submit("resnet", [x])            # concurrent path
    server.shutdown(drain=True)
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List

from ..base import MXNetError

__all__ = [
    "ServingError", "ServerOverloaded", "DeadlineExceeded", "ServerClosed",
    "ModelNotFound", "ServingConfig", "ModelRepository", "DynamicBatcher",
    "InferenceServer", "default_bucket_ladder",
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
    """Batching/admission knobs (one config serves every model).

    max_batch_size    — coalesce at most this many rows per launch; the
                        bucket ladder is the powers of two below it and
                        itself.
    batch_timeout_ms  — a non-full batch launches once its oldest
                        request has waited this long.
    max_queue         — bound on admitted-but-incomplete requests;
                        beyond it submits fail ServerOverloaded.
    """

    max_batch_size: int = 32
    batch_timeout_ms: float = 5.0
    max_queue: int = 256

    def ladder(self) -> List[int]:
        return default_bucket_ladder(self.max_batch_size)


from .repository import ModelRepository  # noqa: E402
from .batcher import DynamicBatcher  # noqa: E402
from .server import InferenceServer  # noqa: E402
