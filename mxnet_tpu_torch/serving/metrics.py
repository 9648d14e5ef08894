"""Per-model serving metrics (counterpart of ``mxnet_tpu/serving/metrics.py``
without its telemetry-registry and chrome-trace hooks): counters, a
queue-depth gauge and a bounded latency ring, read as one JSON-able
snapshot."""
from __future__ import annotations

import threading
import time
from collections import deque
from typing import Optional

_LATENCY_RING = 4096


def _percentile(sorted_vals, q: float) -> Optional[float]:
    if not sorted_vals:
        return None
    idx = min(len(sorted_vals) - 1, int(round(q * (len(sorted_vals) - 1))))
    return sorted_vals[idx]


class ModelMetrics:
    """One model-version's serving counters + latency ring."""

    COUNTERS = ("requests", "completed", "failed", "rejected",
                "deadline_expired", "batches", "batched_rows", "padded_rows",
                "cache_hits", "cache_misses", "queue_depth",
                "drain_timeouts")

    def __init__(self, model: str, version: int):
        self.model, self.version = model, version
        self._lock = threading.Lock()
        self._c = {name: 0 for name in self.COUNTERS}
        self._lat = deque(maxlen=_LATENCY_RING)  # (done_t, latency_s)
        self._started = time.perf_counter()

    def bump(self, name: str, d: int = 1) -> None:
        with self._lock:
            self._c[name] += d

    def gauge(self, name: str, v: int) -> None:
        with self._lock:
            self._c[name] = v

    def value(self, name: str) -> int:
        with self._lock:
            return int(self._c[name])

    def observe_latency(self, seconds: float) -> None:
        with self._lock:
            self._lat.append((time.perf_counter(), seconds))

    def snapshot(self) -> dict:
        with self._lock:
            lat = list(self._lat)
            snap = dict(self._c)
        now = time.perf_counter()
        vals = sorted(s for _, s in lat)
        span = (now - (lat[0][0] if len(lat) == self._lat.maxlen
                       else self._started)) or 1e-9
        batched, padded = snap["batched_rows"], snap["padded_rows"]
        snap.update({
            "model": self.model,
            "version": self.version,
            "qps": round(len(lat) / span, 3),
            "p50_latency_ms": None if not vals else
            round(_percentile(vals, 0.50) * 1e3, 3),
            "p99_latency_ms": None if not vals else
            round(_percentile(vals, 0.99) * 1e3, 3),
            "batch_occupancy": None if not padded else
            round(batched / padded, 4),
            "mean_batch_rows": None if not snap["batches"] else
            round(batched / snap["batches"], 2),
        })
        return snap
