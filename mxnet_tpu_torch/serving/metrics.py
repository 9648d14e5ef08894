"""Per-model serving metrics, riding the telemetry registry.

Counterpart of ``mxnet_tpu/serving/metrics.py``.  Every counter/gauge
here is a `telemetry` registry child labeled `{model, version}` — so one
Prometheus scrape (`GET /metrics`) sees every model's requests,
rejections and cache hits, and request latency lands in a fixed-bucket
histogram (`mx_serving_request_latency_seconds`).  The JSON `snapshot()`
keeps its dict shape (QPS, p50/p99 latency, batch occupancy, queue
depth...).

While the profiler is capturing, updates are mirrored as chrome-trace
counter lanes (`"ph": "C"`) under the "serving" category.

Construction RESETS the label set's children: a new `_ModelEntry` for
the same (model, version) is a lifecycle restart (the Prometheus
counter-reset convention).  Corollary: the registry has ONE time series
per (model, version) per process — two repositories serving the same
model version in one process share (and reset) each other's series.
Run one repository per process.
"""
from __future__ import annotations

import threading
import time
from collections import deque
from typing import Dict, Optional

from .. import profiler as _prof
from ..telemetry import instruments as _ins
from ..telemetry import tracing as _tracing

# completed-request latencies kept for percentile estimates; a bounded
# ring so a long-lived server's memory stays flat
_LATENCY_RING = 4096


def _percentile(sorted_vals, q: float) -> Optional[float]:
    if not sorted_vals:
        return None
    idx = min(len(sorted_vals) - 1, int(round(q * (len(sorted_vals) - 1))))
    return sorted_vals[idx]


class ModelMetrics:
    """One model-version's serving counters + latency ring."""

    COUNTERS = (
        "requests", "completed", "failed", "rejected",
        "deadline_expired", "batches", "batched_rows", "padded_rows",
        "cache_hits", "cache_misses", "queue_depth",
        # resilience: transient-executor retries that exhausted their
        # budget, 503s shed by an open circuit breaker, and drain
        # deadlines that abandoned queued work at shutdown
        "retries_exhausted", "breaker_rejected", "drain_timeouts",
    )
    # queue_depth is the one point-in-time value in the tuple — it maps
    # to a gauge family; everything else is a monotone counter
    _GAUGES = ("queue_depth",)

    def __init__(self, model: str, version: int):
        self.model, self.version = model, version
        self._c: Dict[str, object] = {}
        for name in self.COUNTERS:
            if name in self._GAUGES:
                child = _ins.serving_queue_depth(model, version)
            else:
                child = _ins.serving_counter(name, model, version)
            child.reset()
            self._c[name] = child
        self._latency_hist = _ins.serving_request_latency(model, version)
        self._latency_hist.reset()
        self._lock = threading.Lock()
        self._lat = deque(maxlen=_LATENCY_RING)  # (done_t, latency_s)
        self._started = time.perf_counter()

    def _lane(self, name: str) -> str:
        return f"serving/{self.model}/v{self.version}/{name}"

    def bump(self, name: str, d: int = 1) -> None:
        c = self._c[name]
        if not _prof._running:
            c.inc(d)
            return
        # chrome counter lane while capturing: inc and emit under one
        # lock so concurrent bumps cannot interleave into (later ts,
        # smaller value) samples
        with self._lock:
            v = c.inc(d)
            _tracing.counter_event(self._lane(name), v, cat="serving")

    def gauge(self, name: str, v: int) -> None:
        if not _prof._running:
            self._c[name].set(v)
            return
        with self._lock:
            self._c[name].set(v)
            _tracing.counter_event(self._lane(name), v, cat="serving")

    def value(self, name: str) -> int:
        return int(self._c[name].value)

    def observe_latency(self, seconds: float) -> None:
        self._latency_hist.observe(seconds)
        with self._lock:
            self._lat.append((time.perf_counter(), seconds))

    def snapshot(self) -> dict:
        with self._lock:
            lat = list(self._lat)
        now = time.perf_counter()
        vals = sorted(s for _, s in lat)
        # QPS over the ring's span (a full ring measures the recent
        # window; a part-full ring measures since startup)
        span = (now - (lat[0][0] if len(lat) == self._lat.maxlen
                       else self._started)) or 1e-9
        batched = self.value("batched_rows")
        padded = self.value("padded_rows")
        snap = {name: self.value(name) for name in self.COUNTERS}
        snap.update({
            "model": self.model,
            "version": self.version,
            "qps": round(len(lat) / span, 3),
            "p50_latency_ms": None if not vals else
            round(_percentile(vals, 0.50) * 1e3, 3),
            "p99_latency_ms": None if not vals else
            round(_percentile(vals, 0.99) * 1e3, 3),
            # fraction of launched rows that were real requests (the
            # rest was bucket padding); 1.0 = no padding waste
            "batch_occupancy": None if not padded else
            round(batched / padded, 4),
            "mean_batch_rows": None if not snap["batches"] else
            round(batched / snap["batches"], 2),
        })
        return snap
