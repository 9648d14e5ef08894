"""mxnet_tpu_torch.telemetry — metrics, span tracing and alerts.

Counterpart of ``mxnet_tpu/telemetry``:

  * **metrics** — a process-wide registry of labeled `Counter`/`Gauge`/
    `Histogram` (fixed exponential latency buckets), rendered as
    Prometheus text exposition (`to_prometheus()`, served at
    `GET /metrics` by the serving front end) or a JSON snapshot;
  * **instruments** — the declared catalogue of the framework's metric
    families and their cached accessors (`catalog` renders it);
  * **tracing** — trace/span ids with parent links; spans land in the
    `profiler` chrome-trace buffer while a capture runs, so one trace
    shows a serving request's admission → queue-wait → batch-assembly →
    execute → respond;
  * **alerts** — the declarative rule engine `/statusz` renders.

`telemetry.enable()` (or `MXNET_TELEMETRY=1`) turns the span side on;
metrics are always live.  The JAX package's mxprof, mxhealth,
mxgoodput, mxblackbox and mxtriage are not ported yet (ROADMAP queue A
item 10).

    from mxnet_tpu_torch import profiler, telemetry

    telemetry.enable()
    profiler.start()
    ...serve requests...
    profiler.dump(finished=True)
    print(telemetry.get_registry().to_prometheus())
"""
from __future__ import annotations

from .metrics import (Counter, Gauge, Histogram, MetricFamily,
                      MetricsRegistry, get_registry,
                      DEFAULT_LATENCY_BUCKETS, exponential_buckets)
from .tracing import (Span, span, current_span, new_trace_id,
                      record_complete, flow_start, flow_end,
                      counter_event, enable, disable, enabled)
from . import metrics
from . import tracing
from . import instruments
from . import catalog
from . import alerts

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricFamily", "MetricsRegistry",
    "get_registry", "DEFAULT_LATENCY_BUCKETS", "exponential_buckets",
    "Span", "span", "current_span", "new_trace_id", "record_complete",
    "flow_start", "flow_end", "counter_event",
    "enable", "disable", "enabled",
    "metrics", "tracing", "instruments", "catalog", "alerts",
]
