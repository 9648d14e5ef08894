"""Process-wide metrics registry: labeled Counter/Gauge/Histogram.

Counterpart of ``mxnet_tpu/telemetry/metrics.py``, the same semantics
(bucket ladders, kind-clash errors, text format 0.0.4) in pure Python.

The serving and training layers record into ONE registry so a single
scrape (`/metrics`, Prometheus text exposition) or snapshot (JSON) sees
the whole process: request latencies, AOT-compile counts, training step
phases, collective times, data-wait.  Design constraints:

  * bounded memory — histograms use a FIXED exponential bucket ladder
    (no per-observation storage), so a long-lived server's footprint is
    flat no matter how much traffic it sees; percentile estimates come
    from bucket interpolation with error bounded by the ladder's ratio;
  * cheap hot path — a counter increment is one lock + one float add;
    label lookup is a dict hit on a tuple key, and instrument sites are
    expected to cache the child object (`family.labels(...)` once, then
    `child.inc()` per event);
  * standard exposition — `to_prometheus()` renders the text format
    (`# HELP` / `# TYPE` headers, one line per sample) that any
    Prometheus-compatible scraper ingests; `snapshot()` renders the
    same data as a JSON-able dict for the existing snapshot surfaces.
"""
from __future__ import annotations

import math
import threading
from collections import OrderedDict
from typing import Dict, List, Optional, Sequence, Tuple

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricFamily", "MetricsRegistry",
    "get_registry", "DEFAULT_LATENCY_BUCKETS", "exponential_buckets",
]


def exponential_buckets(start: float, factor: float, count: int) -> List[float]:
    """Fixed exponential ladder: ``start * factor**i`` for i in [0, count)."""
    if start <= 0 or factor <= 1 or count < 1:
        raise ValueError(
            f"exponential_buckets(start={start}, factor={factor}, "
            f"count={count}): need start > 0, factor > 1, count >= 1")
    return [start * factor ** i for i in range(count)]


# 100us .. ~105s in x2 steps: 21 buckets covers op dispatch through
# multi-second AOT compiles with <=2x relative quantile error per bucket.
DEFAULT_LATENCY_BUCKETS = exponential_buckets(1e-4, 2.0, 21)

_VALID_FIRST = set("abcdefghijklmnopqrstuvwxyz"
                   "ABCDEFGHIJKLMNOPQRSTUVWXYZ_:")
_VALID_REST = _VALID_FIRST | set("0123456789")


def _check_name(name: str) -> str:
    if not name or name[0] not in _VALID_FIRST \
            or any(c not in _VALID_REST for c in name):
        raise ValueError(
            f"metric name {name!r} is not a valid Prometheus name "
            f"([a-zA-Z_:][a-zA-Z0-9_:]*)")
    return name


def _escape_label(v: str) -> str:
    return (str(v).replace("\\", "\\\\").replace("\n", "\\n")
            .replace('"', '\\"'))


def _fmt_value(v: float) -> str:
    if v == math.inf:
        return "+Inf"
    if v == -math.inf:
        return "-Inf"
    if isinstance(v, float) and v.is_integer() and abs(v) < 1e15:
        return str(int(v))
    return repr(v)


def _labels_text(labels: "OrderedDict[str, str]",
                 extra: Optional[Tuple[str, str]] = None) -> str:
    items = list(labels.items())
    if extra is not None:
        items.append(extra)
    if not items:
        return ""
    return "{" + ",".join(f'{k}="{_escape_label(v)}"'
                          for k, v in items) + "}"


class Counter:
    """Monotone cumulative count.  One instance per label set."""

    __slots__ = ("_lock", "_value")

    def __init__(self):
        self._lock = threading.Lock()
        self._value = 0.0

    def inc(self, amount: float = 1.0) -> float:
        if amount < 0:
            raise ValueError(f"counter increment must be >= 0, "
                             f"got {amount}")
        with self._lock:
            self._value += amount
            return self._value

    @property
    def value(self) -> float:
        with self._lock:
            return self._value

    def reset(self) -> None:
        """Zero the counter — for lifecycle restarts (a fresh model
        entry re-registering its labels), not for steady-state use."""
        with self._lock:
            self._value = 0.0


class Gauge:
    """Point-in-time value (queue depth, occupancy, last wait)."""

    __slots__ = ("_lock", "_value")

    def __init__(self):
        self._lock = threading.Lock()
        self._value = 0.0

    def set(self, v: float) -> None:
        with self._lock:
            self._value = float(v)

    def inc(self, amount: float = 1.0) -> None:
        with self._lock:
            self._value += amount

    def dec(self, amount: float = 1.0) -> None:
        self.inc(-amount)

    @property
    def value(self) -> float:
        with self._lock:
            return self._value

    def reset(self) -> None:
        self.set(0.0)


class Histogram:
    """Fixed-bucket histogram: cumulative counts per upper bound plus
    sum/count — exactly the Prometheus histogram data model, so both
    the text exposition and quantile estimation read straight off it.
    """

    __slots__ = ("_lock", "buckets", "_counts", "_sum", "_count")

    def __init__(self, buckets: Sequence[float]):
        bs = sorted(float(b) for b in buckets)
        if not bs:
            raise ValueError("histogram needs at least one bucket")
        self.buckets = bs  # upper bounds, +Inf implied
        self._lock = threading.Lock()
        self._counts = [0] * (len(bs) + 1)  # last slot = +Inf overflow
        self._sum = 0.0
        self._count = 0

    def observe(self, v: float) -> None:
        # linear scan: ladders are ~20 entries and the scan is
        # branch-predictable; bisect would pay more in call overhead
        i = 0
        bs = self.buckets
        n = len(bs)
        while i < n and v > bs[i]:
            i += 1
        with self._lock:
            self._counts[i] += 1
            self._sum += v
            self._count += 1

    @property
    def count(self) -> int:
        with self._lock:
            return self._count

    @property
    def sum(self) -> float:
        with self._lock:
            return self._sum

    def cumulative(self) -> List[Tuple[float, int]]:
        """[(upper_bound, cumulative_count)] ending with (+Inf, total)."""
        with self._lock:
            counts = list(self._counts)
        out, acc = [], 0
        for ub, c in zip(self.buckets + [math.inf], counts):
            acc += c
            out.append((ub, acc))
        return out

    def quantile(self, q: float) -> Optional[float]:
        """Estimate the q-quantile by linear interpolation inside the
        bucket where the cumulative count crosses q*total.  Error is
        bounded by the bucket width (the ladder's exponential factor).
        """
        if not 0.0 <= q <= 1.0:
            raise ValueError(f"quantile q must be in [0, 1], got {q}")
        cum = self.cumulative()
        total = cum[-1][1]
        if total == 0:
            return None
        rank = q * total
        lo = 0.0
        prev_c = 0
        for ub, c in cum:
            if c >= rank:
                if ub == math.inf:
                    return lo  # overflow bucket: best effort = last ub
                if c == prev_c:
                    return ub
                frac = (rank - prev_c) / (c - prev_c)
                return lo + frac * (ub - lo)
            lo, prev_c = ub, c
        return cum[-1][0]

    def reset(self) -> None:
        with self._lock:
            self._counts = [0] * (len(self.buckets) + 1)
            self._sum = 0.0
            self._count = 0


_KINDS = {"counter": Counter, "gauge": Gauge, "histogram": Histogram}


class MetricFamily:
    """One named metric + its per-label-set children."""

    def __init__(self, name: str, kind: str, help: str = "",
                 labelnames: Sequence[str] = (),
                 buckets: Optional[Sequence[float]] = None):
        self.name = _check_name(name)
        if kind not in _KINDS:
            raise ValueError(f"unknown metric kind {kind!r}")
        self.kind = kind
        self.help = help
        self.labelnames = tuple(labelnames)
        for ln in self.labelnames:
            _check_name(ln)
        # stored sorted: children sort anyway, and idempotent
        # re-registration compares ladders order-insensitively
        self.buckets = sorted(float(b) for b in buckets) \
            if buckets is not None else list(DEFAULT_LATENCY_BUCKETS)
        self._lock = threading.Lock()
        self._children: "OrderedDict[tuple, object]" = OrderedDict()

    def _make_child(self):
        if self.kind == "histogram":
            return Histogram(self.buckets)
        return _KINDS[self.kind]()

    def labels(self, *values, **kv):
        """Get-or-create the child for one label set.  Accepts either
        positional values (in labelnames order) or keywords."""
        if values and kv:
            raise ValueError("pass labels positionally or by keyword, "
                             "not both")
        if kv:
            if set(kv) != set(self.labelnames):
                raise ValueError(
                    f"metric {self.name!r} has labels "
                    f"{self.labelnames}, got {sorted(kv)}")
            values = tuple(str(kv[n]) for n in self.labelnames)
        else:
            if len(values) != len(self.labelnames):
                raise ValueError(
                    f"metric {self.name!r} takes {len(self.labelnames)} "
                    f"label values, got {len(values)}")
            values = tuple(str(v) for v in values)
        with self._lock:
            child = self._children.get(values)
            if child is None:
                child = self._make_child()
                self._children[values] = child
        return child

    def reset_labels(self, *values, **kv):
        """Zero (creating if absent) one label set's child — the
        lifecycle-restart hook for a re-registered model entry."""
        child = self.labels(*values, **kv)
        child.reset()
        return child

    def children(self) -> List[Tuple[tuple, object]]:
        with self._lock:
            return list(self._children.items())

    # the no-label fast path: a family declared with labelnames=() acts
    # as a single metric
    def _solo(self):
        return self.labels()

    def inc(self, amount: float = 1.0):
        self._solo().inc(amount)

    def dec(self, amount: float = 1.0):
        self._solo().dec(amount)

    def set(self, v: float):
        self._solo().set(v)

    def observe(self, v: float):
        self._solo().observe(v)

    @property
    def value(self):
        return self._solo().value


class MetricsRegistry:
    """Name -> MetricFamily.  Registration is idempotent: asking for an
    existing (name, kind) returns the existing family (labelnames and
    bucket ladder must match); a kind clash raises."""

    def __init__(self):
        self._lock = threading.Lock()
        self._families: "OrderedDict[str, MetricFamily]" = OrderedDict()
        # bumped by clear(); child caches (telemetry.instruments, op
        # dispatch) key their validity on it so a cleared registry
        # never keeps receiving samples into orphaned children
        self.generation = 0
        # name -> zero-arg callable run before every exposition, for
        # point-in-time process gauges (uptime, RSS, build info) that
        # must be fresh at scrape time rather than at some event time
        self._collectors: "OrderedDict[str, object]" = OrderedDict()

    def add_collector(self, name: str, fn) -> None:
        """Register (idempotently, by name) a pre-scrape refresher.  A
        collector must be cheap and must never raise into a scrape —
        failures are swallowed (the scrape serves stale/absent samples
        instead of a 500)."""
        with self._lock:
            self._collectors[name] = fn

    def _run_collectors(self) -> None:
        with self._lock:
            fns = list(self._collectors.values())
        for fn in fns:
            try:
                fn()
            except Exception:  # noqa: BLE001 — scrape must not 500
                pass

    def _get_or_make(self, name: str, kind: str, help: str,
                     labelnames: Sequence[str],
                     buckets: Optional[Sequence[float]] = None
                     ) -> MetricFamily:
        with self._lock:
            fam = self._families.get(name)
            if fam is not None:
                if fam.kind != kind:
                    raise ValueError(
                        f"metric {name!r} already registered as "
                        f"{fam.kind}, not {kind}")
                if tuple(labelnames) != fam.labelnames:
                    raise ValueError(
                        f"metric {name!r} already registered with "
                        f"labels {fam.labelnames}, not "
                        f"{tuple(labelnames)}")
                if kind == "histogram" and buckets is not None \
                        and sorted(float(b) for b in buckets) \
                        != fam.buckets:
                    raise ValueError(
                        f"metric {name!r} already registered with "
                        f"bucket ladder {fam.buckets}; observations "
                        f"on a different ladder would skew quantiles")
                if help and not fam.help:
                    fam.help = help
                return fam
            fam = MetricFamily(name, kind, help=help,
                               labelnames=labelnames, buckets=buckets)
            self._families[name] = fam
            return fam

    def counter(self, name: str, help: str = "",
                labels: Sequence[str] = ()) -> MetricFamily:
        return self._get_or_make(name, "counter", help, labels)

    def gauge(self, name: str, help: str = "",
              labels: Sequence[str] = ()) -> MetricFamily:
        return self._get_or_make(name, "gauge", help, labels)

    def histogram(self, name: str, help: str = "",
                  labels: Sequence[str] = (),
                  buckets: Optional[Sequence[float]] = None
                  ) -> MetricFamily:
        return self._get_or_make(name, "histogram", help, labels,
                                 buckets=buckets)

    def get(self, name: str) -> Optional[MetricFamily]:
        with self._lock:
            return self._families.get(name)

    def families(self) -> List[MetricFamily]:
        with self._lock:
            return list(self._families.values())

    def clear(self) -> None:
        """Drop every family — test isolation only.  Bumps the
        generation so cached children elsewhere are re-resolved."""
        with self._lock:
            self._families.clear()
            self.generation += 1
            # collectors survive: they are registered once per process
            # (telemetry.instruments import) and re-create their
            # families on the next scrape of the cleared registry

    # ---- exposition ----------------------------------------------------

    def to_prometheus(self) -> str:
        """Prometheus text exposition format 0.0.4: `# HELP`/`# TYPE`
        headers, one line per sample, histogram `_bucket`/`_sum`/
        `_count` expansion."""
        self._run_collectors()
        out: List[str] = []
        for fam in self.families():
            out.append(f"# HELP {fam.name} "
                       f"{fam.help or fam.name}".rstrip())
            out.append(f"# TYPE {fam.name} {fam.kind}")
            for values, child in fam.children():
                labels = OrderedDict(zip(fam.labelnames, values))
                if fam.kind == "histogram":
                    for ub, cum in child.cumulative():
                        out.append(
                            f"{fam.name}_bucket"
                            f"{_labels_text(labels, ('le', _fmt_value(ub)))}"
                            f" {cum}")
                    out.append(f"{fam.name}_sum{_labels_text(labels)} "
                               f"{_fmt_value(child.sum)}")
                    out.append(f"{fam.name}_count{_labels_text(labels)} "
                               f"{child.count}")
                else:
                    out.append(f"{fam.name}{_labels_text(labels)} "
                               f"{_fmt_value(child.value)}")
        return "\n".join(out) + "\n"

    def snapshot(self) -> dict:
        """JSON-able mirror of the exposition (the `dumps()`-style
        surface the serving snapshot already speaks)."""
        self._run_collectors()
        snap: Dict[str, dict] = {}
        for fam in self.families():
            samples = []
            for values, child in fam.children():
                labels = dict(zip(fam.labelnames, values))
                if fam.kind == "histogram":
                    samples.append({
                        "labels": labels,
                        "count": child.count,
                        "sum": child.sum,
                        "p50": child.quantile(0.50),
                        "p95": child.quantile(0.95),
                        "p99": child.quantile(0.99),
                    })
                else:
                    samples.append({"labels": labels,
                                    "value": child.value})
            snap[fam.name] = {"type": fam.kind, "help": fam.help,
                              "samples": samples}
        return snap


_REGISTRY = MetricsRegistry()


def get_registry() -> MetricsRegistry:
    """The process-wide default registry every instrument site uses."""
    return _REGISTRY
