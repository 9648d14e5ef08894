"""Declarative alert engine over the telemetry registry.

Counterpart of ``mxnet_tpu/telemetry/alerts.py``: the same rules, states
and events.  Its hooks into mxblackbox (each transition journalled) and
mxtriage (``action="deep_capture"``) wait for those packages (ROADMAP
queue A item 10): a deep-capture rule fires as the JAX one does, and its
event says ``action_status: "not ported"``.

A *rule* is a named predicate over the registered metric families plus
a ``for_`` duration and a severity — the Prometheus alerting-rule
shape, evaluated in-process by a lightweight ticker instead of an
external evaluator:

    from mxnet_tpu_torch.telemetry import alerts

    eng = alerts.AlertEngine()
    eng.add_rule("nonfinite_grads", severity="page",
                 metric="mx_nonfinite_total", op=">", threshold=0,
                 description="NaN/Inf gradient values observed")
    eng.add_rule("p99_slo", severity="page", for_=5.0,
                 metric="p99:mx_serving_request_latency_seconds",
                 labels={"model": "m"}, op=">", threshold=0.025)
    eng.tick()            # or eng.start() for the background ticker

Rule lifecycle: ``inactive`` → ``pending`` (predicate true, waiting
out ``for_``) → ``firing`` (fires a structured JSON event, sets
``mx_alerts_firing{rule,severity}=1``, bumps ``mx_alerts_total``) →
``resolved`` (predicate false again; the gauge drops to 0 and a
``resolved`` event is emitted).  Events land in a bounded history
(``events()``) — the stream ``tools/health_report.py`` embeds in
HEALTH.json.

Predicates come in two forms:

  * **declarative** — ``metric``/``op``/``threshold`` (+ optional
    ``labels`` filter): ``metric`` names a counter/gauge family, or
    ``pNN:<family>`` for a histogram quantile.  These serialize into
    the event JSON, so an alert is self-describing.
  * **callable** — ``predicate=lambda m: ...`` over a
    :class:`MetricView` for anything the comparison form cannot say.

``serving_slo_rules``, ``training_health_rules`` and ``goodput_rules``
install the stock rule tables (serving p99 / queue depth / breaker
state; nonfinite and spike events; goodput-ratio floor and preemption
recovery) on any engine — the same engine serves them all, which is
the point: one alert surface for the whole process.
"""
from __future__ import annotations

import json
import math
import threading
import time
from collections import deque
from typing import Callable, Dict, List, Optional

from ..base import MXNetError
from . import instruments as _ins

# MXNET_HEALTH_ALERT_TICK_MS's and MXNET_GOODPUT_MIN's defaults in the JAX
# package; the knobs stay queued with mxhealth and mxgoodput, whose
# ticker and ratio writer are not ported yet
_ALERT_TICK_S = 1.0
_GOODPUT_MIN = 0.9
from .metrics import MetricsRegistry, get_registry

__all__ = [
    "MetricView", "Rule", "AlertEngine", "default_engine",
    "serving_slo_rules", "training_health_rules", "goodput_rules",
]

_OPS: Dict[str, Callable[[float, float], bool]] = {
    ">": lambda a, b: a > b,
    ">=": lambda a, b: a >= b,
    "<": lambda a, b: a < b,
    "<=": lambda a, b: a <= b,
    "==": lambda a, b: a == b,
    "!=": lambda a, b: a != b,
}


class MetricView:
    """Read-side view of a registry for predicates: values aggregate
    across the children matching a label filter, histograms answer
    quantiles on the MERGED bucket counts (not a per-child max — a
    fleet of label sets is one population to an SLO)."""

    def __init__(self, registry: Optional[MetricsRegistry] = None):
        self._reg = registry or get_registry()

    def _children(self, name: str,
                  labels: Optional[Dict[str, str]] = None):
        fam = self._reg.get(name)
        if fam is None:
            return None, ()
        want = {k: str(v) for k, v in (labels or {}).items()}
        out = []
        for values, child in fam.children():
            have = dict(zip(fam.labelnames, values))
            if all(have.get(k) == v for k, v in want.items()):
                out.append(child)
        return fam, tuple(out)

    def value(self, name: str,
              labels: Optional[Dict[str, str]] = None,
              agg: str = "sum") -> Optional[float]:
        """Counter/gauge value summed (or ``agg="max"``) over matching
        children; None when the family or label set does not exist
        yet — a rule over an unborn metric stays inactive rather than
        comparing against 0."""
        fam, children = self._children(name, labels)
        if fam is None or not children:
            return None
        vals = [c.value for c in children]
        return max(vals) if agg == "max" else sum(vals)

    def quantile(self, name: str, q: float,
                 labels: Optional[Dict[str, str]] = None
                 ) -> Optional[float]:
        """q-quantile over the merged cumulative buckets of matching
        histogram children (None when empty/absent)."""
        fam, children = self._children(name, labels)
        if fam is None or not children or fam.kind != "histogram":
            return None
        merged: Dict[float, int] = {}
        for c in children:
            for ub, cum in c.cumulative():
                merged[ub] = merged.get(ub, 0) + cum
        bounds = sorted(merged)
        total = merged[bounds[-1]] if bounds else 0
        if total == 0:
            return None
        rank = q * total
        lo, prev = 0.0, 0
        for ub in bounds:
            c = merged[ub]
            if c >= rank:
                if ub == math.inf:
                    return lo
                if c == prev:
                    return ub
                return lo + (rank - prev) / (c - prev) * (ub - lo)
            lo, prev = ub, c
        return bounds[-1]


class Rule:
    """One declarative alert rule.  ``spec()`` is the JSON-able form
    every event carries."""

    def __init__(self, name: str, severity: str = "warning",
                 for_: float = 0.0,
                 metric: Optional[str] = None, op: str = ">",
                 threshold: float = 0.0,
                 labels: Optional[Dict[str, str]] = None,
                 agg: str = "sum", increase: bool = False,
                 predicate: Optional[Callable] = None,
                 action: Optional[str] = None,
                 description: str = ""):
        if (metric is None) == (predicate is None):
            raise MXNetError(
                f"alert rule {name!r}: pass exactly one of metric= "
                "(declarative) or predicate= (callable)")
        if metric is not None and op not in _OPS:
            raise MXNetError(f"alert rule {name!r}: unknown op {op!r} "
                             f"(expected one of {sorted(_OPS)})")
        if agg not in ("sum", "max"):
            raise MXNetError(f"alert rule {name!r}: agg must be "
                             f"'sum' or 'max', got {agg!r}")
        if action not in (None, "deep_capture"):
            raise MXNetError(f"alert rule {name!r}: unknown action "
                             f"{action!r} (known: 'deep_capture')")
        self.name = name
        self.severity = severity
        self.for_ = max(0.0, float(for_))
        self.metric, self.op, self.threshold = metric, op, threshold
        self.labels = dict(labels or {})
        # agg: how multiple matching label sets combine — "sum" for
        # rates/volumes, "max" for state gauges (two HALF-OPEN
        # breakers must not sum into a fake OPEN)
        self.agg = agg
        # increase=True compares the DELTA since the previous tick,
        # not the raw value — the only way a rule over a monotone
        # counter can ever resolve (fires while growing, resolves
        # when the growth stops)
        self.increase = bool(increase)
        self.predicate = predicate
        # action="deep_capture": in the JAX package a pending->firing
        # transition triggers one mxtriage deep capture (not ported)
        self.action = action
        self.description = description
        # evaluation state (owned by the engine's tick, under its lock)
        self.state = "inactive"      # inactive | pending | firing
        self.pending_since: Optional[float] = None
        self.last_value: Optional[float] = None
        self._prev_raw: Optional[float] = None

    def spec(self) -> dict:
        out = {"name": self.name, "severity": self.severity,
               "for_s": self.for_, "description": self.description}
        if self.action is not None:
            out["action"] = self.action
        if self.metric is not None:
            out.update({"metric": self.metric, "op": self.op,
                        "threshold": self.threshold})
            if self.labels:
                out["labels"] = dict(self.labels)
            if self.agg != "sum":
                out["agg"] = self.agg
            if self.increase:
                out["increase"] = True
        else:
            out["predicate"] = getattr(self.predicate, "__name__",
                                       "<callable>")
        return out

    def evaluate(self, view: MetricView) -> bool:
        if self.predicate is not None:
            v = self.predicate(view)
            self.last_value = float(v) if isinstance(
                v, (int, float)) and not isinstance(v, bool) else None
            return bool(v)
        name = self.metric
        if name.startswith("p") and ":" in name:
            pct, fam = name.split(":", 1)
            v = view.quantile(fam, float(pct[1:]) / 100.0,
                              labels=self.labels)
        else:
            v = view.value(name, labels=self.labels, agg=self.agg)
        if self.increase:
            prev, self._prev_raw = self._prev_raw, v
            if v is None or prev is None:
                self.last_value = None
                return False  # first sighting: no delta to judge yet
            v = v - prev
        self.last_value = v
        if v is None:
            return False
        return _OPS[self.op](v, self.threshold)


class AlertEngine:
    """Rule table + ticker.  ``tick()`` evaluates every rule once and
    walks the pending/firing state machine; ``start()`` runs it on a
    daemon thread every ``interval_s`` (1 s, the JAX default of
    ``MXNET_HEALTH_ALERT_TICK_MS``)."""

    def __init__(self, registry: Optional[MetricsRegistry] = None,
                 history: int = 512, clock=time.monotonic):
        self._view = MetricView(registry)
        self._clock = clock
        self._lock = threading.Lock()
        self._rules: "Dict[str, Rule]" = {}
        self._events: "deque[dict]" = deque(maxlen=max(1, history))
        self._ticker: Optional[threading.Thread] = None
        self._stop = threading.Event()

    # ---- rule table --------------------------------------------------

    def add_rule(self, name: str, **kw) -> Rule:
        """Install (or replace) one rule; see :class:`Rule`."""
        rule = Rule(name, **kw)
        with self._lock:
            prev = self._rules.get(name)
            if prev is not None and prev.state == "firing":
                # replacing a firing rule must not strand its gauge at
                # 1 — and the history must stay PAIRED (every firing
                # event gets its resolved), or downstream transition
                # counting miscounts open alerts
                _ins.alerts_firing(prev.name, prev.severity).set(0)
                self._emit(prev, "resolved", self._clock())
            self._rules[name] = rule
        return rule

    def remove_rule(self, name: str) -> None:
        with self._lock:
            rule = self._rules.pop(name, None)
            if rule is not None and rule.state == "firing":
                _ins.alerts_firing(rule.name, rule.severity).set(0)
                self._emit(rule, "resolved", self._clock())

    def rules(self) -> List[dict]:
        with self._lock:
            return [dict(r.spec(), state=r.state,
                         last_value=r.last_value)
                    for r in self._rules.values()]

    # ---- evaluation --------------------------------------------------

    def _emit(self, rule: Rule, state: str, now: float) -> dict:
        ev = {"t": time.time(), "rule": rule.name,
              "severity": rule.severity, "state": state,
              "value": rule.last_value, "spec": rule.spec()}
        self._events.append(ev)
        return ev

    def tick(self, now: Optional[float] = None) -> List[dict]:
        """Evaluate every rule once; returns the transition events this
        tick produced (fired / resolved)."""
        now = self._clock() if now is None else now
        out: List[dict] = []
        with self._lock:
            rules = list(self._rules.values())
            for rule in rules:
                try:
                    active = rule.evaluate(self._view)
                except Exception:  # noqa: BLE001 — one bad rule must not
                    # stop the others from being evaluated; HOLD this
                    # rule's state rather than treating the error as
                    # "condition false" (a firing alert would emit a
                    # spurious resolve, then re-fire — a flapping page)
                    continue
                if active:
                    if rule.state == "inactive":
                        rule.state = "pending"
                        rule.pending_since = now
                    if rule.state == "pending" and \
                            now - rule.pending_since >= rule.for_:
                        rule.state = "firing"
                        _ins.alerts_firing(rule.name,
                                           rule.severity).set(1)
                        _ins.alerts_total(rule.name,
                                          rule.severity).inc()
                        out.append(self._emit(rule, "firing", now))
                else:
                    if rule.state == "firing":
                        _ins.alerts_firing(rule.name,
                                           rule.severity).set(0)
                        out.append(self._emit(rule, "resolved", now))
                    rule.state = "inactive"
                    rule.pending_since = None
        # mxtriage's deep capture is not ported: the firing event says
        # so instead of pretending a capture ran
        for ev in out:
            if ev["state"] == "firing" and ev["spec"].get("action") \
                    == "deep_capture":
                ev["action_status"] = "not ported"
        return out

    def firing(self) -> List[dict]:
        with self._lock:
            return [dict(r.spec(), value=r.last_value)
                    for r in self._rules.values()
                    if r.state == "firing"]

    def events(self) -> List[dict]:
        """The bounded fired/resolved event history (JSON-able)."""
        with self._lock:
            return [dict(e) for e in self._events]

    def dumps(self) -> str:
        return json.dumps({"rules": self.rules(),
                           "firing": self.firing(),
                           "events": self.events()}, indent=1)

    # ---- ticker ------------------------------------------------------

    def start(self, interval_s: Optional[float] = None) -> None:
        """Run :meth:`tick` on a daemon thread (idempotent)."""
        if interval_s is None:
            interval_s = _ALERT_TICK_S
        with self._lock:
            if self._ticker is not None and self._ticker.is_alive():
                return
            # each ticker owns ITS stop event: a stop()/start() pair
            # racing an old thread mid-tick must not hand the fresh
            # (cleared) event to the old thread — that would leave two
            # tickers running for the process lifetime
            stop_ev = self._stop = threading.Event()

            def run():
                while not stop_ev.wait(interval_s):
                    try:
                        self.tick()
                    except Exception:  # noqa: BLE001 — the ticker survives
                        pass

            self._ticker = threading.Thread(
                target=run, name="mx-alert-ticker", daemon=True)
            self._ticker.start()

    def stop(self) -> None:
        with self._lock:
            self._stop.set()
            self._ticker = None


_default_lock = threading.Lock()
_DEFAULT: Optional[AlertEngine] = None


def default_engine() -> AlertEngine:
    """The process engine (what ``/statusz`` renders).  Created empty;
    install rule tables with :func:`serving_slo_rules` /
    :func:`training_health_rules` or ``add_rule``."""
    global _DEFAULT
    with _default_lock:
        if _DEFAULT is None:
            _DEFAULT = AlertEngine()
        return _DEFAULT


def serving_slo_rules(engine: AlertEngine,
                      p99_ms: float = 250.0,
                      queue_depth: int = 64,
                      for_s: float = 0.0,
                      labels: Optional[Dict[str, str]] = None,
                      action: Optional[str] = None) -> AlertEngine:
    """The stock serving SLO table: p99 latency, queue depth, breaker
    state — all over families the serving layer already records, so
    installing the rules is the only wiring.  ``action`` is recorded on
    the p99 rule (see the module docstring for ``deep_capture``)."""
    labels = labels or {}
    engine.add_rule(
        "serving_p99_slo", severity="page", for_=for_s,
        metric="p99:mx_serving_request_latency_seconds",
        labels=labels, op=">", threshold=p99_ms / 1e3,
        action=action,
        description=f"served p99 above {p99_ms:g}ms")
    engine.add_rule(
        "serving_queue_depth", severity="warning", for_=for_s,
        metric="mx_serving_queue_depth", labels=labels,
        op=">", threshold=queue_depth,
        description=f"admission queue deeper than {queue_depth}")
    engine.add_rule(
        "serving_breaker_open", severity="page", for_=0.0,
        metric="mx_breaker_state", labels=labels, op=">=",
        threshold=2.0, agg="max",
        # max, not sum: two HALF-OPEN breakers (1+1) must not read
        # as one OPEN (2)
        description="a model's circuit breaker is OPEN (executor "
                    "failures; that model answers 503)")
    return engine


def training_health_rules(engine: AlertEngine,
                          for_s: float = 0.0,
                          action: Optional[str] = None) -> AlertEngine:
    """The stock training-health table over mxhealth's families.

    All four rules are ``increase`` rules: the underlying families are
    monotone counters, and a raw-value comparison would fire once and
    never resolve for the life of the process.  Delta semantics give
    the alert a lifecycle: firing while the counter GROWS (new
    nonfinite steps / fresh detector events between ticks), resolved
    once it stops.  Corollary: the first tick only baselines — call
    ``tick()`` once at install time (or run the background ticker) so
    a later burst is a delta, not a first sighting."""
    engine.add_rule(
        "nonfinite_gradients", severity="page", for_=for_s,
        metric="mx_nonfinite_total", op=">", threshold=0,
        increase=True, action=action,
        description="NaN/Inf gradient values observed by the in-graph "
                    "counter since the last tick")
    engine.add_rule(
        "grad_norm_spike", severity="warning", for_=for_s,
        metric="mx_health_events_total",
        labels={"kind": "grad-spike"}, op=">", threshold=0,
        increase=True,
        description="gradient-norm spike vs the rolling median/MAD "
                    "window")
    engine.add_rule(
        "loss_spike", severity="warning", for_=for_s,
        metric="mx_health_events_total",
        labels={"kind": "loss-spike"}, op=">", threshold=0,
        increase=True,
        description="loss spike vs the rolling median/MAD window")
    engine.add_rule(
        "update_ratio_drift", severity="warning", for_=for_s,
        metric="mx_health_events_total",
        labels={"kind": "update-ratio"}, op=">", threshold=0,
        increase=True,
        description="update/param ratio drift past "
                    "MXNET_HEALTH_RATIO_MAX")
    return engine


def goodput_rules(engine: AlertEngine,
                  min_ratio: Optional[float] = None,
                  for_s: float = 30.0,
                  action: Optional[str] = None) -> AlertEngine:
    """The stock goodput table over mxgoodput's families — surfaced on
    ``/statusz`` next to the mxhealth verdict like every other stock
    table on the default engine.

    * ``goodput_below_min`` — ``mx_goodput_ratio`` under the floor
      (``min_ratio``, else 0.9: the JAX default of ``MXNET_GOODPUT_MIN``)
      for ``for_s`` seconds.
      The for-duration matters here more than anywhere: the ratio is
      legitimately low for the first seconds of a job (compile wall),
      and a preemption recovery dents it transiently — only a
      SUSTAINED dip should page.  The rule stays inactive until the
      ledger publishes its first ratio (an absent family is None, not
      zero).
    * ``preemption_recovery`` — ``increase=`` delta semantics over the
      monotone ``mx_badput_seconds_total{category=preemption_recovery}``
      counter: fires when recovery seconds are being ADDED (a
      preemption just cost wall-clock), resolves when the growth
      stops — a raw-value rule would page forever after the first
      preemption of the job's life.
    * ``rank_failure_recovery`` — same delta semantics over the
      mxelastic category: fires while an elastic restart is costing
      wall-clock, resolves once training is back."""
    if min_ratio is None:
        min_ratio = _GOODPUT_MIN
    engine.add_rule(
        "goodput_below_min", severity="page", for_=for_s,
        metric="mx_goodput_ratio", op="<", threshold=min_ratio,
        action=action,
        description=f"job goodput ratio below {min_ratio:g} "
                    f"(badput categories name where the wall-clock "
                    f"went — see /statusz or the mxprof dump)")
    engine.add_rule(
        "preemption_recovery", severity="warning", for_=0.0,
        metric="mx_badput_seconds_total",
        labels={"category": "preemption_recovery"},
        op=">", threshold=0, increase=True,
        description="preemption recovery seconds grew since the last "
                    "tick (a preemption just cost wall-clock)")
    engine.add_rule(
        "rank_failure_recovery", severity="warning", for_=0.0,
        metric="mx_badput_seconds_total",
        labels={"category": "rank_failure_recovery"},
        op=">", threshold=0, increase=True,
        description="rank-failure recovery seconds grew since the "
                    "last tick (the elastic supervisor just restarted "
                    "the job around a dead/hung rank — see "
                    "mx_elastic_restarts_total{mode})")
    return engine
