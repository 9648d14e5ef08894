"""mxnet_tpu_torch.telemetry against the JAX package's telemetry.

The same calls on both packages' registries give the same Prometheus
text (format 0.0.4) and JSON snapshot; histogram buckets and
bucket-interpolated quantiles are equal; the instrument catalogue
(names, kinds, labels, help) is the JAX one, so the port's ``/metrics``
shows the same families; spans nest and link parents alike; and the
alert engine fires and resolves the same rules at the same ticks on the
same series.  Pure host code: nothing here needs a card.
"""
import json

import numpy as np
import pytest

import mxnet_tpu.profiler as jprof
from mxnet_tpu import telemetry as jtel
from mxnet_tpu.telemetry import alerts as jalerts
from mxnet_tpu.telemetry import instruments as jins
from mxnet_tpu.telemetry import metrics as jmetrics

import mxnet_tpu_torch.profiler as tprof
from mxnet_tpu_torch import telemetry as ttel
from mxnet_tpu_torch.telemetry import alerts as talerts
from mxnet_tpu_torch.telemetry import catalog as tcatalog
from mxnet_tpu_torch.telemetry import instruments as tins
from mxnet_tpu_torch.telemetry import metrics as tmetrics

PKGS = {"jax": (jmetrics, jins, jalerts, jtel, jprof),
        "port": (tmetrics, tins, talerts, ttel, tprof)}


@pytest.fixture(autouse=True)
def _clean(tmp_path):
    """Tracing off and empty capture buffers in both packages."""
    for _, _, _, tel, prof in PKGS.values():
        tel.disable()
        prof.stop()
        prof.dump(finished=True, filename=str(tmp_path / "flush.json"))
    yield
    for _, _, _, tel, prof in PKGS.values():
        tel.disable()
        prof.stop()
        prof.dump(finished=True, filename=str(tmp_path / "flush2.json"))


def _script(metrics):
    """One fixed sequence of registry calls; returns the registry."""
    reg = metrics.MetricsRegistry()
    c = reg.counter("t_requests_total", "requests", labels=("model",))
    c.labels("a").inc()
    c.labels("a").inc(2.5)
    c.labels(model='b"\\\n').inc()  # escaping of quote, backslash, newline
    g = reg.gauge("t_depth", "", labels=("model", "version"))
    g.labels("a", 1).set(7)
    g.labels("a", 1).dec(2)
    g.labels("b", 2).inc(0.125)
    reg.gauge("t_solo", "a gauge without labels").set(-3)
    h = reg.histogram("t_latency_seconds", "latency", labels=("model",))
    rs = np.random.RandomState(0)
    for v in rs.lognormal(-6, 2, 200):
        h.labels("a").observe(float(v))
    hc = reg.histogram("t_sizes", "custom ladder",
                       buckets=[8, 1, 64, 2.5])
    for v in (0, 1, 1.5, 3, 100, 64):
        hc.observe(v)
    reg.counter("t_requests_total", "requests", labels=("model",)) \
        .labels("c").inc(1e16)  # above 1e15: printed by repr
    reg.gauge("t_inf").set(float("inf"))
    return reg


def test_prometheus_text_and_snapshot_equal():
    j, t = _script(jmetrics), _script(tmetrics)
    assert t.to_prometheus() == j.to_prometheus()
    assert json.dumps(t.snapshot(), sort_keys=True) == \
        json.dumps(j.snapshot(), sort_keys=True)


@pytest.mark.parametrize("clash", ["kind", "labels", "ladder", "name",
                                   "label_name", "arity", "negative"])
def test_registry_errors_are_the_jax_ones(clash):
    def run(metrics):
        reg = metrics.MetricsRegistry()
        reg.histogram("h", labels=("a",), buckets=[1, 2])
        try:
            if clash == "kind":
                reg.counter("h", labels=("a",))
            elif clash == "labels":
                reg.histogram("h", labels=("b",))
            elif clash == "ladder":
                reg.histogram("h", labels=("a",), buckets=[1, 3])
            elif clash == "name":
                reg.counter("1bad")
            elif clash == "label_name":
                reg.gauge("g", labels=("a-b",))
            elif clash == "arity":
                reg.get("h").labels("x", "y")
            else:
                reg.counter("c").inc(-1)
        except ValueError as e:
            return str(e)
        return None

    got, want = run(tmetrics), run(jmetrics)
    assert want is not None and got == want


@pytest.mark.parametrize("ladder", ["default", "custom", "exp"])
def test_histogram_buckets_and_quantiles_equal(ladder):
    buckets = {"default": None, "custom": [0.5, 2, 1, 10],
               "exp": jmetrics.exponential_buckets(1e-3, 3.0, 9)}[ladder]
    assert tmetrics.exponential_buckets(1e-3, 3.0, 9) == \
        jmetrics.exponential_buckets(1e-3, 3.0, 9)
    assert tmetrics.DEFAULT_LATENCY_BUCKETS == jmetrics.DEFAULT_LATENCY_BUCKETS
    vals = np.random.RandomState(3).exponential(0.8, 500)
    hs = []
    for metrics in (jmetrics, tmetrics):
        fam = metrics.MetricsRegistry().histogram("h", buckets=buckets)
        for v in vals:
            fam.observe(float(v))
        hs.append(fam.labels())
    j, t = hs
    assert t.buckets == j.buckets
    assert t.cumulative() == j.cumulative()
    assert (t.count, t.sum) == (j.count, j.sum)
    for q in np.linspace(0, 1, 21):
        assert t.quantile(float(q)) == j.quantile(float(q))
    with pytest.raises(ValueError):
        t.quantile(1.5)


def test_instrument_catalogue_is_the_jax_one():
    assert {n: tuple(s) for n, s in tins.specs().items()} == \
        {n: tuple(s) for n, s in jins.specs().items()}
    assert set(tins.__all__) == set(jins.__all__)
    assert tcatalog.docs_in_sync()


def _mask_process(text):
    """Exposition lines with the per-process families' values dropped:
    build info's labels name each package's own stack, and uptime and
    RSS are read at each package's own scrape."""
    out = []
    for line in text.splitlines():
        if line.startswith(("mx_build_info{", "mx_process_uptime_seconds ",
                            "mx_process_rss_bytes ")):
            line = line.split("{")[0].split(" ")[0]
        out.append(line)
    return out


def _drive_instruments(ins):
    for model, version in (("bert", 1), ("resnet", 2)):
        ins.serving_counter("requests", model, version).inc(3)
        ins.serving_counter("breaker_rejected", model, version).inc()
        ins.serving_queue_depth(model, version).set(2)
        ins.serving_occupancy(model, version).set(0.75)
        for v in (0.001, 0.02, 0.3):
            ins.serving_request_latency(model, version).observe(v)
        ins.breaker_state(model, version).set(2)
        ins.breaker_open_total(model, version).inc()
    ins.retry_total("serving.execute").inc(2)
    ins.retry_backoff_seconds_total("serving.execute").inc(0.25)
    ins.fault_injected_total("serving.execute").inc()
    ins.alerts_firing("serving_p99_slo", "page").set(1)
    ins.alerts_total("serving_p99_slo", "page").inc()


def test_global_exposition_equal_apart_from_build_info():
    texts = []
    for metrics, ins, _, _, _ in PKGS.values():
        metrics.get_registry().clear()
        _drive_instruments(ins)
        texts.append(metrics.get_registry().to_prometheus())
    j, t = texts
    assert "mx_build_info{" in t and "mx_serving_requests_total{" in t
    assert _mask_process(t) == _mask_process(j)


def test_build_info_keeps_the_label_names():
    child = tins.build_info()
    fam = tins._family("mx_build_info")
    labels = next(dict(zip(fam.labelnames, v)) for v, c in fam.children()
                  if c is child)
    assert tuple(labels) == ("version", "jax", "platform", "device_kind")
    import torch

    import mxnet_tpu_torch as mt

    assert labels["version"] == mt.__version__
    assert labels["jax"] == torch.__version__
    assert labels["platform"] in ("cpu", "uninitialized") \
        or labels["platform"].startswith("cuda ")
    tins.refresh_process_gauges()
    assert child.value == 1
    assert tins._child("mx_process_rss_bytes").value > 0


def test_cleared_registry_invalidates_instrument_caches():
    reg = tmetrics.get_registry()
    old = tins.retry_total("s")
    old.inc()
    reg.clear()
    new = tins.retry_total("s")
    assert new is not old and new.value == 0
    new.inc()
    assert 'mx_retry_total{site="s"} 1' in reg.to_prometheus()


def _span_tree(tel, prof, path):
    """Nested spans, a root span, a retroactive record and a flow pair
    inside one capture; returns the X events as (name, parent name,
    same trace as the outer span) and the flow phases."""
    prof.start()
    with tel.span("outer", cat="t", args={"k": 1}) as outer:
        with tel.span("inner", cat="t") as inner:
            assert (inner.trace_id, inner.parent_id) == \
                (outer.trace_id, outer.span_id)
            with tel.span("leaf", cat="t"):
                pass
        with tel.span("sibling", cat="t"):
            tel.record_complete("queue-wait", "t", inner.t0, 0.001,
                                trace_id=outer.trace_id,
                                parent_id=outer.span_id)
        root = tel.Span("fresh", root=True)
        assert root.parent_id is None and root.trace_id != outer.trace_id
        root.finish()
        tel.flow_start(outer.trace_id)
        tel.flow_end(outer.trace_id)
        tel.counter_event("lane", 3, cat="t")
    prof.stop()
    prof.dump(finished=True, filename=str(path))
    evs = json.load(open(path))["traceEvents"]
    xs = [e for e in evs if e["ph"] == "X" and e.get("cat") in ("t", "user")]
    by_span = {e["args"]["span_id"]: e["name"] for e in xs
               if "span_id" in e["args"]}
    top = next(e for e in xs if e["name"] == "outer")["args"]["trace_id"]
    tree = sorted((e["name"], by_span.get(e["args"].get("parent_id")),
                   e["args"]["trace_id"] == top) for e in xs)
    flows = [(e["ph"], e["id"] == top) for e in evs if e["ph"] in "sf"]
    lanes = [(e["name"], e["args"]) for e in evs if e["ph"] == "C"]
    return tree, flows, lanes


def test_span_nesting_and_parent_links_equal(tmp_path):
    j = _span_tree(jtel, jprof, tmp_path / "j.json")
    t = _span_tree(ttel, tprof, tmp_path / "t.json")
    assert t == j
    assert ("leaf", "inner", True) in t[0]
    assert ("fresh", None, False) in t[0]


def test_spans_are_noops_outside_a_capture():
    n0 = tprof.num_events()
    with ttel.span("nothing") as s:
        assert s is None
    ttel.record_complete("x", "t", 0.0, 1.0)
    assert tprof.num_events() == n0
    # with telemetry on, a span times and feeds its histogram even
    # without a capture
    h = tmetrics.MetricsRegistry().histogram("h").labels()
    ttel.enable()
    with ttel.span("timed", metric=h) as s:
        assert s is not None
    assert h.count == 1 and tprof.num_events() == n0


class _Clock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def _engine(alerts, metrics):
    reg = metrics.MetricsRegistry()
    eng = alerts.AlertEngine(registry=reg, clock=_Clock())
    alerts.serving_slo_rules(eng, p99_ms=50.0, queue_depth=4, for_s=2.0,
                             labels={"model": "m"})
    alerts.training_health_rules(eng)
    alerts.goodput_rules(eng, for_s=1.0)
    eng.add_rule("big_value", severity="info", predicate=lambda m: (
        m.value("mx_serving_queue_depth", agg="max") or 0) > 6)
    eng.add_rule("sum_gauge", metric="mx_breaker_state", op=">=",
                 threshold=2, agg="sum")
    return reg, eng


def _feed(reg, step):
    """The tick-`step` update of one series (the same in both
    packages)."""
    q = reg.gauge("mx_serving_queue_depth", labels=("model", "version"))
    q.labels("m", 1).set([0, 5, 5, 5, 8, 1, 0, 9, 9, 0][step])
    b = reg.gauge("mx_breaker_state", labels=("model", "version"))
    b.labels("m", 1).set([0, 1, 1, 2, 2, 0, 1, 1, 0, 0][step])
    b.labels("m", 2).set([0, 0, 1, 1, 0, 0, 1, 0, 0, 0][step])
    lat = reg.histogram("mx_serving_request_latency_seconds",
                        labels=("model", "version")).labels("m", 1)
    for v in [(), (0.01,), (0.2, 0.3), (0.2,), (), (0.001,) * 30, (),
              (1.0,) * 40, (), ()][step]:
        lat.observe(v)
    nf = reg.counter("mx_nonfinite_total")
    nf.inc([0, 0, 3, 0, 0, 1, 1, 0, 0, 0][step])
    ev = reg.counter("mx_health_events_total", labels=("kind",))
    ev.labels("grad-spike").inc([0, 1, 0, 0, 2, 0, 0, 0, 0, 0][step])
    if step >= 2:
        reg.gauge("mx_goodput_ratio").set(
            [0, 0, 0.5, 0.6, 0.95, 0.2, 0.2, 0.2, 0.99, 0.99][step])


def test_alert_engines_fire_the_same_rules_at_the_same_ticks():
    trails = []
    for metrics, _, alerts, _, _ in PKGS.values():
        reg, eng = _engine(alerts, metrics)
        trail = []
        for step in range(10):
            _feed(reg, step)
            eng._clock.t = step * 0.75
            trail.append([(e["rule"], e["state"], e["value"])
                          for e in eng.tick()])
        trail.append(sorted((r["name"], r["state"], r["last_value"])
                            for r in eng.rules()))
        trail.append([(e["rule"], e["state"]) for e in eng.events()])
        trail.append([r["name"] for r in eng.firing()])
        trails.append(trail)
    j, t = trails
    assert t == j
    assert sum(len(x) for x in t[:10]) >= 8  # the series does fire rules


def test_replacing_a_firing_rule_resolves_it_alike():
    outs = []
    for metrics, ins, alerts, _, _ in PKGS.values():
        reg = metrics.MetricsRegistry()
        eng = alerts.AlertEngine(registry=reg, clock=_Clock())
        eng.add_rule("r", metric="g", op=">", threshold=1)
        reg.gauge("g").set(2)
        fired = eng.tick()
        eng.add_rule("r", metric="g", op=">", threshold=5)
        eng.remove_rule("r")
        outs.append(([(e["rule"], e["state"]) for e in fired],
                     [(e["rule"], e["state"]) for e in eng.events()],
                     ins.alerts_firing("r", "warning").value))
        with pytest.raises(Exception, match="exactly one of"):
            alerts.Rule("bad")
    assert outs[1] == outs[0]


def test_deep_capture_action_says_not_ported():
    reg = tmetrics.MetricsRegistry()
    eng = talerts.AlertEngine(registry=reg, clock=_Clock())
    eng.add_rule("slo", metric="g", op=">", threshold=0,
                 action="deep_capture")
    reg.gauge("g").set(1)
    (ev,) = eng.tick()
    assert ev["state"] == "firing" and ev["action_status"] == "not ported"
    assert json.loads(eng.dumps())["firing"][0]["action"] == "deep_capture"


@pytest.mark.parametrize("knob, port_default", [
    ("MXNET_HEALTH_ALERT_TICK_MS", lambda: talerts._ALERT_TICK_S * 1e3),
    ("MXNET_GOODPUT_MIN", lambda: talerts._GOODPUT_MIN)])
def test_queued_alert_knobs_keep_the_jax_defaults(knob, port_default):
    """The two knobs stay queued until mxhealth (the ticker's caller) and
    mxgoodput (mx_goodput_ratio's writer) are ported; alerts.py uses the
    JAX package's defaults in their place, and goodput_rules' floor is
    the JAX one."""
    from mxnet_tpu.util import env as jenv
    from mxnet_tpu_torch.util import env as tenv

    assert port_default() == next(k for k in jenv.knobs()
                                  if k.name == knob).default
    assert knob in tenv.QUEUED_KNOBS
    assert knob not in {k.name for k in tenv.knobs()}
    rules = {}
    for pkg, (metrics, _, alerts, _, _) in PKGS.items():
        eng = alerts.goodput_rules(alerts.AlertEngine(
            registry=metrics.MetricsRegistry(), clock=_Clock()))
        rules[pkg] = [r for r in eng.rules()
                      if r["name"] == "goodput_below_min"]
    assert rules["port"] == rules["jax"] and rules["port"]
