"""mxnet_tpu_torch.resilience against the JAX package's resilience.

The circuit breaker walks the same states (and writes the same
instruments) under the same success/failure stream and clock; the
retry policy sleeps the same jittered delays and leaves the same
exhaustion trail; one ``MXNET_CHAOS_SPEC`` and seed fire at the same
calls in both packages.  Clocks and sleeps are replaced by fakes, so
nothing here waits.
"""
import os
import subprocess
import sys

import numpy as np
import pytest

from mxnet_tpu.resilience import breaker as jbreaker
from mxnet_tpu.resilience import chaos as jchaos
from mxnet_tpu.resilience import retry as jretry
from mxnet_tpu.telemetry import instruments as jins

from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.resilience import breaker as tbreaker
from mxnet_tpu_torch.resilience import chaos as tchaos
from mxnet_tpu_torch.resilience import retry as tretry
from mxnet_tpu_torch.telemetry import instruments as tins

PKGS = {"jax": (jbreaker, jretry, jchaos, jins),
        "port": (tbreaker, tretry, tchaos, tins)}


class _FakeTime:
    """Stands in for a module's ``time``: a clock the test advances and
    a sleep that only records."""

    def __init__(self):
        self.now = 1000.0
        self.slept = []

    def monotonic(self):
        return self.now

    def sleep(self, s):
        self.slept.append(s)
        self.now += s


@pytest.fixture(autouse=True)
def _no_plans():
    for _, _, chaos, _ in PKGS.values():
        with chaos._LOCK:
            chaos._PLANS.clear()
            chaos._recompute_active_locked()
        chaos.reset_stats()
    yield
    for _, _, chaos, _ in PKGS.values():
        with chaos._LOCK:
            chaos._PLANS.clear()
            chaos._recompute_active_locked()


# ---------------------------------------------------------------------------
# circuit breaker
# ---------------------------------------------------------------------------

def _stream(seed, n=300):
    """A seeded op stream: gates, feedback, abandoned probes, time."""
    rs = np.random.RandomState(seed)
    ops = ["allow", "would_allow", "success", "failure", "failure",
           "abandon", "wait", "long_wait"]
    return [ops[i] for i in rs.randint(0, len(ops), n)]


def _walk(breaker_mod, ins, ops, monkeypatch, name):
    clock = _FakeTime()
    monkeypatch.setattr(breaker_mod, "time", clock)
    b = breaker_mod.CircuitBreaker(name, 3, threshold=3, cooldown_s=0.5)
    trail = []
    for op in ops:
        if op == "allow":
            out = b.allow()
        elif op == "would_allow":
            out = b.would_allow()
        elif op == "success":
            out = b.record_success()
        elif op == "failure":
            out = b.record_failure()
        elif op == "abandon":
            out = b.abandon_probe()
        elif op == "wait":
            clock.now += 0.3
            out = None
        else:
            clock.now += 40.0  # past cooldown + the probe's staleness
            out = None
        trail.append((op, out, b.state()))
    snap = b.snapshot()
    return trail, snap, (ins.breaker_state(name, 3).value,
                         ins.breaker_open_total(name, 3).value)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_breaker_walks_the_same_states(seed, monkeypatch):
    ops = _stream(seed)
    name = f"breaker_parity_{seed}"
    got = [_walk(b, ins, ops, monkeypatch, name)
           for b, _, _, ins in PKGS.values()]
    assert got[1] == got[0]
    states = {s for _, _, s in got[1][0]}
    assert {"closed", "open", "half-open"} <= states


def test_breaker_configure_and_env_defaults(monkeypatch):
    monkeypatch.setenv("MXNET_BREAKER_THRESHOLD", "2")
    monkeypatch.setenv("MXNET_BREAKER_COOLDOWN_MS", "250")
    snaps = []
    for b, _, _, _ in PKGS.values():
        br = b.CircuitBreaker("cfg", 1)
        first = br.snapshot()
        br.configure(threshold=7)
        snaps.append((first, br.snapshot()))
    assert snaps[1] == snaps[0]
    assert snaps[1][0]["threshold"] == 2
    assert snaps[1][0]["cooldown_s"] == 0.25


# ---------------------------------------------------------------------------
# retry policy
# ---------------------------------------------------------------------------

def _retry_run(retry_mod, chaos, policy_kw, fails, monkeypatch,
               deadline_in=None, transient=True):
    clock = _FakeTime()
    monkeypatch.setattr(retry_mod, "time", clock)
    # under an active plan the jitter seed is the site's alone, as in a
    # chaos run: bit-identical replay in both packages
    monkeypatch.setattr(chaos, "_ACTIVE", True)
    calls, feedback = [], []

    def fn():
        calls.append(clock.now)
        if len(calls) <= fails:
            if transient:
                raise chaos.FaultInjected("serving.execute", len(calls))
            raise ValueError(f"deterministic bug #{len(calls)}")
        return "ok"

    pol = retry_mod.RetryPolicy(**policy_kw)
    deadline = None if deadline_in is None else clock.now + deadline_in
    try:
        out = pol.call(fn, "serving.execute", deadline=deadline,
                       on_failure=lambda e: feedback.append(type(e).__name__))
    except retry_mod.RetryExhausted as e:
        out = ("exhausted", e.site, e.attempts, str(e))
    except ValueError as e:
        out = ("raised", str(e))
    return out, clock.slept, feedback, len(calls)


RETRY_CASES = {
    "recovers": (dict(max_attempts=4, base_s=0.05, max_s=2.0,
                      budget_s=10.0), 2, None, True),
    "max_attempts": (dict(max_attempts=3, base_s=0.05, max_s=2.0,
                          budget_s=10.0), 9, None, True),
    "budget": (dict(max_attempts=9, base_s=0.05, max_s=2.0,
                    budget_s=0.3), 9, None, True),
    "deadline": (dict(max_attempts=9, base_s=0.05, max_s=2.0,
                      budget_s=10.0), 9, 0.2, True),
    "capped": (dict(max_attempts=8, base_s=0.5, max_s=1.0,
                    budget_s=100.0, jitter=0.25), 9, None, True),
    "not_transient": (dict(max_attempts=5, base_s=0.05, max_s=2.0,
                           budget_s=10.0), 3, None, False),
}


@pytest.mark.parametrize("case", sorted(RETRY_CASES))
def test_retry_delays_and_exhaustion_trail_equal(case, monkeypatch):
    kw, fails, deadline_in, transient = RETRY_CASES[case]
    got = [_retry_run(r, c, kw, fails, monkeypatch, deadline_in, transient)
           for _, r, c, _ in PKGS.values()]
    assert got[1] == got[0]
    out, slept = got[1][0], got[1][1]
    if case == "recovers":
        assert out == "ok" and len(slept) == 2
    elif case == "not_transient":
        assert out[0] == "raised" and slept == []
    else:
        assert out[0] == "exhausted"


def test_retry_defaults_and_counters(monkeypatch):
    for k, v in (("MXNET_RETRY_MAX_ATTEMPTS", "4"),
                 ("MXNET_RETRY_BASE_MS", "20"), ("MXNET_RETRY_MAX_MS", "80"),
                 ("MXNET_RETRY_BUDGET_MS", "1000")):
        monkeypatch.setenv(k, v)
    pols = [r.RetryPolicy() for _, r, _, _ in PKGS.values()]
    assert [(p.max_attempts, p.base_s, p.max_s, p.budget_s) for p in pols] \
        == [(4, 0.02, 0.08, 1.0)] * 2
    assert [pols[1].delay_s(a) for a in range(1, 6)] == \
        [pols[0].delay_s(a) for a in range(1, 6)]
    counts = []
    for _, r, c, ins in PKGS.values():
        site = "parity.counter.site"
        before = ins.retry_total(site).value
        _retry_run(r, c, dict(max_attempts=3, base_s=0.01, max_s=1.0,
                              budget_s=10.0), 2, monkeypatch)
        counts.append(ins.retry_total("serving.execute").value >= 2)
        counts.append(ins.retry_total(site).value == before)
    assert all(counts)
    for _, r, c, _ in PKGS.values():
        assert r.is_transient(c.FaultInjected("k", 1))
        assert not r.is_transient(ValueError("x"))
        assert r.is_transient(ValueError("x"), retry_on=(ValueError,))


# ---------------------------------------------------------------------------
# chaos
# ---------------------------------------------------------------------------

def _fire_pattern(chaos, spec, seed, calls=40):
    plans = chaos._parse_spec(spec, seed)
    with chaos._LOCK:
        chaos._PLANS.extend(plans)
        for pl in plans:
            chaos._CALLS[pl.kind] = 0
        chaos._recompute_active_locked()
    pattern = []
    try:
        for i in range(calls):
            kind = "serving.execute" if i % 3 else "serving.artifact"
            try:
                r = chaos.check(kind)
                pattern.append((kind, r))
            except chaos.FaultInjected as e:
                pattern.append((kind, "fired", e.nth))
    finally:
        with chaos._LOCK:
            for pl in plans:
                chaos._PLANS.remove(pl)
            chaos._recompute_active_locked()
    return pattern, chaos.stats()


CHAOS_SPECS = ["serving.execute@3", "serving.execute@x4",
               "serving.execute@p0.3", "serving.artifact@p0.5",
               "serving.artifact@2,serving.execute@p0.4:error",
               "serving.execute@5:die,serving.artifact@x2:corrupt",
               "serving.execute@x3:rank=0"]


@pytest.mark.parametrize("spec", CHAOS_SPECS)
@pytest.mark.parametrize("seed", [0, 7])
def test_chaos_spec_fires_at_the_same_calls(spec, seed, monkeypatch):
    monkeypatch.setenv("DMLC_WORKER_ID", "0")
    got = []
    for _, _, chaos, _ in PKGS.values():
        chaos.reset_stats()
        got.append(_fire_pattern(chaos, spec, seed))
    assert got[1] == got[0]
    assert any(len(p) == 3 or p[1] in ("die", "corrupt")
               for p in got[1][0])


@pytest.mark.parametrize("spec", ["serving.execute", "serving.execute@3:x=1",
                                  "serving.execute@3:boom",
                                  "serving.execute@q3"])
def test_chaos_spec_errors_are_the_jax_ones(spec):
    errs = []
    for _, _, chaos, _ in PKGS.values():
        try:
            chaos._parse_spec(spec, 0)
            errs.append(None)
        except Exception as e:  # noqa: BLE001 — compared below
            errs.append((type(e).__name__, str(e)))
    assert errs[0] is not None and errs[1] == errs[0]


def test_inject_scopes_selectors_and_transport_equal():
    outs = []
    for _, _, chaos, ins in PKGS.values():
        trail = []
        before = ins.fault_injected_total("serving.execute").value
        with chaos.inject("serving.execute", at=2) as a, \
                chaos.inject("serving.execute", times=2) as b:
            assert chaos.active()
            exported = chaos.export_plans("serving.execute")
            for _ in range(5):
                try:
                    trail.append(chaos.check("serving.execute"))
                except chaos.FaultInjected as e:
                    trail.append(("fired", e.nth))
            trail.append((a.fired, b.fired))
        assert not chaos.active()
        chaos.install_plans(exported)
        trail.append(chaos.active())
        with chaos._LOCK:
            chaos._PLANS.clear()
            chaos._recompute_active_locked()
        trail.append(ins.fault_injected_total("serving.execute").value
                     - before)
        trail.append(exported)
        outs.append(trail)
    assert outs[1] == outs[0]


def test_preempt_action_raises_in_the_port():
    with tchaos.inject("trainer.preempt", at=1):
        with pytest.raises(MXNetError, match="not ported"):
            tchaos.check("trainer.preempt")


def test_env_spec_installs_plans_at_import():
    code = ("from mxnet_tpu_torch.resilience import chaos\n"
            "assert chaos.active()\n"
            "out = []\n"
            "for _ in range(4):\n"
            "    try:\n"
            "        out.append(chaos.check('serving.execute'))\n"
            "    except chaos.FaultInjected as e:\n"
            "        out.append(e.nth)\n"
            "print(out)\n")
    env = dict(os.environ, MXNET_CHAOS="1",
               MXNET_CHAOS_SPEC="serving.execute@x2", MXNET_CHAOS_SEED="3")
    r = subprocess.run([sys.executable, "-c", code], env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr[-2000:]
    assert r.stdout.strip().splitlines()[-1] == "[1, 2, None, None]"
