"""The port's profiler (``mxnet_tpu_torch/profiler.py`` and its hook in
``ops/registry.py::invoke``) against the JAX package's on the CPU.

The same fixed list of registry ops, run twice, gives the same
``(name, count)`` rows in ``dumps()`` from both packages, and the dumped
chrome events have the same keys and ``ph`` kinds.  Both packages'
``dump(finished=)`` clears only what it wrote, ``dumps(reset=)`` only the
aggregate table, ``set_config`` raises ``ValueError`` on an unknown key,
``Counter`` emits only while running (and counts right from several
threads), ``Task``/``scope`` record durations and ``Event``/``instant``
instant markers.  The port's device trace (``start_xla_trace``, a
``torch.profiler`` session; CPU activities here) refuses a second start
and writes a chrome trace that parses; the JAX one refuses a second
start too.  The registry's hook costs one branch while the profiler is
off: ``profile_op`` is not entered.  ``MXNET_PROFILER_AUTOSTART`` starts
it at import.
"""
import importlib
import json
import threading

import numpy as np
import pytest
import torch

import mxnet_tpu as mx

import mxnet_tpu_torch as mt
from mxnet_tpu_torch.base import MXNetError


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


PKGS = {"jax": (mx, mx.cpu), "port": (mt, mt.cpu)}


@pytest.fixture(params=sorted(PKGS))
def pkg(request, tmp_path):
    """One package's profiler, stopped and emptied before and after."""
    m, ctx = PKGS[request.param]
    p = m.profiler

    def clear():
        p.stop()
        p.dump(finished=True, filename=str(tmp_path / "clear.json"))
        p.dumps(reset=True)
    clear()
    p.set_config(filename=str(tmp_path / "profile.json"))
    yield m, ctx()
    clear()
    p.set_config(filename="profile.json")


def _ops(m, ctx):
    """A fixed list of registry ops on seeded inputs."""
    rng = np.random.RandomState(0)
    a = m.nd.array(rng.rand(4, 8).astype(np.float32), ctx=ctx)
    w = m.nd.array(rng.rand(3, 8).astype(np.float32), ctx=ctx)
    for _ in range(2):
        c = (a + a) * a
        d = m.nd.relu(c - 0.5)
        e = m.nd.FullyConnected(d, w, num_hidden=3, no_bias=True)
        f = m.nd.softmax(e)
        m.nd.dot(a, w.T)
        m.nd.exp(f).sum().asnumpy()


def _rows(table):
    return sorted(tuple(line.split()[:2]) for line in table.splitlines()[1:])


def _run_ops(m, ctx):
    p = m.profiler
    p.start()
    try:
        _ops(m, ctx)
    finally:
        p.stop()
    with open(p.dump(finished=False)) as f:
        events = json.load(f)["traceEvents"]
    return _rows(p.dumps()), events


def test_same_ops_give_the_same_rows_and_events(tmp_path):
    got = {}
    for name, (m, ctx) in PKGS.items():
        p = m.profiler
        p.stop()
        p.dump(finished=True, filename=str(tmp_path / f"{name}0.json"))
        p.dumps(reset=True)
        p.set_config(filename=str(tmp_path / f"{name}.json"))
        try:
            got[name] = _run_ops(m, ctx())
        finally:
            p.dump(finished=True)
            p.dumps(reset=True)
            p.set_config(filename="profile.json")
    (jrows, jev), (trows, tev) = got["jax"], got["port"]
    assert trows == jrows
    assert ("FullyConnected", "2") in trows and ("broadcast_add", "2") in trows

    def kinds(events):
        return sorted({(e["ph"], e["cat"], tuple(sorted(e))) for e in events})
    assert kinds(tev) == kinds(jev)
    assert sorted(e["name"] for e in tev) == sorted(e["name"] for e in jev)


def test_dump_clears_only_what_it_wrote_and_dumps_reset(pkg, tmp_path):
    m, ctx = pkg
    p = m.profiler
    p.start()
    with p.scope("a"):
        pass
    path = p.dump(finished=False)
    assert p.num_events() == 1
    with open(path) as f:
        assert [e["name"] for e in json.load(f)["traceEvents"]] == ["a"]
    _ops(m, ctx)
    p.stop()
    n = p.num_events()
    table = p.dumps(reset=True)
    assert len(table.splitlines()) > 1
    assert p.num_events() == n  # reset clears the aggregate table only
    assert len(p.dumps().splitlines()) == 1
    p.dump(finished=True)
    assert p.num_events() == 0
    p.start()
    p.instant("after")
    p.stop()
    assert p.num_events() == 1


def test_set_config_rejects_unknown_keys(pkg):
    m, _ = pkg
    with pytest.raises(ValueError, match="profile_memroy"):
        m.profiler.set_config(profile_memroy=True)
    m.profiler.set_config(profile_memory=False, aggregate_stats=True)


def test_counter_task_event_scope_and_instant(pkg):
    m, _ = pkg
    p = m.profiler
    c = p.Counter("c", value=0)  # not running: no event
    c.increment(2)
    assert c.value == 2 and p.num_events() == 0
    assert p.instant("off") is False
    p.start()
    c += 3
    c -= 1
    c.value = 10

    def bump():
        for _ in range(200):
            c.increment()
    ts = [threading.Thread(target=bump) for _ in range(4)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=30)
    assert not any(t.is_alive() for t in ts)
    assert c.value == 10 + 800
    task = p.Task("t")
    task.start()
    task.stop()
    task.stop()  # a second stop records nothing
    ev = p.Event("e")
    ev.mark(k=1)
    ev.start()
    ev.stop()
    with p.scope("s", "cat"):
        pass
    assert p.instant("on", args={"x": 1}) is True
    p.stop()
    with open(p.dump(finished=False)) as f:
        events = json.load(f)["traceEvents"]
    by = [(e["name"], e["ph"]) for e in events]
    assert by.count(("c", "C")) == 3 + 800
    assert [e["args"]["c"] for e in events if e["ph"] == "C"][-1] == 810
    assert ("t", "X") in by and by.count(("t", "X")) == 1
    assert by.count(("e", "i")) == 3 and ("s", "X") in by
    assert ("on", "i") in by and ("off", "i") not in by
    edges = [e.get("args") for e in events if e["name"] == "e"]
    assert edges == [{"k": 1}, {"edge": "start"}, {"edge": "stop"}]


def test_port_device_trace(tmp_path):
    p = mt.profiler
    logdir = str(tmp_path / "trace")
    assert p.start_xla_trace(logdir) == logdir
    try:
        with pytest.raises(MXNetError, match="already running"):
            p.start_xla_trace(str(tmp_path / "other"))
        x = torch.ones(64, 64)
        (x @ x).sum()
    finally:
        path = p.stop_xla_trace()
    assert path.startswith(logdir) and path.endswith(".json")
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    assert any("mm" in str(e.get("name", "")) for e in events)
    assert p.stop_xla_trace() is None
    # the slot is free again
    p.start_xla_trace(logdir)
    assert p.stop_xla_trace() != path


def test_port_trace_leaves_out_its_warm_up(tmp_path):
    """The host ops inside the warm-up range go; the caller's stay."""
    from torch.profiler import ProfilerActivity, profile

    p = mt.profiler
    x = torch.ones(32, 32)
    prof = profile(activities=[ProfilerActivity.CPU])
    prof.start()
    with torch.profiler.record_function(p._WARMUP):
        torch.sin(x)
    torch.cos(x)
    prof.stop()
    path = str(tmp_path / "t.json")
    prof.export_chrome_trace(path)
    p._drop_warmup(path)
    with open(path) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert "aten::cos" in names
    assert "aten::sin" not in names and p._WARMUP not in names


def test_port_trace_drops_the_warm_up_launches(tmp_path):
    """Device events and flows of launches made inside the warm-up go by
    correlation id; those of other threads or later launches stay."""
    p = mt.profiler
    w = p._WARMUP
    events = [
        {"ph": "X", "cat": "user_annotation", "name": w, "pid": 1, "tid": 1,
         "ts": 10, "dur": 10},
        {"ph": "X", "cat": "gpu_user_annotation", "name": w, "pid": 0,
         "tid": 7, "ts": 12, "dur": 9},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
         "pid": 1, "tid": 1, "ts": 11, "dur": 1, "args": {"correlation": 5}},
        {"ph": "X", "cat": "kernel", "name": "spin_kernel", "pid": 0,
         "tid": 7, "ts": 13, "dur": 1, "args": {"correlation": 5}},
        {"ph": "s", "cat": "ac2g", "name": "ac2g", "id": 5, "pid": 1,
         "tid": 1, "ts": 11},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
         "pid": 1, "tid": 2, "ts": 12, "dur": 1, "args": {"correlation": 6}},
        {"ph": "X", "cat": "kernel", "name": "other_thread", "pid": 0,
         "tid": 7, "ts": 22, "dur": 1, "args": {"correlation": 6}},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
         "pid": 1, "tid": 1, "ts": 30, "dur": 1, "args": {"correlation": 8}},
        {"ph": "X", "cat": "kernel", "name": "mine", "pid": 0, "tid": 7,
         "ts": 31, "dur": 1, "args": {"correlation": 8}},
        {"ph": "f", "cat": "ac2g", "name": "ac2g", "id": 8, "pid": 0,
         "tid": 7, "ts": 31},
    ]
    path = str(tmp_path / "t.json")
    with open(path, "w") as f:
        json.dump({"traceEvents": events}, f)
    p._drop_warmup(path)
    with open(path) as f:
        kept = json.load(f)["traceEvents"]
    assert [e["name"] for e in kept] == [
        "cudaLaunchKernel", "other_thread", "cudaLaunchKernel", "mine",
        "ac2g"]
    assert [e.get("args", {}).get("correlation", e.get("id"))
            for e in kept] == [6, 6, 8, 8, 8]


def test_jax_device_trace_refuses_a_second_start(tmp_path):
    from mxnet_tpu.telemetry.mxtriage.capture import CaptureBusy

    p = mx.profiler
    p.start_xla_trace(str(tmp_path / "jtrace"))
    try:
        with pytest.raises(CaptureBusy):
            p.start_xla_trace(str(tmp_path / "other"))
    finally:
        p.stop_xla_trace()


def test_registry_hook_is_one_branch_while_off(monkeypatch):
    from mxnet_tpu_torch import profiler

    def entered(name):
        raise AssertionError(f"profile_op entered for {name}")
    monkeypatch.setattr(profiler, "profile_op", entered)
    a = mt.nd.ones((2, 2), ctx=mt.cpu())
    assert float((a + a).sum().asnumpy()) == 8.0
    profiler.start()
    try:
        with pytest.raises(AssertionError, match="broadcast_add"):
            a + a
    finally:
        profiler.stop()


def test_autostart_knob(monkeypatch):
    from mxnet_tpu_torch import profiler

    monkeypatch.setenv("MXNET_PROFILER_AUTOSTART", "1")
    try:
        importlib.reload(profiler)
        assert profiler.is_running()
    finally:
        profiler.stop()
        monkeypatch.delenv("MXNET_PROFILER_AUTOSTART")
        importlib.reload(profiler)
    assert not profiler.is_running()
