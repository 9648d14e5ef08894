"""Profiler: chrome-trace host-side op records and a device trace
(counterpart of ``mxnet_tpu/profiler.py``; ref: src/profiler/profiler.cc,
python/mxnet/profiler.py, src/c_api/c_api_profile.cc).

Per-op start/stop records are taken at the dispatch site
(``ops/registry.py::invoke``), with a chrome://tracing JSON dump, an
aggregate stats table and the custom task/event/counter API.  The op
records are host dispatch time: a CUDA launch returns before the card
runs it, so a record is the launch overhead (the reference's engine
dispatch lane), and the hook never synchronises the device.  A CUDA
graph's replay runs no Python, so a captured step records its ops once,
while it is captured, and nothing on replay; recording inside a capture
touches no device state, so the profiler can stay on while steps are
captured.  The device timeline comes from :func:`start_xla_trace` /
:func:`stop_xla_trace` (names kept from the JAX package), a
``torch.profiler`` session with CPU and CUDA activities exported as a
chrome trace.
"""
from __future__ import annotations

import contextlib
import json
import os
import tempfile
import threading
import time
from collections import defaultdict
from typing import Dict, List, Optional

import torch

from .base import MXNetError
from .util import env

__all__ = [
    "set_config", "start", "stop", "dump", "dumps", "profile_op",
    "Task", "Event", "Counter", "scope", "start_xla_trace", "stop_xla_trace",
    "append_event", "instant", "num_events",
]

_lock = threading.Lock()
_dump_lock = threading.Lock()  # serializes dump(): two concurrent
# finished=True dumps must not each clear their snapshot's prefix
# (events recorded between the snapshots would vanish from both files)
_config = {
    "profile_all": False,
    "profile_symbolic": True,
    "profile_imperative": True,
    "profile_memory": False,
    "profile_api": False,
    "filename": "profile.json",
    "aggregate_stats": False,
}
_running = False
_events: List[dict] = []
_agg: Dict[str, List[float]] = defaultdict(list)


def set_config(**kwargs):
    """Set profiler config knobs; unknown keys raise (a typo like
    ``profile_memroy`` must fail loudly, not silently no-op)."""
    unknown = set(kwargs) - set(_config)
    if unknown:
        raise ValueError(
            f"profiler.set_config: unknown key(s) "
            f"{sorted(unknown)}; valid keys: {sorted(_config)}")
    with _lock:
        _config.update(kwargs)


def start():
    global _running
    _running = True


def stop():
    global _running
    _running = False


def is_running() -> bool:
    return _running


def append_event(ev: dict) -> bool:
    """Append one raw chrome-trace event while the profiler is running
    (the hook the telemetry tracing layer emits spans through).
    Returns whether the event was recorded."""
    if not _running:
        return False
    with _lock:
        _events.append(ev)
    return True


def num_events() -> int:
    with _lock:
        return len(_events)


def instant(name: str, domain: str = "user",
            args: Optional[dict] = None) -> bool:
    """Record an instant marker (chrome ``"ph": "i"``, thread scope)."""
    ev = {"name": name, "ph": "i", "s": "t", "cat": domain,
          "ts": time.perf_counter() * 1e6, "pid": os.getpid(),
          "tid": threading.get_ident()}
    if args:
        ev["args"] = args
    return append_event(ev)


if env.get_bool("MXNET_PROFILER_AUTOSTART"):
    start()


@contextlib.contextmanager
def profile_op(name: str):
    """Hot-path hook used by ops.registry.invoke.

    Records host dispatch time (device time lives in the device trace of
    :func:`start_xla_trace`: a launch is asynchronous, so wall time here
    is launch overhead, the reference's 'engine dispatch' lane).
    """
    if not _running:
        yield
        return
    t0 = time.perf_counter()
    try:
        yield
    finally:
        t1 = time.perf_counter()
        with _lock:
            _events.append({
                "name": name, "ph": "X", "cat": "operator",
                "ts": t0 * 1e6, "dur": (t1 - t0) * 1e6,
                "pid": os.getpid(), "tid": threading.get_ident(),
            })
            _agg[name].append(t1 - t0)


@contextlib.contextmanager
def scope(name: str, category: str = "user"):
    t0 = time.perf_counter()
    try:
        yield
    finally:
        t1 = time.perf_counter()
        with _lock:
            _events.append({
                "name": name, "ph": "X", "cat": category,
                "ts": t0 * 1e6, "dur": (t1 - t0) * 1e6,
                "pid": os.getpid(), "tid": threading.get_ident(),
            })


class Task:
    """ref: profiler.ProfileTask."""

    def __init__(self, name: str, domain: str = "user"):
        self.name, self.domain = name, domain
        self._t0 = None

    def start(self):
        self._t0 = time.perf_counter()

    def stop(self):
        if self._t0 is None:
            return
        t1 = time.perf_counter()
        with _lock:
            _events.append({"name": self.name, "ph": "X", "cat": self.domain,
                            "ts": self._t0 * 1e6, "dur": (t1 - self._t0) * 1e6,
                            "pid": os.getpid(), "tid": threading.get_ident()})
        self._t0 = None


class Event:
    """ref: profiler.ProfileEvent — an INSTANT marker, not a duration.

    ``Event("epoch").mark()`` drops a chrome-trace instant event
    (``"ph": "i"``) at the current time.  ``start()``/``stop()`` are
    kept for Task-style call sites but each records an instant marker
    (tagged with the edge in ``args``) rather than accumulating a
    duration — use ``Task`` for timed ranges.
    """

    def __init__(self, name: str, domain: str = "user"):
        self.name, self.domain = name, domain

    def mark(self, **args):
        instant(self.name, self.domain, args or None)

    def start(self):
        instant(self.name, self.domain, {"edge": "start"})

    def stop(self):
        instant(self.name, self.domain, {"edge": "stop"})


class Counter:
    """ref: profiler.ProfileCounter.

    Thread-safe: increment/decrement are atomic read-modify-writes (the
    serving layer bumps counters from admission, batcher, and worker
    threads concurrently).  Trace events are only recorded while the
    profiler is running — a hot-path counter must not grow the event
    buffer without bound in a long-lived server process; the live value
    itself is always maintained and readable via `.value`.
    """

    def __init__(self, name: str, domain: str = "user", value: int = 0):
        self.name, self.domain = name, domain
        self._value = value
        self._vlock = threading.Lock()
        self._emit(value)

    def _emit(self, v):
        if not _running:
            return
        with _lock:
            _events.append({"name": self.name, "ph": "C", "cat": self.domain,
                            "ts": time.perf_counter() * 1e6,
                            "pid": os.getpid(),
                            "args": {self.name: v}})

    @property
    def value(self):
        return self._value

    @value.setter
    def value(self, v):
        self.set_value(v)

    def set_value(self, v):
        with self._vlock:
            self._value = v
        self._emit(v)

    def increment(self, d=1):
        with self._vlock:
            self._value += d
            v = self._value
        self._emit(v)

    def decrement(self, d=1):
        self.increment(-d)

    def __iadd__(self, d):
        self.increment(d)
        return self

    def __isub__(self, d):
        self.decrement(d)
        return self


def dumps(reset: bool = False) -> str:
    """Aggregate per-op stats table (ref: AggregateStats::Dump).

    ``reset=True`` clears the AGGREGATE table only — trace events are
    untouched (their lifetime belongs to ``dump(finished=True)``).
    """
    with _lock:
        rows = []
        for name, ts in sorted(_agg.items(), key=lambda kv: -sum(kv[1])):
            n = len(ts)
            tot = sum(ts) * 1e3
            rows.append(f"{name:<40s} {n:>8d} {tot:>12.3f} "
                        f"{tot / n:>10.4f} {min(ts) * 1e3:>10.4f} {max(ts) * 1e3:>10.4f}")
        if reset:
            _agg.clear()
    header = (f"{'Name':<40s} {'Count':>8s} {'Total(ms)':>12s} "
              f"{'Mean(ms)':>10s} {'Min(ms)':>10s} {'Max(ms)':>10s}")
    return "\n".join([header] + rows)


def dump(finished: bool = True, filename: Optional[str] = None):
    """Write chrome://tracing JSON.

    ``finished=True`` (the default) CLEARS the event buffer after the
    write — a long-lived process that dumps periodically must not
    re-dump an ever-growing buffer.  Pass ``finished=False`` to keep
    accumulating into the same capture across dumps.
    """
    fn = filename or _config["filename"]
    with _dump_lock:
        with _lock:
            data = {"traceEvents": list(_events),
                    "displayTimeUnit": "ms"}
        with open(fn, "w") as f:
            json.dump(data, f)
        if finished:
            # clear only AFTER a successful write — a bad path/full
            # disk must not destroy the capture (events recorded
            # between the snapshot above and here land in the next
            # dump)
            with _lock:
                del _events[:len(data["traceEvents"])]
    return fn


# the running device trace: (torch.profiler.profile, logdir), or None
_trace = None
_trace_count = 0
# the range around each warm-up, and its kernels: on an H100 a trace
# started late in a long process (after hundreds of earlier kernels and
# profiler sessions) lost 37 to 47 of the kernels launched right after
# its start; 256 kernels of a few hundred cycles take their place
_WARMUP = "mx::trace_warmup"
_WARMUP_KERNELS = 256
_HOST_CATS = ("cpu_op", "cuda_runtime", "cuda_driver", "user_annotation",
              "python_function")


def _warm_up() -> None:
    """Short device work inside the trace, after its start and before its
    stop; :func:`_drop_warmup` takes it out of the exported file."""
    torch.cuda.synchronize()
    with torch.profiler.record_function(_WARMUP):
        for _ in range(_WARMUP_KERNELS):
            torch.cuda._sleep(1000)
        torch.cuda.synchronize()


def _drop_warmup(path: str) -> None:
    """Remove the warm-up ranges from an exported chrome trace: the host
    events of their thread inside them, and the device events and flow
    arrows of the launches made there (matched by correlation id)."""
    with open(path) as f:
        data = json.load(f)
    events = data["traceEvents"]
    spans = [(e.get("pid"), e.get("tid"), e["ts"], e["ts"] + e["dur"])
             for e in events if e.get("name") == _WARMUP
             and e.get("cat") == "user_annotation"]
    if not spans:
        return

    def inside(e):
        return e.get("cat") in _HOST_CATS and any(
            (e.get("pid"), e.get("tid")) == (pid, tid) and lo <= e["ts"] <= hi
            for pid, tid, lo, hi in spans)

    corr = {e["args"]["correlation"] for e in events
            if inside(e) and "correlation" in e.get("args", {})}

    def warm(e):
        return (e.get("name") == _WARMUP or inside(e)
                or e.get("args", {}).get("correlation") in corr
                or (e.get("cat") == "ac2g" and e.get("id") in corr))

    data["traceEvents"] = [e for e in events if not warm(e)]
    with open(path, "w") as f:
        json.dump(data, f)


def start_xla_trace(logdir: Optional[str] = None) -> str:
    """Start the device-side timeline: a ``torch.profiler`` session with
    CPU activities and, when CUDA is available, CUDA activities (each
    kernel with its name and device time; a CUDA graph's replayed
    kernels too).  On a card the session opens with a short warm-up
    (256 tiny kernels and a synchronize) so that no kernel of the
    caller's work is lost at the start; the exported file leaves it out.
    One trace at a time in a process: a second start raises.  Returns
    the directory :func:`stop_xla_trace` writes into (default
    ``<tempdir>/mx_xla_trace``).  The JAX package admits it through
    ``telemetry.mxtriage``'s capture slot, which ROADMAP queue A item 10
    ports."""
    global _trace
    from torch.profiler import ProfilerActivity, profile

    logdir = logdir or os.path.join(tempfile.gettempdir(), "mx_xla_trace")
    cuda = torch.cuda.is_available()
    acts = [ProfilerActivity.CPU]
    if cuda:
        acts.append(ProfilerActivity.CUDA)
    with _lock:
        if _trace is not None:
            raise MXNetError(f"a device trace is already running (into "
                             f"{_trace[1]}); one trace per process")
        prof = profile(activities=acts)
        prof.start()
        _trace = (prof, logdir)
    if cuda:
        _warm_up()
    return logdir


def stop_xla_trace() -> Optional[str]:
    """Stop the device trace and write it as chrome-trace JSON into its
    directory; returns the file's path (None when no trace runs).  Waits
    for the card first, so that every kernel launched inside the trace
    is in it, and closes with the same warm-up as the start (left out of
    the file)."""
    global _trace, _trace_count
    with _lock:
        if _trace is None:
            return None
        (prof, logdir), _trace = _trace, None
        _trace_count += 1
        n = _trace_count
    if torch.cuda.is_available():
        _warm_up()
    prof.stop()
    os.makedirs(logdir, exist_ok=True)
    path = os.path.join(logdir, f"trace_{os.getpid()}_{n}.json")
    prof.export_chrome_trace(path)
    _drop_warmup(path)
    return path
