"""Span tracing: trace/span IDs with parent links, emitted into the
profiler's chrome-trace buffer.

Counterpart of ``mxnet_tpu/telemetry/tracing.py``.  A *span* is one
timed phase (`"ph": "X"`) carrying `trace_id`, `span_id`, and
`parent_id` in its `args`, so chrome://tracing shows the nesting and a
request or a step can be reassembled from the flat event list.
Cross-thread hand-offs (a serving request enqueued on one thread,
executed by the batcher thread) are linked with chrome flow arrows
(`"ph": "s"` / `"ph": "f"`) keyed by the trace id.

Enablement is ONE module-level flag (`_ENABLED`, from
``MXNET_TELEMETRY``): instrument sites on hot paths read it directly so
the disabled cost is a single predicate check.  Span *events* are only
appended while the profiler is running (``profiler.start()`` ..
``profiler.dump()`` bounds the buffer); metric side-effects
(histograms) follow the flag alone, so a long-lived server can scrape
`/metrics` without ever starting a trace capture.

Thread-local context (`contextvars`) carries the current span so
nested `with span(...)` blocks parent automatically; cross-thread
parents are passed explicitly (`trace_id=` / `parent_id=`).

The JAX module's mxprof flight-recorder sink and the rank stamp of
multi-rank dumps come with mxprof and the collectives' telemetry
(ROADMAP queue A item 10).
"""
from __future__ import annotations

import contextlib
import contextvars
import itertools
import os
import threading
import time
from typing import Optional

from .. import profiler as _prof
from ..util import env

__all__ = [
    "enable", "disable", "enabled", "Span", "span", "current_span",
    "new_trace_id", "record_complete", "flow_start", "flow_end",
    "counter_event",
]

_ENABLED = env.get_bool("MXNET_TELEMETRY")

_span_ctx: "contextvars.ContextVar[Optional[Span]]" = \
    contextvars.ContextVar("mx_telemetry_span", default=None)

# span ids only need process-uniqueness; trace ids cross processes
# (they name a request end-to-end) so they get random 64-bit hex
_span_seq = itertools.count(1)
_seq_lock = threading.Lock()


def enable() -> None:
    """Turn instrumentation on (metrics always; trace events while the
    profiler is running)."""
    global _ENABLED
    _ENABLED = True


def disable() -> None:
    global _ENABLED
    _ENABLED = False


def enabled() -> bool:
    return _ENABLED


def new_trace_id() -> str:
    return os.urandom(8).hex()


def _next_span_id() -> str:
    with _seq_lock:
        return f"{next(_span_seq):x}"


class Span:
    """One timed phase.  Use the `span()` context manager on a single
    thread; construct directly (then `finish()`) for hand-built spans
    that start and end on different call paths."""

    __slots__ = ("name", "cat", "trace_id", "span_id", "parent_id",
                 "args", "t0", "duration", "_token", "_metric")

    def __init__(self, name: str, cat: str = "user",
                 trace_id: Optional[str] = None,
                 parent_id: Optional[str] = None,
                 args: Optional[dict] = None, metric=None,
                 root: bool = False):
        parent = None if root else _span_ctx.get()
        if parent_id is None and parent is not None:
            parent_id = parent.span_id
            if trace_id is None:
                trace_id = parent.trace_id
        self.name, self.cat = name, cat
        self.trace_id = trace_id or new_trace_id()
        self.span_id = _next_span_id()
        self.parent_id = parent_id
        self.args = args
        self.t0 = time.perf_counter()
        self.duration = None
        self._token = None
        self._metric = metric

    def attach(self) -> "Span":
        """Make this span the ambient parent for the current context."""
        self._token = _span_ctx.set(self)
        return self

    def finish(self, end: Optional[float] = None) -> float:
        """Close the span: record the chrome event (if capturing) and
        observe the attached histogram (if telemetry is enabled).
        Returns the duration in seconds."""
        t1 = time.perf_counter() if end is None else end
        self.duration = t1 - self.t0
        if self._token is not None:
            try:
                _span_ctx.reset(self._token)
            except ValueError:
                pass  # finished on a different thread than attach()ed
            self._token = None
        record_complete(self.name, self.cat, self.t0, self.duration,
                        trace_id=self.trace_id, span_id=self.span_id,
                        parent_id=self.parent_id, args=self.args)
        if _ENABLED and self._metric is not None:
            self._metric.observe(self.duration)
        return self.duration


@contextlib.contextmanager
def span(name: str, cat: str = "user", trace_id: Optional[str] = None,
         parent_id: Optional[str] = None, args: Optional[dict] = None,
         metric=None):
    """`with span("forward", cat="training"): ...` — no-op (yields
    None) when neither telemetry nor the profiler is active."""
    if not (_ENABLED or _prof.is_running()):
        yield None
        return
    s = Span(name, cat, trace_id=trace_id, parent_id=parent_id,
             args=args, metric=metric).attach()
    try:
        yield s
    finally:
        s.finish()


def current_span() -> Optional[Span]:
    return _span_ctx.get()


def record_complete(name: str, cat: str, t0: float, duration: float,
                    trace_id: Optional[str] = None,
                    span_id: Optional[str] = None,
                    parent_id: Optional[str] = None,
                    args: Optional[dict] = None) -> None:
    """Append one already-measured X event (used for retroactive spans
    like queue-wait, where the start is a stored timestamp); nothing
    outside a profiler capture."""
    if not _prof.is_running():
        return
    a = dict(args) if args else {}
    if trace_id is not None:
        a["trace_id"] = trace_id
    if span_id is not None:
        a["span_id"] = span_id
    if parent_id is not None:
        a["parent_id"] = parent_id
    ev = {"name": name, "ph": "X", "cat": cat, "ts": t0 * 1e6,
          "dur": duration * 1e6, "pid": os.getpid(),
          "tid": threading.get_ident()}
    if a:
        ev["args"] = a
    _prof.append_event(ev)


# ---- chrome flow arrows (cross-thread request hand-off) ---------------
# flow events bind on (cat, name, id): emit the start where the request
# is enqueued and the finish where the batch executes, both keyed by the
# request's trace id.

def flow_start(trace_id: str, name: str = "request",
               cat: str = "serving") -> None:
    _prof.append_event({
        "name": name, "ph": "s", "cat": cat, "id": trace_id,
        "ts": time.perf_counter() * 1e6, "pid": os.getpid(),
        "tid": threading.get_ident()})


def flow_end(trace_id: str, name: str = "request",
             cat: str = "serving") -> None:
    _prof.append_event({
        "name": name, "ph": "f", "bp": "e", "cat": cat, "id": trace_id,
        "ts": time.perf_counter() * 1e6, "pid": os.getpid(),
        "tid": threading.get_ident()})


def counter_event(name: str, value, cat: str = "user") -> None:
    """Chrome counter-lane sample (`"ph": "C"`) — the trace-side mirror
    of a registry counter/gauge update."""
    _prof.append_event({
        "name": name, "ph": "C", "cat": cat,
        "ts": time.perf_counter() * 1e6, "pid": os.getpid(),
        "args": {name: value}})
