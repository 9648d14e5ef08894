"""Stdlib HTTP front end over InferenceServer (http.server, JSON body).

Counterpart of ``mxnet_tpu/serving/http.py``: the same routes, bodies
and status codes.  Deliberately dependency-free: the batching,
backpressure, breaker and deadline machinery live in InferenceServer —
this layer only maps HTTP to it (503 ServerOverloaded /
ModelUnavailable / after shutdown, 504 DeadlineExceeded, 404 unknown
model or version, 400 a bad body).

    POST /v1/models/<name>:predict
    POST /v1/models/<name>/versions/<int>:predict
         body: {"inputs": [<nested lists>, ...],
                "seed": 0, "timeout_ms": 250}      (seed/timeout opt.)
         resp: {"outputs": <model's output structure>}
               (tensors as nested lists, a tuple as a list)
    GET  /v1/models    -> {"models": {name: [versions]}}
    GET  /v1/metrics   -> the InferenceServer.metrics() snapshot
    GET  /metrics      -> Prometheus text exposition (the whole
                          process's telemetry registry)
    GET  /healthz      -> 200 {"status": "serving"} while accepting,
                          503 {"status": "draining"} once shutdown
                          begins
    GET  /statusz      -> one human-readable page: build info, uptime,
                          RSS, state, per-model serving counters and
                          the firing alerts (telemetry.alerts'
                          default engine, ticked at render time); 503
                          while draining, the page still rendered.

The JAX package's ``POST /profilez`` (one mxtriage deep capture) waits
for mxtriage (ROADMAP queue A item 10); here it answers 404 and says
so.

Use `serve_http(server, port=0)` for an ephemeral port; the returned
`http.server.ThreadingHTTPServer` exposes `server_address` and is torn
down with `.shutdown()`.
"""
from __future__ import annotations

import json
import re
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import torch

from ..telemetry import metrics as _tmetrics
from . import ServingError

__all__ = ["serve_http"]

_PREDICT = re.compile(
    r"^/v1/models/(?P<name>[^/:]+)"
    r"(?:/versions/(?P<version>\d+))?:predict$")


def _jsonable(out):
    """Model outputs (a tensor, or a tuple of them) -> JSON: nested
    lists, bfloat16/float16 widened to float32 first."""
    if isinstance(out, (tuple, list)):
        return [_jsonable(v) for v in out]
    t = out.detach().cpu()
    if t.dtype in (torch.bfloat16, torch.float16):
        t = t.float()
    return t.numpy().tolist()


def _render_statusz(server) -> str:
    """The /statusz page body: everything an operator asks first, one
    plain-text screen.  Every block degrades to a stub rather than
    failing the render.  The packages the port does not have yet say
    so on their own line."""
    import time

    from ..telemetry import alerts as _alerts
    from ..telemetry import instruments as _ins

    lines = ["mxnet_tpu_torch statusz", "======================="]
    try:
        _ins.refresh_process_gauges()
        child = _ins.build_info()
        fam = _ins._family("mx_build_info")
        labels = next((dict(zip(fam.labelnames, v))
                       for v, c in fam.children() if c is child), {})
        lines.append("build:   " + ", ".join(
            f"{k}={v}" for k, v in labels.items()))
        lines.append(
            f"uptime:  {_ins._child('mx_process_uptime_seconds').value:.0f}s"
            f"   rss: {_ins._child('mx_process_rss_bytes').value / 2**20:.0f}MB")
    except Exception:  # noqa: BLE001 — statusz must always render
        lines.append("build:   (unavailable)")
    state = "DRAINING" if server.draining else "serving"
    snap = server.metrics()
    lines.append(f"state:   {state}   pending {snap['pending']}/"
                 f"{snap['max_queue']}")
    lines.append("")
    lines.append("models:")
    for m in snap["models"]:
        lines.append(
            f"  {m['model']} v{m['version']}: req {m['requests']} "
            f"ok {m['completed']} fail {m['failed']} "
            f"shed {m['rejected'] + m['breaker_rejected']} "
            f"p99 {m['p99_latency_ms'] or '-'}ms "
            f"qdepth {m['queue_depth']}")
    if not snap["models"]:
        lines.append("  (none)")
    lines.append("")
    for name, pkg in _NOT_PORTED:
        lines.append(f"{name}(not ported: telemetry.{pkg}, ROADMAP queue "
                     f"A item 10)")
    lines.append("")
    lines.append("alerts:")
    try:
        eng = _alerts.default_engine()
        eng.tick()  # render-time evaluation: never a stale verdict
        firing = eng.firing()
        for a in firing:
            lines.append(f"  FIRING [{a['severity']}] {a['name']}: "
                         f"{a.get('description', '')} "
                         f"(value {a.get('value')})")
        if not firing:
            lines.append("  (none firing)")
    except Exception:  # noqa: BLE001
        lines.append("  (engine unavailable)")
    lines.append("")
    lines.append(f"rendered {time.strftime('%Y-%m-%d %H:%M:%S')}")
    return "\n".join(lines) + "\n"


# the JAX page's blocks whose packages the port does not have yet
_NOT_PORTED = (("mxprof:   ", "mxprof"), ("health:   ", "mxhealth"),
               ("goodput:  ", "mxgoodput"), ("blackbox: ", "mxblackbox"))


def _make_handler(server):
    import numpy as np

    class Handler(BaseHTTPRequestHandler):
        # request logging goes through metrics, not stderr spam
        def log_message(self, fmt, *args):  # noqa: D102
            pass

        def _send_text(self, status: int, text: str, content_type: str):
            body = text.encode("utf-8")
            self.send_response(status)
            self.send_header("Content-Type", content_type)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _send(self, status: int, payload: dict):
            self._send_text(status, json.dumps(payload),
                            "application/json")

        def do_GET(self):  # noqa: N802 — http.server API
            if self.path == "/metrics":
                # standard scrape target: the process-wide registry in
                # Prometheus text format 0.0.4
                return self._send_text(
                    200, _tmetrics.get_registry().to_prometheus(),
                    "text/plain; version=0.0.4; charset=utf-8")
            if self.path == "/healthz":
                if server.draining:
                    return self._send(503, {"status": "draining"})
                return self._send(200, {"status": "serving"})
            if self.path == "/statusz":
                # drain-aware like /healthz (an LB or a human can read
                # the state off the code), but the page still renders
                # so the operator sees WHAT is draining
                return self._send_text(
                    503 if server.draining else 200,
                    _render_statusz(server),
                    "text/plain; charset=utf-8")
            if self.path == "/v1/metrics":
                return self._send(200, server.metrics())
            if self.path == "/v1/models":
                return self._send(
                    200, {"models": server.repository.models()})
            return self._send(404, {"error": f"no route {self.path}"})

        def do_POST(self):  # noqa: N802 — http.server API
            if self.path == "/profilez":
                return self._send(404, {
                    "error": "no route /profilez: mxtriage's deep capture "
                             "is not ported (ROADMAP queue A item 10)"})
            m = _PREDICT.match(self.path)
            if not m:
                return self._send(404, {"error": f"no route {self.path}"})
            try:
                n = int(self.headers.get("Content-Length", 0))
                req = json.loads(self.rfile.read(n) or b"{}")
                name = m.group("name")
                version = m.group("version")
                entry = server.repository.get(
                    name, int(version) if version else None)
                # admission probe BEFORE input_specs(): specs lazily
                # import the artifact, and shedding (503) must never
                # wait behind a cold model's multi-second import
                server.check_admission(entry)
                specs = entry.input_specs()
                raw = req.get("inputs")
                if not isinstance(raw, list) or len(raw) != len(specs):
                    return self._send(400, {
                        "error": f"body.inputs must be a list of "
                                 f"{len(specs)} arrays"})
                xs = [torch.as_tensor(np.asarray(v)).to(
                    getattr(torch, w["dtype"])) for v, w in zip(raw, specs)]
                # pin the version we cast against: "latest" could move
                # under a concurrent repo.add between here and infer
                out = server.infer(
                    name, xs, version=entry.version,
                    seed=int(req.get("seed", 0)),
                    timeout_ms=req.get("timeout_ms"))
                return self._send(200, {"outputs": _jsonable(out)})
            except ServingError as e:
                return self._send(e.status, {"error": str(e)})
            except Exception as e:  # noqa: BLE001 — HTTP boundary
                return self._send(400, {"error": str(e)})

    return Handler


def serve_http(server, host: str = "127.0.0.1", port: int = 8080):
    """Start the HTTP front end on a daemon thread; returns the
    ThreadingHTTPServer (stop with .shutdown()).  port=0 binds an
    ephemeral port — read it back from `server_address`."""
    httpd = ThreadingHTTPServer((host, port), _make_handler(server))
    t = threading.Thread(target=httpd.serve_forever, daemon=True,
                         name="mx-serving-http")
    t.start()
    return httpd
