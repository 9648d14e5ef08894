"""mxnet_tpu_torch.serving's production front end against the JAX one.

The small fp32 ResNetV1(BottleneckV1, [1,1,1,1], [16,32,64,128,256]) at
32x32 of ``test_torch_resnet_serve.py`` is built in both packages with
the same weights, exported, and served through each package's
``ModelRepository -> InferenceServer -> serve_http`` on an ephemeral
localhost port.  The same bodies give outputs within rtol/atol 1e-4; the
same status codes come back for an unknown model or version (404), a bad
body (400), a full queue (503), an expired deadline (504) and a request
after shutdown (503); shedding never imports a cold model; the circuit
breaker trips and recovers, rollover pins and releases, and the drain
answers every accepted request, alike in both packages.  The route table
is the JAX one without ``/profilez``, which the port names as queued.
"""
import json
import os
import shutil
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu import serving as jserving
from mxnet_tpu.contrib import deploy as jdeploy
from mxnet_tpu.gluon.model_zoo.vision import resnet as jres
from mxnet_tpu.resilience import chaos as jchaos
from mxnet_tpu.serving import http as jhttp

import mxnet_tpu_torch as mt
from mxnet_tpu_torch import serving as tserving
from mxnet_tpu_torch.contrib import deploy as tdeploy
from mxnet_tpu_torch.gluon import load_numpy_params
from mxnet_tpu_torch.gluon.model_zoo.vision import resnet as tres
from mxnet_tpu_torch.resilience import chaos as tchaos
from mxnet_tpu_torch.serving import http as thttp

LAYERS, CHANNELS = [1, 1, 1, 1], [16, 32, 64, 128, 256]
TOL = dict(rtol=1e-4, atol=1e-4)
# localhost only: no proxy from the environment may intercept a request
_OPENER = urllib.request.build_opener(urllib.request.ProxyHandler({}))


def _random_values(names_shapes, seed=0):
    rs = np.random.RandomState(seed)
    vals = {}
    for name, shape in names_shapes:
        if name.endswith("weight"):
            v = rs.randn(*shape) / np.sqrt(int(np.prod(shape[1:])))
        elif name.endswith(("gamma", "running_var")):
            v = rs.rand(*shape) + 0.5
        else:
            v = rs.randn(*shape) * 0.1
        vals[name] = v.astype(np.float32)
    return vals


def _x(n, seed):
    return np.random.RandomState(seed).rand(n, 32, 32, 3).astype(np.float32)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """The file's intra-op threads at one, restored after it."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def arts(tmp_path_factory):
    """Both packages' artifacts of one network (same weights), and the
    port's direct forward on four images."""
    root = tmp_path_factory.mktemp("http_art")
    x = _x(4, 1)
    tnet = tres.ResNetV1(tres.BottleneckV1, LAYERS, CHANNELS, classes=10,
                         layout="NHWC")
    tnet.initialize(mt.init.Xavier(), ctx=mt.cpu(), seed=0)
    values = _random_values([(k, tuple(v.shape)) for k, v in
                             tnet.state_dict(keep_vars=True).items()])
    load_numpy_params(tnet, values)
    tnet.hybridize()
    tnet.eval()
    with torch.no_grad():
        direct = tnet(torch.from_numpy(x)).numpy()
    tdir = tdeploy.export_model(tnet, str(root / "port"),
                                [torch.from_numpy(x[:1])],
                                dynamic_batch=True)
    jnet = jres.ResNetV1(jres.BottleneckV1, LAYERS, CHANNELS, classes=10,
                         layout="NHWC")
    jnet.initialize(mx.initializer.Xavier(), ctx=mx.cpu())
    jnet(mx.nd.array(x))
    for k, p in jnet._collect_params_with_prefix().items():
        p.set_data(mx.nd.array(values[k]))
    jnet.hybridize()
    jdir = str(root / "jax")
    jdeploy.export_model(jnet, jdir, [mx.nd.array(x[:1])],
                         dynamic_batch=True)
    return {"jax": jdir, "port": tdir, "x": x, "direct": direct,
            "root": root}


PKG = {"jax": (jserving, jchaos), "port": (tserving, tchaos)}


class Stack:
    """One package's repository, server and HTTP front end."""

    def __init__(self, pkg, arts, models=(("m", None),), paths=None,
                 **cfg):
        """`models`: (name, version) pairs, each served from the
        package's artifact unless `paths` names another directory."""
        serving, self.chaos = PKG[pkg]
        self.pkg = pkg
        self.repo = serving.ModelRepository() if pkg == "jax" \
            else serving.ModelRepository(ctx=mt.cpu())
        for name, version in models:
            self.repo.add(name, (paths or {}).get(name, arts[pkg]),
                          version=version)
        cfg.setdefault("max_batch_size", 4)
        cfg.setdefault("batch_timeout_ms", 1.0)
        self.server = serving.InferenceServer(
            self.repo, serving.ServingConfig(**cfg))
        self.httpd = serving.serve_http(self.server, port=0)
        self.base = f"http://127.0.0.1:{self.httpd.server_address[1]}"

    def call(self, path, body=None):
        """(status, parsed body) of one request; POST when a body is
        given."""
        data = None if body is None else (
            body if isinstance(body, bytes) else json.dumps(body).encode())
        req = urllib.request.Request(self.base + path, data=data)
        try:
            with _OPENER.open(req, timeout=120) as r:
                code, raw, ctype = r.status, r.read(), r.headers[
                    "Content-Type"]
        except urllib.error.HTTPError as e:
            code, raw, ctype = e.code, e.read(), e.headers["Content-Type"]
        if ctype.startswith("application/json"):
            return code, json.loads(raw)
        return code, raw.decode()

    def predict(self, x, model="m", version=None, **extra):
        path = f"/v1/models/{model}" + (
            f"/versions/{version}" if version is not None else "") \
            + ":predict"
        return self.call(path, dict(inputs=[x.tolist()], **extra))

    def close(self):
        self.httpd.shutdown()
        self.httpd.server_close()
        self.server.shutdown(drain=True, timeout=30)


def _both(arts, scenario, **kw):
    """Run `scenario(stack)` on each package's stack; returns both
    results (jax, port)."""
    out = []
    for pkg in ("jax", "port"):
        st = Stack(pkg, arts, **kw)
        try:
            out.append(scenario(st))
        finally:
            st.close()
    return out


@pytest.fixture(scope="module")
def stacks(arts):
    sts = {pkg: Stack(pkg, arts, models=(("m", 1),), buckets=[1, 2, 4])
           for pkg in ("jax", "port")}
    yield sts
    for st in sts.values():
        st.close()


def test_predict_bodies_match_within_1e4(stacks, arts):
    x, direct = arts["x"], arts["direct"]
    outs = {}
    for pkg, st in stacks.items():
        rows = [st.predict(x[i:i + 1]) for i in range(3)]
        rows.append(st.predict(x[1:3], version=1))
        assert all(code == 200 for code, _ in rows), rows
        outs[pkg] = [np.asarray(b["outputs"], np.float32) for _, b in rows]
    for j, t in zip(outs["jax"], outs["port"]):
        np.testing.assert_allclose(t, j, **TOL)
    for i in range(3):
        np.testing.assert_allclose(outs["port"][i][0], direct[i], **TOL)
    np.testing.assert_allclose(outs["port"][3], direct[1:3], **TOL)


def _serving_counters(text, model="m"):
    """One model's serving counter samples, but mx_serving_compile_total:
    it counts XLA builds, which the port does not have."""
    return sorted(line for line in text.splitlines()
                  if line.startswith("mx_serving_")
                  and line.split("{")[0].endswith("_total")
                  and f'{{model="{model}",' in line
                  and not line.startswith("mx_serving_compile_total"))


def test_read_routes_equal(stacks, arts):
    got = {}
    for pkg, st in stacks.items():
        st.predict(arts["x"][:1])
        res = {p: st.call(p) for p in ("/v1/models", "/v1/metrics",
                                       "/healthz", "/statusz", "/metrics",
                                       "/nope")}
        got[pkg] = res
    j, t = got["jax"], got["port"]
    assert t["/v1/models"] == j["/v1/models"] == (200, {"models": {"m": [1]}})
    assert t["/healthz"] == j["/healthz"] == (200, {"status": "serving"})
    assert t["/nope"][0] == j["/nope"][0] == 404
    tm, jm = t["/v1/metrics"][1], j["/v1/metrics"][1]
    assert set(tm) == set(jm)
    assert set(tm["models"][0]) == set(jm["models"][0])
    for key in ("requests", "completed", "failed", "rejected",
                "deadline_expired", "batches", "batched_rows",
                "padded_rows", "breaker_rejected", "retries_exhausted"):
        assert tm["models"][0][key] == jm["models"][0][key], key
    assert t["/statusz"][0] == j["/statusz"][0] == 200
    assert "m v1: req" in t["/statusz"][1]
    assert "not ported" in t["/statusz"][1]
    assert "not enabled" not in t["/statusz"][1]
    assert t["/metrics"][0] == 200
    assert len(_serving_counters(t["/metrics"][1])) == 13
    assert _serving_counters(t["/metrics"][1]) == \
        _serving_counters(j["/metrics"][1])
    n = tm["models"][0]["requests"]
    assert f'mx_serving_requests_total{{model="m",version="1"}} {n}' \
        in t["/metrics"][1]


ERROR_CASES = {
    "unknown_model": ("/v1/models/nope:predict", "good"),
    "unknown_version": ("/v1/models/m/versions/7:predict", "good"),
    "inputs_not_a_list": ("/v1/models/m:predict", {"inputs": 3}),
    "wrong_input_count": ("/v1/models/m:predict", "two"),
    "ragged_input": ("/v1/models/m:predict", {"inputs": [[[1, 2], [3]]]}),
    "wrong_shape": ("/v1/models/m:predict", "shape"),
    "not_json": ("/v1/models/m:predict", b"{"),
    "no_route": ("/v1/other:predict", "good"),
    "profilez_or_none": ("/v1/models/m:predictx", "good"),
}


@pytest.mark.parametrize("case", sorted(ERROR_CASES))
def test_error_codes_equal(stacks, arts, case):
    path, body = ERROR_CASES[case]
    x = arts["x"][:1].tolist()
    body = {"good": {"inputs": [x]}, "two": {"inputs": [x, x]},
            "shape": {"inputs": [np.zeros((1, 8, 8, 3)).tolist()]}} \
        .get(body, body) if isinstance(body, str) else body
    (jc, jb), (tc, tb) = (stacks[p].call(path, body) for p in ("jax", "port"))
    assert tc == jc and tc >= 400, (tc, tb, jc, jb)
    assert isinstance(tb, dict) and "error" in tb
    if case == "unknown_model":
        assert tc == 404 and "unknown model" in tb["error"]


def test_full_queue_deadline_and_shutdown_codes_equal(arts):
    x = arts["x"]

    def full(st):
        fut = st.server.submit("m", [x[:1]])  # waits for a full batch
        code, _ = st.predict(x[1:2])
        st.server.shutdown(drain=True, timeout=30)
        after = st.predict(x[1:2])[0]
        return code, after, np.asarray(fut.result(timeout=60)[0]).shape

    def deadline(st):
        return st.predict(x[:1], timeout_ms=1)[0]

    got = _both(arts, full, max_queue=1, batch_timeout_ms=60_000)
    assert got[1] == got[0] == (503, 503, (10,))
    got = _both(arts, deadline, batch_timeout_ms=400)
    assert got[1] == got[0] == 504


def test_shedding_does_not_import_a_cold_model(arts):
    def run(st):
        fut = st.server.submit("hot", [arts["x"][:1]])
        code, body = st.predict(arts["x"][:1], model="cold")
        cold = st.repo.get("cold")
        out = (code, cold._served is None,
               cold.metrics.snapshot()["rejected"])
        st.server.shutdown(drain=True, timeout=30)
        fut.result(timeout=60)
        return out

    got = []
    for pkg in ("jax", "port"):
        cold = str(arts["root"] / f"cold_{pkg}")
        if not os.path.exists(cold):
            shutil.copytree(arts[pkg], cold)
        st = Stack(pkg, arts, models=(("hot", None), ("cold", None)),
                   paths={"cold": cold}, max_queue=1, batch_timeout_ms=60_000)
        try:
            got.append(run(st))
        finally:
            st.close()
    assert got[1] == got[0] == (503, True, 1)


def test_breaker_trips_and_recovers_alike(arts):
    x = arts["x"][:1]

    def run(st):
        trail = []
        with st.chaos.inject("serving.execute", times=2):
            for _ in range(3):
                code, body = st.predict(x, model="a")
                trail.append((code, "circuit breaker" in body["error"]
                              if code != 200 else None))
            trail.append(st.predict(x, model="b")[0])
            trail.append(st.call("/healthz")[0])
            trail.append(st.repo.get("a").breaker.state())
        time.sleep(0.35)  # the cooldown
        trail.append(st.predict(x, model="a")[0])  # the probe
        trail.append(st.repo.get("a").breaker.state())
        snap = st.repo.get("a").metrics.snapshot()
        trail.append((snap["failed"], snap["breaker_rejected"],
                      snap["completed"]))
        prom = st.call("/metrics")[1]
        trail.append('mx_breaker_open_total{model="a",version="1"} 1'
                     in prom)
        return trail

    got = _both(arts, run, models=(("a", None), ("b", None)), buckets=[1],
                breaker_threshold=2, breaker_cooldown_ms=300,
                execute_retries=1)
    assert got[1] == got[0]
    assert got[1][:6] == [(400, False), (400, False), (503, True), 200, 200,
                          "open"]
    assert got[1][6:] == [200, "closed", (2, 1, 1), True]


def test_rollover_pins_and_releases_alike(arts):
    x = arts["x"][:1]

    def run(st):
        repo = st.repo
        trail = [st.predict(x)[0], repo.default_version("m")]  # v2: latest
        st.predict(x, version=1)
        e1, e2 = repo.get("m", 1), repo.get("m", 2)
        trail.append(repo.rollover("m", 1))
        trail.append((e2.retired, e2._served is None, e1.retired))
        trail.append(st.predict(x)[0])
        trail.append((e1.metrics.value("requests"),
                      e2.metrics.value("requests")))
        repo.add("m", repo.get("m", 1).path, version=3)
        trail.append(repo.get("m") is e1)
        # a request in flight on v1 while traffic moves to v2
        res = {}
        with st.chaos.inject("serving.execute", at=1, action="hang",
                             duration=0.6):
            t = threading.Thread(target=lambda: res.update(
                out=st.predict(x, version=1)))
            t.start()
            time.sleep(0.3)
            trail.append(repo.rollover("m", 2))
            trail.append((e1.retired, e1.inflight(), e1._served is None))
            t.join(60)
        assert not t.is_alive()
        trail.append(res["out"][0])
        trail.append((e1.inflight(), e1._served is None))
        trail.append(st.predict(x, version=1)[0])  # lazy re-import
        trail.append(st.call("/v1/models")[1])
        return trail

    got = _both(arts, run, models=(("m", 1), ("m", 2)), buckets=[1])
    assert got[1] == got[0]
    # in flight during the swap: the server's use and the launch's
    assert got[1] == [200, 2, 1, (True, True, False), 200, (2, 1), True, 2,
                      (True, 2, False), 200, (0, True), 200,
                      {"models": {"m": [1, 2, 3]}}]


def test_drain_answers_every_accepted_request_alike(arts):
    x = arts["x"]

    def run(st):
        with st.chaos.inject("serving.execute", at=1, action="hang",
                             duration=0.8):
            futs = [st.server.submit("m", [x[i:i + 1]]) for i in range(3)]
            time.sleep(0.2)  # the first batch is inside its hang
            closer = threading.Thread(
                target=lambda: st.server.shutdown(drain=True, timeout=30))
            closer.start()
            time.sleep(0.1)
            codes = [st.call("/healthz")[0], st.call("/statusz")[0],
                     st.predict(x[:1])[0]]
            draining = "DRAINING" in st.call("/statusz")[1]
            closer.join(60)
        assert not closer.is_alive()
        answered = [np.asarray(f.result(timeout=1)[0]).shape for f in futs]
        return codes, draining, answered, st.server.pending()

    got = _both(arts, run, buckets=[1], max_batch_size=1)
    assert got[1] == got[0] == ([503, 503, 503], True, [(10,)] * 3, 0)


def test_a_finished_batch_keeps_no_output_alive(arts):
    """Once its client drops the answer, a batch's output is free even
    while the batcher waits for more work (on the card a retired
    version's release must give back the device memory)."""
    import gc
    import weakref

    st = Stack("port", arts)
    try:
        fut = st.server.submit("m", [arts["x"][:1]])
        ref = weakref.ref(fut.result(timeout=60))
        del fut
        for _ in range(100):
            gc.collect()
            if ref() is None:
                break
            time.sleep(0.05)
        assert ref() is None
    finally:
        st.close()


def _routes(doc):
    return sorted(line.split()[1] for line in doc.splitlines()
                  if line.strip().startswith(("GET ", "POST ")))


def test_route_table_is_the_jax_one_without_profilez(stacks):
    jroutes, troutes = _routes(jhttp.__doc__), _routes(thttp.__doc__)
    assert "/profilez" in jroutes
    assert troutes == [r for r in jroutes if r != "/profilez"]
    code, body = stacks["port"].call("/profilez", {})
    assert code == 404 and "not ported" in body["error"]
