"""mxnet_tpu_torch's ResNet V1 serving slice against the JAX package.

A small ResNetV1(BottleneckV1, [1,1,1,1], [16,32,64,128,256]) at 32x32,
fp32, NHWC (and its BasicBlockV1 twin, [16,16,32,64,128]), is built in
both packages with the same weights (random
BatchNorm statistics and conv biases included, so the eval-mode BN
algebra and the conv-bias quirk are exercised).  The JAX package runs
it hybridized with MXNET_FUSED_CONVBN=1; the port runs it fused and
unfused on the CPU: rtol/atol 1e-4 (fp32 through some 20 layers).  The
same port network is then served through export_model ->
ModelRepository -> InferenceServer, and the `.params` format,
import hygiene and the no-silent-CPU rule are checked.
"""
import ast
import os
import pathlib

import ml_dtypes
import numpy as np
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu import serialization as jser
from mxnet_tpu.gluon.model_zoo.vision import resnet as jres

import mxnet_tpu_torch as mt
from mxnet_tpu_torch import context as tctx
from mxnet_tpu_torch import serialization as tser
from mxnet_tpu_torch import serving
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.contrib import deploy
from mxnet_tpu_torch.gluon import load_numpy_params
from mxnet_tpu_torch.gluon.model_zoo import vision as tvision
from mxnet_tpu_torch.gluon.model_zoo.vision import resnet as tres

REPO = pathlib.Path(__file__).resolve().parent.parent
LAYERS = [1, 1, 1, 1]
# block -> channels of the small network; fused-unit calls per forward
SMALL = {"BottleneckV1": ([16, 32, 64, 128, 256], 4 * 3 + 4),
         "BasicBlockV1": ([16, 16, 32, 64, 128], 4 * 2 + 3)}


def _random_values(names_shapes, seed=0):
    """Weights, biases and BN statistics from numpy, by structural name."""
    rs = np.random.RandomState(seed)
    vals = {}
    for name, shape in names_shapes:
        if name.endswith("weight"):
            fan_in = int(np.prod(shape[1:]))
            v = rs.randn(*shape) / np.sqrt(fan_in)
        elif name.endswith(("gamma", "running_var")):
            v = rs.rand(*shape) + 0.5
        else:  # beta, running_mean, conv/dense bias
            v = rs.randn(*shape) * 0.1
        vals[name] = v.astype(np.float32)
    return vals


def _port_net(values=None, block="BottleneckV1"):
    net = tres.ResNetV1(getattr(tres, block), LAYERS, SMALL[block][0],
                        classes=10, layout="NHWC")
    net.initialize(mt.init.Xavier(), ctx=mt.cpu(), seed=0)
    if values is None:
        values = _random_values([
            (k, tuple(v.shape))
            for k, v in net.state_dict(keep_vars=True).items()])
    load_numpy_params(net, values)
    net.hybridize()
    net.eval()
    return net, values


def _x(n=3, seed=1):
    return np.random.RandomState(seed).rand(n, 32, 32, 3).astype(np.float32)


@pytest.fixture(scope="module", params=sorted(SMALL))
def jax_ref(request):
    """The JAX network's fused eval output and its weights, per block."""
    block = request.param
    net = jres.ResNetV1(getattr(jres, block), LAYERS, SMALL[block][0],
                        classes=10, layout="NHWC")
    net.initialize(mx.initializer.Xavier(), ctx=mx.cpu())
    x = _x()
    net(mx.nd.array(x))  # resolve deferred shapes eagerly
    params = net._collect_params_with_prefix()
    values = _random_values([(k, tuple(p.shape)) for k, p in params.items()])
    for k, p in params.items():
        p.set_data(mx.nd.array(values[k]))
    net.hybridize()
    os.environ["MXNET_FUSED_CONVBN"] = "1"
    try:
        out = net(mx.nd.array(x)).asnumpy()
    finally:
        os.environ.pop("MXNET_FUSED_CONVBN", None)
    return block, net, values, x, out


def _forward(net, x, fused, monkeypatch):
    monkeypatch.setenv("MXNET_FUSED_CONVBN", "1" if fused else "0")
    with torch.no_grad():
        return net(torch.from_numpy(x)).numpy()


@pytest.mark.parametrize("fused", [True, False])
def test_resnet_v1_matches_jax_fused_eval(jax_ref, fused, monkeypatch):
    block, _, values, x, ref = jax_ref
    net, _ = _port_net(values, block)
    calls = []
    real = mt.ops.fused_conv_unit
    monkeypatch.setattr(mt.ops, "fused_conv_unit",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    out = _forward(net, x, fused, monkeypatch)
    # 3 (bottleneck) or 2 (basic) convs per block + the downsample convs
    assert len(calls) == (SMALL[block][1] if fused else 0)
    assert out.shape == ref.shape == (3, 10)
    np.testing.assert_allclose(out, ref, rtol=1e-4, atol=1e-4)


def test_jax_saved_parameters_load_in_the_port(jax_ref, tmp_path):
    block, jnet, values, x, ref = jax_ref
    f = str(tmp_path / "net.params")
    jnet.save_parameters(f)
    net = tres.ResNetV1(getattr(tres, block), LAYERS, SMALL[block][0],
                        classes=10, layout="NHWC")
    net.initialize(ctx=mt.cpu())
    net.load_parameters(f)
    got = {k: v.detach().numpy()
           for k, v in net.state_dict(keep_vars=True).items()}
    assert set(got) == set(values)
    for k in values:
        np.testing.assert_array_equal(got[k], values[k], err_msg=k)


def test_fused_path_needs_nhwc_trace_and_single_pass_stats(monkeypatch):
    monkeypatch.setenv("MXNET_FUSED_CONVBN", "1")
    assert tres._fused_convbn_active("NHWC") is False  # no trace scope
    with mt.gluon.ActiveTrace(train=False):
        assert tres._fused_convbn_active("NHWC")
        assert not tres._fused_convbn_active("NCHW")
        monkeypatch.setenv("MXNET_BN_EXACT_VAR", "1")
        assert not tres._fused_convbn_active("NHWC")


def test_zoo_names_and_bn_cast():
    net = tvision.get_model("resnet50_v1", classes=1000, layout="NHWC")
    names = list(net.state_dict(keep_vars=True))
    assert names[:2] == ["features.0.weight", "features.1.gamma"]
    assert "features.4.0.body.0.weight" in names
    assert "features.4.0.downsample.1.running_var" in names
    assert names[-2:] == ["output.weight", "output.bias"]
    # torchvision's 25,557,032 plus the gluon bottleneck's conv1/conv3 biases
    assert sum(v.numel() for v in net.parameters()) == 25557032 + 18880
    net.cast("bfloat16")
    params = net.state_dict(keep_vars=True)
    assert params["features.4.0.body.0.weight"].dtype == torch.bfloat16
    assert params["features.1.gamma"].dtype == torch.float32
    assert params["features.1.running_mean"].dtype == torch.float32


def test_served_batches_equal_direct_forward(tmp_path, monkeypatch):
    monkeypatch.setenv("MXNET_FUSED_CONVBN", "1")
    net, _ = _port_net()
    x = _x(3, seed=2)
    with torch.no_grad():
        direct = net(torch.from_numpy(x)).numpy()
    path = deploy.export_model(net, str(tmp_path / "art"),
                               [torch.from_numpy(x[:1])], dynamic_batch=True)
    repo = serving.ModelRepository(ctx=mt.cpu())
    repo.add("resnet", path)
    server = serving.InferenceServer(
        repo, serving.ServingConfig(max_batch_size=8, batch_timeout_ms=500))
    try:
        # the first request imports the artifact; the next three coalesce
        # into one launch padded to the 4-row bucket
        server.infer("resnet", [torch.from_numpy(x[:1])])
        futs = [server.submit("resnet", [torch.from_numpy(x[i:i + 1])])
                for i in range(3)]
        rows = [f.result(timeout=60).numpy() for f in futs]
    finally:
        server.shutdown(drain=True)  # joins the batcher: counters settle
    snap = repo.get("resnet").metrics.snapshot()
    for i, r in enumerate(rows):
        assert r.shape == (1, 10)
        np.testing.assert_allclose(r[0], direct[i], rtol=1e-5, atol=1e-5)
    assert snap["batches"] == 2 and snap["completed"] == 4
    assert snap["batched_rows"] == 4 and snap["padded_rows"] == 5
    assert snap["cache_misses"] == 2  # buckets 1 and 4
    with pytest.raises(serving.ServerClosed):
        server.submit("resnet", [torch.from_numpy(x[:1])])


def test_artifact_meta_and_reimport(tmp_path):
    net, values = _port_net()
    x = torch.from_numpy(_x(2, seed=3))
    path = deploy.export_model(net, str(tmp_path / "a"), [x],
                               dynamic_batch=True)
    meta = deploy.import_model(path, ctx=mt.cpu()).meta
    for key in ("inputs", "dynamic_batch", "outputs", "param_order",
                "n_outputs", "arch"):
        assert key in meta
    assert meta["inputs"] == [{"shape": [None, 32, 32, 3],
                               "dtype": "float32"}]
    assert meta["outputs"] == [{"shape": ["b", 10], "dtype": "float32"}]
    served = deploy.import_model(path, ctx=mt.cpu())
    with torch.no_grad():
        want = net(x)
    torch.testing.assert_close(served(x), want, rtol=0, atol=0)
    loaded = jser.load_ndarrays(os.path.join(path, "model.params"))
    assert set(loaded) == set(values)
    with pytest.raises(MXNetError):
        served(x.double())


def test_params_roundtrip_with_the_jax_format(tmp_path):
    rs = np.random.RandomState(4)
    f32 = rs.randn(3, 4).astype(np.float32)
    bf = rs.randn(5).astype(np.float32).astype(ml_dtypes.bfloat16)
    i32 = np.arange(6, dtype=np.int32).reshape(2, 3)
    fj = str(tmp_path / "jax.params")
    jser.save_ndarrays(fj, {"w": mx.nd.array(f32),
                            "b": mx.nd.array(bf.astype(np.float32))
                            .astype("bfloat16"),
                            "i": mx.nd.array(i32, dtype="int32")})
    got = tser.load_ndarrays(fj)
    assert got["b"].dtype == torch.bfloat16
    np.testing.assert_array_equal(got["w"].numpy(), f32)
    np.testing.assert_array_equal(got["b"].float().numpy(),
                                  bf.astype(np.float32))
    np.testing.assert_array_equal(got["i"].numpy(), i32)
    fp = str(tmp_path / "port.params")
    tser.save_ndarrays(fp, got)
    assert open(fp, "rb").read() == open(fj, "rb").read()
    back = jser.load_ndarrays(fp)
    assert str(back["b"].dtype) == "bfloat16"
    np.testing.assert_array_equal(back["b"].asnumpy().astype(np.float32),
                                  bf.astype(np.float32))
    assert isinstance(tser.load_ndarrays(_save_list(tmp_path)), list)


def _save_list(tmp_path):
    f = str(tmp_path / "list.params")
    tser.save_ndarrays(f, [torch.ones(2), torch.zeros(3)])
    return f


def test_load_numpy_params_checks_names_shapes_and_takes_bf16():
    net, values = _port_net()
    bf = {k: v.astype(ml_dtypes.bfloat16) for k, v in values.items()}
    load_numpy_params(net, bf)
    w = net.state_dict(keep_vars=True)["features.0.weight"]
    assert w.dtype == torch.bfloat16
    np.testing.assert_array_equal(
        w.detach().float().numpy(), bf["features.0.weight"].astype(np.float32))
    missing = dict(values)
    missing.pop("output.bias")
    extra = dict(values, **{"output.extra": np.zeros(1, np.float32)})
    shaped = dict(values, **{"output.bias": np.zeros(3, np.float32)})
    for bad in (missing, extra, shaped):
        with pytest.raises(MXNetError):
            load_numpy_params(net, bad)


def test_entry_points_do_not_fall_back_to_the_cpu(tmp_path, monkeypatch):
    net, _ = _port_net()
    path = deploy.export_model(net, str(tmp_path / "a"),
                               [torch.from_numpy(_x(1))])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(MXNetError, match="no CUDA device"):
        tctx.current_context()
    with pytest.raises(MXNetError, match="no CUDA device"):
        tres.ResNetV1(tres.BottleneckV1, LAYERS, SMALL["BottleneckV1"][0],
                      classes=10, layout="NHWC").initialize()
    with pytest.raises(MXNetError, match="no CUDA device"):
        deploy.import_model(path)
    with pytest.raises(MXNetError, match="no CUDA device"):
        serving.ModelRepository()
    with pytest.raises(MXNetError, match="tpu"):
        mt.tpu()
    assert tctx.resolve(mt.cpu()) == torch.device("cpu")
    assert tctx.resolve("cuda") == torch.device("cuda", 0)


def _imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_port_imports_neither_jax_nor_the_jax_package():
    files = sorted((REPO / "mxnet_tpu_torch").rglob("*.py"))
    files.append(REPO / "chip_smoke.py")
    assert len(files) > 20
    pkg = REPO / "mxnet_tpu_torch"
    for rel in ("gluon/parameter.py", "gluon/loss.py",
                "gluon/nn/basic_layers.py", "gluon/nn/conv_layers.py",
                "gluon/contrib/__init__.py", "gluon/contrib/nn.py",
                "gluon/contrib/estimator.py", "_graphs.py",
                "ops/optimizer_ops.py", "optimizer/optimizer.py",
                "optimizer/fused.py", "parallel/spmd.py", "gluon/block.py",
                "gluon/trainer.py", "module/module.py",
                "gluon/model_zoo/bert.py", "gluon/model_zoo/vision/resnet.py",
                "ops/random_ops.py", "ndarray/random.py",
                "tools/op_sweep.py", "ops/rnn.py", "gluon/rnn/__init__.py",
                "gluon/rnn/rnn_cell.py", "gluon/rnn/rnn_layer.py",
                "rnn/__init__.py", "rnn/rnn_cell.py", "rnn/io.py",
                "module/bucketing_module.py", "contrib/__init__.py",
                "contrib/amp.py", "examples/rnn_bucketing.py",
                "context.py", "engine.py", "resource.py", "util/env.py",
                "ops/linalg.py", "ndarray/sparse.py", "kvstore.py",
                "serialization.py", "io/io.py",
                "gluon/model_zoo/vision/__init__.py",
                "gluon/model_zoo/vision/alexnet.py",
                "gluon/model_zoo/vision/vgg.py",
                "gluon/model_zoo/vision/squeezenet.py",
                "gluon/model_zoo/vision/densenet.py",
                "gluon/model_zoo/vision/inception.py",
                "parallel/checkpoint.py", "parallel/dist.py",
                "gluon/data/dataloader.py", "gluon/data/vision/transforms.py",
                "gluon/data/vision/datasets.py", "gluon/data/dataset.py",
                "lib.py", "recordio.py", "image/__init__.py",
                "ops/image_ops.py", "ndarray/image.py", "tools/im2rec.py",
                "tools/bench_pipeline.py", "examples/imagenet_train.py",
                "ops/quantization.py", "ops/quantized_conv.py",
                "contrib/quantization.py", "contrib/ndarray.py",
                "contrib/symbol.py", "examples/quantize_model.py",
                "operator.py", "ops/custom.py", "contrib/control_flow.py",
                "contrib/onnx/__init__.py", "contrib/onnx/proto.py",
                "initialize.py", "runtime.py", "storage.py", "rtc.py",
                "profiler.py", "monitor.py", "visualization.py",
                "test_utils.py", "examples/bert_pretrain.py",
                "examples/transformer_nmt.py", "kvstore_compression.py",
                "kvstore_server.py", "optimizer/comm.py",
                "optimizer/spmd.py", "tools/launch.py", "parallel/mesh.py",
                "parallel/sharding.py", "parallel/_compat.py",
                "parallel/ring.py", "parallel/ulysses.py",
                "parallel/__init__.py", "examples/long_context_lm.py",
                "parallel/moe.py", "parallel/pipeline.py", "telemetry/__init__.py", "telemetry/metrics.py",
                "telemetry/tracing.py", "telemetry/instruments.py",
                "telemetry/catalog.py", "telemetry/alerts.py",
                "resilience/__init__.py", "resilience/breaker.py",
                "resilience/retry.py", "resilience/chaos.py",
                "serving/__init__.py", "serving/metrics.py",
                "serving/repository.py", "serving/batcher.py",
                "serving/server.py", "serving/http.py"):
        assert pkg / rel in files, rel
    for f in files:
        for mod in _imports(f):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "mxnet_tpu"), \
                f"{f.relative_to(REPO)} imports {mod}"


@pytest.fixture(scope="module")
def artifacts(tmp_path_factory):
    """A dynamic-batch and a fixed-batch (2 rows) artifact of the small
    port network, with its direct forward on four images."""
    net, _ = _port_net()
    x = torch.from_numpy(_x(4, seed=5))
    with torch.no_grad():
        direct = net(x)
    root = tmp_path_factory.mktemp("art")
    dyn = deploy.export_model(net, str(root / "dyn"), [x[:1]],
                              dynamic_batch=True)
    fixed = deploy.export_model(net, str(root / "fixed"), [x[:2]])
    return dyn, fixed, x, direct


def _server(path, **cfg):
    repo = serving.ModelRepository(ctx=mt.cpu())
    repo.add("m", path)
    repo.get("m").served  # import now, outside the timed requests
    return repo, serving.InferenceServer(repo, serving.ServingConfig(**cfg))


def test_backpressure_and_deadlines(artifacts):
    dyn, _, x, direct = artifacts
    repo, server = _server(dyn, max_batch_size=8, batch_timeout_ms=300,
                           max_queue=2)
    try:
        late = server.submit("m", [x[:1]], timeout_ms=20)
        ok = server.submit("m", [x[1:2]])
        with pytest.raises(serving.ServerOverloaded):
            server.submit("m", [x[2:3]])
        with pytest.raises(serving.DeadlineExceeded):
            late.result(timeout=30)
        torch.testing.assert_close(ok.result(timeout=30)[0], direct[1],
                                   rtol=1e-5, atol=1e-5)
    finally:
        server.shutdown(drain=True, timeout=30)
    snap = server.metrics()["models"][0]
    assert (snap["rejected"], snap["deadline_expired"], snap["completed"]) \
        == (1, 1, 1)
    assert server.metrics()["pending"] == 0


@pytest.mark.parametrize("drain", [True, False])
def test_shutdown_drains_or_fails_queued_requests(artifacts, drain):
    dyn, _, x, direct = artifacts
    _, server = _server(dyn, max_batch_size=8, batch_timeout_ms=60_000)
    fut = server.submit("m", [x[:2]])  # waits for a full batch
    server.shutdown(drain=drain, timeout=30)
    if drain:
        torch.testing.assert_close(fut.result(timeout=1), direct[:2],
                                   rtol=1e-5, atol=1e-5)
    else:
        with pytest.raises(serving.ServerClosed):
            fut.result(timeout=1)
    with pytest.raises(serving.ServerClosed):
        server.submit("m", [x[:1]])


def test_fixed_shape_artifact_pads_to_its_batch(artifacts):
    _, fixed, x, direct = artifacts
    repo, server = _server(fixed, max_batch_size=8, batch_timeout_ms=1)
    try:
        assert repo.get("m").allowed_buckets([1, 2, 4, 8]) == [2]
        got = server.infer("m", [x[3:4]])
        torch.testing.assert_close(got[0], direct[3], rtol=1e-5, atol=1e-5)
        with pytest.raises(serving.ServingError):
            server.submit("m", [x[:3]])  # more rows than the artifact
        with pytest.raises(serving.ServingError):
            server.submit("m", [x[:1].double()])
        with pytest.raises(serving.ModelNotFound):
            server.submit("nope", [x[:1]])
        with pytest.raises(serving.ModelNotFound):
            server.submit("m", [x[:1]], version=7)
    finally:
        server.shutdown()
    snap = server.metrics()["models"][0]
    assert snap["padded_rows"] == 2 and snap["batched_rows"] == 1


def test_concurrent_clients_stress(artifacts, monkeypatch):
    """More client threads than cores, a short switch interval: every
    request answered right, one artifact import, and the shared admission
    and metric counters lose no update."""
    import sys
    import threading

    dyn, _, x, direct = artifacts
    imports = []
    real = deploy.import_model
    monkeypatch.setattr(deploy, "import_model",
                        lambda *a, **k: imports.append(1) or real(*a, **k))
    repo = serving.ModelRepository(ctx=mt.cpu())
    repo.add("m", dyn)
    server = serving.InferenceServer(
        repo, serving.ServingConfig(max_batch_size=8, batch_timeout_ms=5))
    n_threads, per_thread = 2 * (os.cpu_count() or 1) + 2, 6
    errors = []

    def client(t):
        try:
            futs = [(i % 4, server.submit("m", [x[i % 4:i % 4 + 1]]))
                    for i in range(t, t + per_thread)]
            for i, f in futs:
                torch.testing.assert_close(f.result(timeout=60)[0],
                                           direct[i], rtol=1e-5, atol=1e-5)
        except Exception as e:  # noqa: BLE001 — collected for the assert
            errors.append(e)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        ts = [threading.Thread(target=client, args=(t,))
              for t in range(n_threads)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in ts)
    finally:
        sys.setswitchinterval(old)
        server.shutdown(drain=True, timeout=30)
    assert not errors, errors[:3]
    total = n_threads * per_thread
    state = server.metrics()
    snap = state["models"][0]
    assert len(imports) == 1
    assert state["pending"] == 0 and snap["queue_depth"] == 0
    assert snap["requests"] == snap["completed"] == snap["batched_rows"] \
        == total
    assert snap["cache_hits"] + snap["cache_misses"] == snap["batches"]
