"""The port's ONNX export and import (``mxnet_tpu_torch/contrib/onnx``)
against the JAX package's on the CPU.

* ``proto.py``: the port's copy encodes every message the JAX one does to
  the same bytes, and decodes them back.
* Export: the same graph (explicit node names) and the same seeded
  weights give the same file, byte for byte, in both packages (the test
  convnet, the MLP with scalar ops); the file passes
  ``torch._C._check_onnx_proto``; ``get_model_metadata`` reads it.
* Import: a file the JAX package wrote, imported and run by the port, and
  a file the port wrote, imported and run by the JAX package, each within
  fp32 tolerance (rtol 1e-5, atol 1e-6) of the original symbol's forward
  in the other package; the parameters come back on ``cpu()``.
* Errors: an operator without a mapping raises with its name, on export
  and on import.
"""
import numpy as np
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu.contrib import onnx as jonnx
from mxnet_tpu.contrib.onnx import proto as jproto

import mxnet_tpu_torch as mt
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.contrib import onnx as tonnx
from mxnet_tpu_torch.contrib.onnx import proto as tproto

RTOL, ATOL = 1e-5, 1e-6


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread while this file runs (the other workers hold
    the cores), restored after it."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _convnet(S):
    d = S.var("data")
    c = S.Convolution(d, kernel=(3, 3), num_filter=8, pad=(1, 1), name="c1")
    b = S.BatchNorm(c, fix_gamma=False, name="bn1")
    a = S.Activation(b, act_type="relu", name="r1")
    p = S.Pooling(a, kernel=(2, 2), stride=(2, 2), pool_type="max",
                  name="p1")
    g = S.Pooling(a, kernel=(1, 1), global_pool=True, pool_type="avg",
                  name="g1")
    f = S.FullyConnected(p, num_hidden=10, name="fc1")
    f2 = S.FullyConnected(g, num_hidden=10, name="fc2")
    return S.softmax(S.elemwise_add(f, f2, name="add1"), name="sm")


def _mlp(S):
    d = S.var("data")
    f1 = S.FullyConnected(d, num_hidden=16, name="fc1")
    a1 = S.Activation(f1, act_type="tanh", name="t1")
    f2 = S.FullyConnected(a1, num_hidden=4, name="fc2")
    return S.identity((f2 + 1.0) * 2.0, name="out")


NETS = {"convnet": (_convnet, (2, 3, 8, 8)), "mlp": (_mlp, (3, 6))}


def _build(build, pkg):
    """``build`` in a fresh name scope, so that nodes named by the
    counters (the scalar ops) get the same names in both packages."""
    with pkg.name.NameManager():
        return build(pkg.sym)


def _weights(build, shape, seed=0):
    """Seeded numpy weights by the JAX graph's argument names."""
    s = _build(build, mx)
    rng = np.random.RandomState(seed)
    arg_shapes, _, aux_shapes = s.infer_shape(data=shape)
    w = {n: (rng.randn(*shp) * 0.3).astype("f4")
         for n, shp in zip(s.list_arguments(), arg_shapes) if n != "data"}
    for n, shp in zip(s.list_auxiliary_states(), aux_shapes):
        w[n] = (rng.rand(*shp) + 0.5).astype("f4") if "var" in n \
            else (rng.randn(*shp) * 0.1).astype("f4")
    return w


def _jax_forward(s, params, x):
    ex = s.bind(mx.cpu(), {**{k: mx.nd.array(v) for k, v in params.items()},
                           "data": mx.nd.array(x)})
    return ex.forward()[0].asnumpy()


def _port_forward(s, params, x):
    cpu = mt.cpu()
    args = {k: mt.nd.array(np.asarray(v.asnumpy() if hasattr(v, "asnumpy")
                                      else v), ctx=cpu)
            for k, v in params.items()}
    ex = s.bind(cpu, {**args, "data": mt.nd.array(x, ctx=cpu)})
    return ex.forward()[0].asnumpy()


def _export_both(tmp_path, name):
    build, shape = NETS[name]
    w = _weights(build, shape)
    jpath, tpath = str(tmp_path / "jax.onnx"), str(tmp_path / "port.onnx")
    jonnx.export_model(_build(build, mx), {k: mx.nd.array(v) for k, v in
                                           w.items()}, [shape], jpath)
    tonnx.export_model(_build(build, mt), {k: mt.nd.array(v, ctx=mt.cpu())
                                           for k, v in w.items()}, [shape],
                       tpath)
    return build, shape, w, jpath, tpath


def test_proto_roundtrip_and_same_bytes():
    arr = np.arange(12, dtype="f4").reshape(3, 4)
    t, jt = tproto.Tensor.from_numpy("w", arr), jproto.Tensor.from_numpy(
        "w", arr)
    assert t.encode() == jt.encode()
    np.testing.assert_array_equal(tproto.Tensor.decode(t.encode())
                                  .to_numpy(), arr)
    attrs = {"kernel_shape": [3, 3], "alpha": 0.5, "mode": "same",
             "flag": 1, "pads": [-1, 2]}
    n = tproto.Node(op_type="Conv", inputs=["x", "w"], outputs=["y"],
                    name="c", attrs=attrs)
    jn = jproto.Node(op_type="Conv", inputs=["x", "w"], outputs=["y"],
                     name="c", attrs=attrs)
    assert n.encode() == jn.encode()
    n2 = tproto.Node.decode(n.encode())
    assert n2.op_type == "Conv" and n2.attrs["kernel_shape"] == [3, 3]
    assert n2.attrs["mode"] == "same" and n2.attrs["flag"] == 1
    assert n2.attrs["pads"] == [-1, 2]
    assert n2.attrs["alpha"] == pytest.approx(0.5)
    vi = tproto.ValueInfo("x", tproto.DT_FLOAT, [1, 3])
    assert vi.encode() == jproto.ValueInfo("x", jproto.DT_FLOAT,
                                           [1, 3]).encode()
    m = tproto.Model.decode(tproto.Model(graph=tproto.Graph(
        name="g", nodes=[n], inputs=[vi])).encode())
    assert m.opset == 13 and m.graph.nodes[0].op_type == "Conv"
    assert m.graph.inputs[0].shape == [1, 3]


@pytest.mark.parametrize("name", sorted(NETS))
def test_export_bytes_equal_the_jax_export(tmp_path, name):
    *_, jpath, tpath = _export_both(tmp_path, name)
    with open(jpath, "rb") as f:
        jb = f.read()
    with open(tpath, "rb") as f:
        tb = f.read()
    assert len(tb) > 100 and tb == jb


@pytest.mark.parametrize("name", sorted(NETS))
def test_export_passes_the_onnx_checker(tmp_path, name):
    *_, tpath = _export_both(tmp_path, name)
    with open(tpath, "rb") as f:
        torch._C._check_onnx_proto(f.read())  # raises on an invalid file


@pytest.mark.parametrize("name", sorted(NETS))
def test_a_jax_file_runs_in_the_port(tmp_path, name):
    build, shape, w, jpath, _ = _export_both(tmp_path, name)
    x = np.random.RandomState(1).randn(*shape).astype("f4")
    want = _jax_forward(_build(build, mx), w, x)
    s, args, aux = tonnx.import_model(jpath)
    for v in list(args.values()) + list(aux.values()):
        assert v.ctx == mt.cpu()
    assert sorted(aux) == sorted(k for k in w if "moving" in k)
    got = _port_forward(s, {**args, **aux}, x)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("name", sorted(NETS))
def test_a_port_file_runs_in_the_jax_package(tmp_path, name):
    build, shape, w, _, tpath = _export_both(tmp_path, name)
    x = np.random.RandomState(2).randn(*shape).astype("f4")
    want = _port_forward(_build(build, mt), w, x)
    s, args, aux = jonnx.import_model(tpath)
    got = _jax_forward(s, {**{k: v.asnumpy() for k, v in args.items()},
                           **{k: v.asnumpy() for k, v in aux.items()}}, x)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_the_import_is_the_same_graph_in_both_packages(tmp_path):
    *_, jpath, _ = _export_both(tmp_path, "convnet")
    ts, targs, taux = tonnx.import_model(jpath)
    js, jargs, jaux = jonnx.import_model(jpath)
    assert ts.list_arguments() == js.list_arguments()
    assert ts.list_auxiliary_states() == js.list_auxiliary_states()
    assert [n.op for n in ts._topo()] == [n.op for n in js._topo()]
    for k in jargs:
        np.testing.assert_array_equal(targs[k].asnumpy(),
                                      jargs[k].asnumpy())


def test_metadata(tmp_path):
    *_, jpath, tpath = _export_both(tmp_path, "convnet")
    meta = tonnx.get_model_metadata(tpath)
    assert meta == jonnx.get_model_metadata(jpath)
    assert meta["input_tensor_data"] == [("data", (2, 3, 8, 8))]
    assert meta["output_tensor_data"] == [("sm", (2, 10))]


def test_softplus_imports_as_softrelu(tmp_path):
    d = mt.sym.var("data")
    s = mt.sym.Activation(d, act_type="softrelu", name="sp")
    path = str(tmp_path / "sp.onnx")
    tonnx.export_model(s, {}, [(2, 3)], path)
    s2, _, _ = tonnx.import_model(path)
    x = np.random.RandomState(3).randn(2, 3).astype("f4")
    np.testing.assert_allclose(_port_forward(s2, {}, x),
                               np.log1p(np.exp(x)), rtol=RTOL, atol=ATOL)


def test_an_unsupported_operator_raises_with_its_name(tmp_path):
    d = mt.sym.var("data")
    s = mt.sym.MultiBoxPrior(d, sizes=(0.5,), name="prior")
    with pytest.raises(MXNetError, match="'MultiBoxPrior' has no ONNX"):
        tonnx.export_model(s, {}, [(1, 3, 4, 4)], str(tmp_path / "x.onnx"))
    g = tproto.Graph(name="g", nodes=[tproto.Node(
        op_type="Erf", inputs=["data"], outputs=["y"], name="erf")],
        inputs=[tproto.ValueInfo("data", tproto.DT_FLOAT, [2])],
        outputs=[tproto.ValueInfo("y", tproto.DT_FLOAT, [2])])
    path = str(tmp_path / "erf.onnx")
    tproto.save(tproto.Model(graph=g), path)
    with pytest.raises(MXNetError, match="'Erf' has no mapping"):
        tonnx.import_model(path)
