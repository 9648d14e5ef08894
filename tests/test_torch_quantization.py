"""The port's int8 quantization against the JAX package on the CPU.

* Every name of ``ops/quantization.py`` through both registries on the
  same numpy inputs (from a seed).  Integer outputs (``quantize*``,
  ``requantize``, ``quantized_conv/fully_connected/pooling/flatten``)
  must be equal, apart from elements whose scaled value lies within one
  float32 ulp of a half, which are counted and printed (which way such
  an element rounds depends on the last bit of a product).  Float
  outputs (the ranges, ``dequantize``) within 4 ulps of their largest
  magnitude: XLA's CPU backend
  folds the constant factors under jit (``(a/127)·(b/127)·(2^31 - 1)``
  becomes ``a·b·133144.25``), eager PyTorch computes them as written.
* ``quantized_conv`` across NCHW and NHWC, groups, stride, padding,
  dilation, Ci = 3 at 7x7/2, depthwise and 1-d, against JAX's ``lax``
  int32 result; the plain version's float64 sums are exact.
* The calibration: ``_get_optimal_threshold`` within 1e-6 relative (the
  same numpy code), ``calib_thresholds`` naive within 1e-5 relative (the
  two packages' float32 convolutions round differently).
* ``quantize_model`` on a small symbolic convnet in each calibration
  mode: the same graph (node for node, the calibrated ranges within
  1e-5 relative naive and two histogram bins entropy), the int8 weights
  and their ranges bit for bit, and the quantized output within 2% of
  the logits' scale of the JAX quantized graph's, with the count of
  int8 activations one step apart printed.
* int8 weights written to ``.params`` by one package and read by the
  other; the namespaces ``nd.contrib``, ``sym.contrib``,
  ``contrib.ndarray``/``symbol``/``quantization``; the example
  ``--cpu --small``.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu.contrib import quantization as jq

import mxnet_tpu_torch as mt
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.contrib import quantization as tq
from mxnet_tpu_torch.ops import quantized_conv as tqc

import torch_parity as tp


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread while this file runs (the other workers hold
    the cores), restored after it."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _i8(rs, *shape):
    return rs.randint(-127, 128, shape).astype(np.int8)


def _rng(lo, hi, rs):
    return np.array([rs.uniform(lo, hi)], np.float32)


def _near_half(scaled):
    """Elements whose float32 value lies within one ulp of a half."""
    s = np.asarray(scaled, np.float32)
    frac = np.abs(s - np.floor(s) - np.float32(0.5))
    return int((frac <= np.spacing(np.abs(s))).sum())


def _hold(name, arrays, attrs, near=0):
    j, _ = tp.jax_run(name, arrays, attrs)
    t, _ = tp.port_run(name, arrays, attrs)
    assert len(j) == len(t)
    for a, b in zip(j, t):
        assert a.dtype == b.dtype and a.shape == b.shape, (name, a.dtype,
                                                           b.dtype)
        if a.dtype.kind == "f":
            tol = 4 * 2.0 ** -23 * max(float(np.abs(a).max(initial=0)),
                                       2.0 ** -126)
            np.testing.assert_allclose(b, a, rtol=0, atol=tol,
                                       err_msg=f"{name} {attrs}")
        else:
            diff = int((a != b).sum())
            print(f"{name} {attrs}: {diff} integer elements differ, "
                  f"{near} within an ulp of a half")
            assert diff <= near, (name, attrs, diff, near)
            assert np.abs(a.astype(np.int64) - b.astype(np.int64)).max(
                initial=0) <= 1
    return j, t


# ---------------------------------------------------------------------------
# the ops
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("out_type", ["int8", "uint8"])
def test_quantize(out_type):
    rs = np.random.RandomState(0)
    x = (rs.randn(4, 5, 6) * 3).astype(np.float32)
    lo, hi = np.float32(-2.5), np.float32(3.1)
    if out_type == "int8":
        scaled = x * (np.float32(127) / max(abs(lo), abs(hi)))
    else:
        scaled = (x - lo) * (np.float32(255) / (hi - lo))
    _hold("_contrib_quantize", [x, np.array([lo]), np.array([hi])],
          {"out_type": out_type}, _near_half(scaled))
    _hold("quantize", [x, np.array([lo]), np.array([hi])],
          {"out_type": out_type}, _near_half(scaled))


@pytest.mark.parametrize("attrs", [
    {"out_type": "int8"}, {"out_type": "uint8"},
    {"out_type": "int8", "min_calib_range": -1.3, "max_calib_range": 2.7},
    {"out_type": "uint8", "min_calib_range": -1.3, "max_calib_range": 2.7}])
def test_quantize_v2(attrs):
    rs = np.random.RandomState(1)
    x = (rs.randn(3, 7, 5) * 2).astype(np.float32)
    lo = np.float32(attrs.get("min_calib_range", x.min()))
    hi = np.float32(attrs.get("max_calib_range", x.max()))
    lo, hi = min(lo, np.float32(0)), max(hi, np.float32(0))
    scaled = x * (np.float32(127) / max(abs(lo), abs(hi))) \
        if attrs["out_type"] == "int8" else \
        (x - lo) * (np.float32(255) / (hi - lo))
    _hold("_contrib_quantize_v2", [x], attrs, _near_half(scaled))


@pytest.mark.parametrize("kind", ["int8", "uint8", "int32"])
def test_dequantize(kind):
    rs = np.random.RandomState(2)
    data = {"int8": _i8(rs, 3, 4, 5),
            "uint8": rs.randint(0, 256, (3, 4, 5)).astype(np.uint8),
            "int32": rs.randint(-2 ** 30, 2 ** 30, (3, 4, 5)).astype(
                np.int32)}[kind]
    _hold("_contrib_dequantize", [data, _rng(-3, -1, rs), _rng(1, 3, rs)],
          {})


@pytest.mark.parametrize("calib", [{}, {"min_calib_range": -0.5,
                                        "max_calib_range": 0.4}])
def test_requantize(calib):
    rs = np.random.RandomState(3)
    acc = rs.randint(-2 ** 30, 2 ** 30, (4, 6)).astype(np.int32)
    lo, hi = _rng(-3, -1, rs), _rng(1, 3, rs)
    f = acc.astype(np.float32) * (max(abs(lo[0]), abs(hi[0]))
                                  / np.float32(2 ** 31))
    th = max(abs(calib.get("min_calib_range", f.min())),
             abs(calib.get("max_calib_range", f.max())))
    _hold("_contrib_requantize", [acc, lo, hi], calib,
          _near_half(f * (np.float32(127) / np.float32(th))))
    with pytest.raises(MXNetError, match="int32"):
        mt.nd.requantize(mt.nd.array(np.ones((2,), np.int8), ctx=tp.CPU),
                         mt.nd.array(lo, ctx=tp.CPU),
                         mt.nd.array(hi, ctx=tp.CPU))


CONV_CASES = [
    ("basic3x3", (2, 16, 9, 9), (32, 16, 3, 3),
     dict(kernel=(3, 3), num_filter=32, pad=(1, 1))),
    ("stem_ci3_7x7s2", (2, 3, 15, 15), (8, 3, 7, 7),
     dict(kernel=(7, 7), num_filter=8, stride=(2, 2), pad=(3, 3))),
    ("groups2_dilate2", (2, 6, 9, 9), (8, 3, 3, 3),
     dict(kernel=(3, 3), num_filter=8, num_group=2, stride=(2, 1),
          pad=(1, 2), dilate=(2, 1))),
    ("groups32", (1, 64, 6, 6), (64, 2, 3, 3),
     dict(kernel=(3, 3), num_filter=64, num_group=32, pad=(1, 1))),
    ("depthwise", (2, 8, 7, 7), (8, 1, 3, 3),
     dict(kernel=(3, 3), num_filter=8, num_group=8, pad=(1, 1))),
    ("nhwc_stem", (2, 15, 15, 3), (8, 3, 7, 7),
     dict(kernel=(7, 7), num_filter=8, stride=(2, 2), pad=(3, 3),
          layout="NHWC")),
    ("nhwc_1x1s2", (2, 8, 8, 32), (16, 32, 1, 1),
     dict(kernel=(1, 1), num_filter=16, stride=(2, 2), layout="NHWC")),
    ("conv1d", (2, 4, 11), (6, 4, 3),
     dict(kernel=(3,), num_filter=6, pad=(1,))),
]


@pytest.mark.parametrize("name,xs,ws,attrs", CONV_CASES,
                         ids=[c[0] for c in CONV_CASES])
def test_quantized_conv(name, xs, ws, attrs):
    rs = np.random.RandomState(4)
    arrays = [_i8(rs, *xs), _i8(rs, *ws), _rng(-2, -1, rs), _rng(1, 2, rs),
              _rng(-1, 0, rs), _rng(0, 1, rs)]
    j, t = _hold("_contrib_quantized_conv", arrays, attrs)
    # the plain version is exactly the int64 sum, whatever the layout
    nhwc = attrs.get("layout", "NCHW")[-1] == "C"
    ref = tqc.int8_conv_ref(torch.from_numpy(arrays[0]),
                            torch.from_numpy(arrays[1]),
                            attrs.get("stride", ()), attrs.get("pad", ()),
                            attrs.get("dilate", ()),
                            attrs.get("num_group", 1), nhwc)
    np.testing.assert_array_equal(ref.numpy(), j[0])


@pytest.mark.parametrize("flatten,xs,ws", [(True, (3, 4, 5), (7, 20)),
                                           (False, (3, 4, 5), (7, 5))])
def test_quantized_fully_connected(flatten, xs, ws):
    rs = np.random.RandomState(5)
    _hold("_contrib_quantized_fully_connected",
          [_i8(rs, *xs), _i8(rs, *ws), _rng(-2, -1, rs), _rng(1, 2, rs),
           _rng(-1, 0, rs), _rng(0, 1, rs)],
          {"num_hidden": ws[0], "flatten": flatten})


@pytest.mark.parametrize("attrs,dtype", [
    (dict(kernel=(3, 3), stride=(2, 2), pad=(1, 1), pool_type="max"),
     np.int8),
    (dict(kernel=(3, 3), stride=(2, 2), pad=(1, 1), pool_type="avg",
          pooling_convention="full"), np.int8),
    (dict(kernel=(2, 2), stride=(2, 2), pool_type="avg", layout="NHWC"),
     np.uint8),
    (dict(kernel=(2, 3), pool_type="max", layout="NHWC"), np.uint8),
    (dict(global_pool=True, pool_type="avg"), np.int8),
    (dict(global_pool=True, pool_type="max"), np.uint8)])
def test_quantized_pooling(attrs, dtype):
    rs = np.random.RandomState(6)
    shape = (2, 7, 8, 3) if attrs.get("layout") == "NHWC" else (2, 3, 7, 8)
    info = np.iinfo(dtype)
    data = rs.randint(info.min + (dtype == np.int8), info.max + 1,
                      shape).astype(dtype)
    _hold("_contrib_quantized_pooling",
          [data, _rng(-2, -1, rs), _rng(1, 2, rs)], attrs)


def test_quantized_flatten_and_the_stubs():
    rs = np.random.RandomState(7)
    _hold("_contrib_quantized_flatten",
          [_i8(rs, 2, 3, 4, 5), _rng(-2, -1, rs), _rng(1, 2, rs)], {})
    for name in ("_contrib_quantized_act", "_contrib_quantized_concat",
                 "_contrib_quantized_elemwise_add"):
        with pytest.raises(MXNetError, match="not provided as a standalone"):
            mt.ops.registry.invoke(name, mt.nd.zeros((2,), ctx=tp.CPU))


def test_int8_conv_on_the_cpu_is_its_plain_version():
    """On CPU tensors the wrapper runs the plain version, and the
    weight layout the kernel reads is (G, Co/G, Kpad), K ordered (kh, kw,
    ci), zero past K."""
    rs = np.random.RandomState(8)
    x = torch.from_numpy(_i8(rs, 2, 6, 5, 5))
    w = torch.from_numpy(_i8(rs, 4, 3, 3, 3))
    assert torch.equal(tqc.int8_conv(x, w, (1, 1), (1, 1), (), 2),
                       tqc.int8_conv_ref(x, w, (1, 1), (1, 1), (), 2))
    wl, kpad = tqc.weight_layout(w, 2)
    assert wl.shape == (2, 2, 64) and kpad == 64
    assert torch.equal(wl[1, 0, :27], w[2].permute(1, 2, 0).reshape(-1))
    assert not wl[..., 27:].any()
    with pytest.raises(MXNetError, match="int8 data"):
        tqc.int8_conv(x.float(), w)


# ---------------------------------------------------------------------------
# calibration and the graph rewrite
# ---------------------------------------------------------------------------

def test_optimal_threshold_is_the_jax_one():
    rs = np.random.RandomState(9)
    for samples in (rs.randn(50000), np.abs(rs.standard_cauchy(30000)),
                    np.zeros(10), rs.rand(1000) * 1e-3):
        j = jq._get_optimal_threshold(samples)
        t = tq._get_optimal_threshold(samples)
        assert abs(t - j) <= 1e-6 * abs(j), (t, j)


def _convnet(sym, nclass=5):
    data = sym.var("data")
    net = sym.Convolution(data, kernel=(3, 3), num_filter=8, pad=(1, 1),
                          name="conv1")
    net = sym.Activation(net, act_type="relu", name="relu1")
    net = sym.Pooling(net, kernel=(2, 2), stride=(2, 2), pool_type="max",
                      name="pool1")
    net = sym.Convolution(net, kernel=(3, 3), num_filter=16, pad=(1, 1),
                          no_bias=True, name="conv2")
    net = sym.Activation(net, act_type="relu", name="relu2")
    net = sym.FullyConnected(net, num_hidden=nclass, name="fc")
    return sym.SoftmaxOutput(net, sym.var("softmax_label"), name="softmax")


def _params(seed=0):
    rs = np.random.RandomState(seed)
    return {"conv1_weight": rs.randn(8, 3, 3, 3) * 0.3,
            "conv1_bias": rs.randn(8) * 0.1,
            "conv2_weight": rs.randn(16, 8, 3, 3) * 0.1,
            "fc_weight": rs.randn(5, 16 * 4 * 4) * 0.1,
            "fc_bias": rs.randn(5) * 0.1}


@pytest.fixture(scope="module")
def calib_batches():
    rs = np.random.RandomState(10)
    return [rs.randn(6, 3, 8, 8).astype(np.float32) for _ in range(2)]


def _quantize_both(mode, batches, excluded=()):
    p = {k: v.astype(np.float32) for k, v in _params().items()}
    jargs = {k: mx.nd.array(v) for k, v in p.items()}
    targs = {k: mt.nd.array(v, ctx=tp.CPU) for k, v in p.items()}
    calib_j = None if mode == "none" else [mx.nd.array(b) for b in batches]
    calib_t = None if mode == "none" else [mt.nd.array(b, ctx=tp.CPU)
                                           for b in batches]
    jres = jq.quantize_model(_convnet(mx.sym), jargs, {}, calib_mode=mode,
                             calib_data=calib_j,
                             excluded_sym_names=excluded)
    tres = tq.quantize_model(_convnet(mt.sym), targs, {}, calib_mode=mode,
                             calib_data=calib_t,
                             excluded_sym_names=excluded)
    return jres, tres


def _same_graph(jsym, tsym, mode):
    """Node for node: op, name, inputs and attributes; the calibrated
    ranges within 1e-5 relative (naive) or two of the 2001 histogram bins
    of the tensor's largest magnitude (entropy)."""
    jn = json.loads(jsym.tojson())
    tn = json.loads(tsym.tojson())
    assert jn["heads"] == tn["heads"]
    assert [(n["op"], n["name"], n["inputs"]) for n in jn["nodes"]] == \
        [(n["op"], n["name"], n["inputs"]) for n in tn["nodes"]]
    worst = 0.0
    for a, b in zip(jn["nodes"], tn["nodes"]):
        ja, ta = a.get("attrs", {}), b.get("attrs", {})
        assert set(ja) == set(ta), a["name"]
        for k in ja:
            if k.endswith("_calib_range"):
                x, y = float(ja[k]), float(ta[k])
                tol = 1e-5 * abs(x) if mode == "naive" \
                    else 2 * abs(x) / 2001 + 1e-6
                worst = max(worst, abs(x - y) / max(abs(x), 1e-30))
                assert abs(x - y) <= tol, (a["name"], k, x, y)
            else:
                assert ja[k] == ta[k], (a["name"], k)
    return worst


def _run_q(pkg, qsym, qargs, x, internals=False):
    ctx = mx.cpu() if pkg is mx else tp.CPU
    s = qsym
    if internals:
        inner = qsym.get_internals()
        names = [n for n in inner.list_outputs()
                 if n.endswith("_quantize_output0")]
        s = pkg.sym.Group([inner[n] for n in names])
    args = dict(qargs, data=pkg.nd.array(x, ctx=ctx),
                softmax_label=pkg.nd.zeros((x.shape[0],), ctx=ctx))
    exe = s.bind(ctx, args, grad_req="null", aux_states={})
    return [o.asnumpy() for o in exe.forward()]


@pytest.mark.parametrize("mode", ["none", "naive", "entropy"])
def test_quantize_model_matches_jax(mode, calib_batches):
    (jsym, jargs, _), (tsym, targs, _) = _quantize_both(mode, calib_batches)
    assert set(jargs) == set(targs)
    for k in jargs:
        j, t = jargs[k].asnumpy(), targs[k].asnumpy()
        assert j.dtype == t.dtype and np.array_equal(j, t), k
    assert targs["conv1_weight_quantized"].dtype == np.int8
    assert "conv1_weight" not in targs and "fc_weight" not in targs
    worst = _same_graph(jsym, tsym, mode)
    x = np.random.RandomState(11).randn(4, 3, 8, 8).astype(np.float32)
    (jo,), (to,) = _run_q(mx, jsym, jargs, x), _run_q(mt, tsym, targs, x)
    scale = np.abs(jo).max()
    err = np.abs(jo - to).max()
    jq8 = _run_q(mx, jsym, jargs, x, internals=True)
    tq8 = _run_q(mt, tsym, targs, x, internals=True)
    flips = sum(int((a != b).sum()) for a, b in zip(jq8, tq8))
    total = sum(a.size for a in jq8)
    far = max(int(np.abs(a.astype(int) - b.astype(int)).max())
              for a, b in zip(jq8, tq8))
    print(f"quantize_model {mode}: calibrated ranges at most {worst:.3g} "
          f"relative apart; {flips} of {total} int8 activations one step "
          f"apart; output max abs diff {err:.3g} of scale {scale:.3g}")
    assert far <= 1
    assert err <= 0.02 * scale


def test_quantize_model_excludes_and_refuses(calib_batches):
    (jsym, jargs, _), (tsym, targs, _) = _quantize_both(
        "naive", calib_batches, excluded=("fc",))
    assert "fc_weight" in targs and "fc_weight_quantized" not in targs
    _same_graph(jsym, tsym, "naive")
    p = {k: mt.nd.array(v.astype(np.float32), ctx=tp.CPU)
         for k, v in _params().items()}
    with pytest.raises(MXNetError, match="calib_data"):
        tq.quantize_model(_convnet(mt.sym), p, {}, calib_mode="naive")
    with pytest.raises(MXNetError, match="quantized_dtype"):
        tq.quantize_model(_convnet(mt.sym), p, {}, calib_mode="none",
                          quantized_dtype="uint8")
    with pytest.raises(MXNetError, match="no quantizable"):
        tq.quantize_model(_convnet(mt.sym), p, {}, calib_mode="none",
                          excluded_sym_names=("conv1", "conv2", "fc"))


def test_calib_thresholds_naive(calib_batches):
    p = {k: v.astype(np.float32) for k, v in _params().items()}
    names = ["relu1_output", "conv2_output", "pool1_output"]
    j = jq.calib_thresholds(_convnet(mx.sym),
                            {k: mx.nd.array(v) for k, v in p.items()}, {},
                            names, [mx.nd.array(b) for b in calib_batches])
    t = tq.calib_thresholds(_convnet(mt.sym),
                            {k: mt.nd.array(v, ctx=tp.CPU)
                             for k, v in p.items()}, {}, names,
                            [mt.nd.array(b, ctx=tp.CPU)
                             for b in calib_batches])
    assert set(j) == set(t) == set(names)
    for n in names:
        np.testing.assert_allclose(t[n], j[n], rtol=1e-5, atol=1e-7)


def test_calib_thresholds_entropy_hands_out_its_samples(calib_batches):
    p = {k: mt.nd.array(v.astype(np.float32), ctx=tp.CPU)
         for k, v in _params().items()}
    names = ["relu1_output", "conv2_output"]
    batches = [mt.nd.array(b, ctx=tp.CPU) for b in calib_batches]
    samples = {}
    t = tq.calib_thresholds(_convnet(mt.sym), p, {}, names, batches,
                            calib_mode="entropy", samples_out=samples)
    # a second call on the same batches gives the same thresholds: the
    # calibration leaves its batches as they were (the JAX package's
    # writes the later batches into the first)
    assert t == tq.calib_thresholds(_convnet(mt.sym), p, {}, names, batches,
                                    calib_mode="entropy")
    for b, want in zip(batches, calib_batches):
        np.testing.assert_array_equal(b.asnumpy(), want)
    assert set(samples) == set(names)
    for n in names:
        assert samples[n].size == len(calib_batches) * 6 * 8 * 8 * (
            8 if n == "relu1_output" else 4)
        th = tq._get_optimal_threshold(samples[n])
        assert t[n] == (-th, th)


def test_int8_params_files_move_both_ways(tmp_path, calib_batches):
    (_, jargs, _), (_, targs, _) = _quantize_both("none", calib_batches)
    tpath, jpath = str(tmp_path / "port.params"), str(tmp_path / "jax.params")
    mt.nd.save(tpath, targs)
    mx.nd.save(jpath, jargs)
    from_port = mx.nd.load(tpath)
    from_jax = mt.nd.load(jpath)
    for k in targs:
        a, b = from_port[k].asnumpy(), from_jax[k].asnumpy()
        assert a.dtype == b.dtype == targs[k].asnumpy().dtype, k
        assert np.array_equal(a, targs[k].asnumpy())
        assert np.array_equal(b, jargs[k].asnumpy())


# ---------------------------------------------------------------------------
# the namespaces and the example
# ---------------------------------------------------------------------------

def test_the_contrib_namespaces():
    assert mt.nd.contrib is mt.contrib.ndarray is mt.contrib.nd
    assert mt.sym.contrib is mt.contrib.symbol is mt.contrib.sym
    assert mt.contrib.quantization.quantize_model is tq.quantize_model
    assert mt.nd.contrib.Proposal.__name__ == "_contrib_Proposal"
    assert mt.nd.contrib.MultiBoxPrior.__name__ == "_contrib_MultiBoxPrior"
    assert mt.nd.contrib.box_encode.__name__ == "_contrib_box_encode"
    for pkg in (mt, mx):  # the same nodes as the JAX namespace makes
        s = pkg.sym.contrib.ROIAlign(pkg.sym.var("data"),
                                     pkg.sym.var("rois"),
                                     pooled_size=(2, 2), name="ra")
        q = pkg.contrib.symbol.quantize_v2(pkg.sym.var("x"), name="q")
        if pkg is mt:
            got = (s.tojson(), q.tojson(), len(q), s.list_arguments())
    assert got == (s.tojson(), q.tojson(), 3, ["data", "rois"])
    with pytest.raises(AttributeError, match="no contrib op"):
        mt.nd.contrib.no_such_op
    with pytest.raises(AttributeError, match="no contrib symbol op"):
        mt.sym.contrib.no_such_op
    # the control flow is ported (contrib/control_flow.py)
    for name in ("foreach", "while_loop", "cond"):
        assert getattr(mt.nd.contrib, name) is getattr(
            mt.contrib.control_flow, name)
    assert mt.nd.contrib.cond(True, lambda: 1, lambda: 2) == 1
    with pytest.raises(MXNetError, match="max_iterations"):
        mt.nd.contrib.while_loop(lambda i: i, lambda i: (i, i), [None])
    x = mt.nd.array(np.arange(6, dtype=np.float32).reshape(3, 2),
                    ctx=tp.CPU)
    out = mt.nd.contrib.boolean_mask(
        x, mt.nd.array(np.array([1, 0, 1], np.float32), ctx=tp.CPU))
    np.testing.assert_array_equal(out.asnumpy(), [[0, 1], [4, 5]])


def test_the_example_on_the_cpu():
    env = dict(os.environ, PYTHONPATH=REPO, JAX_PLATFORMS="cpu",
               OMP_NUM_THREADS="1")
    res = subprocess.run(
        [sys.executable, "-m", "mxnet_tpu_torch.examples.quantize_model",
         "--cpu", "--small", "--calib-mode", "naive"],
        capture_output=True, text=True, cwd=REPO, env=env, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
    assert "accuracy drop" in res.stdout
    drop = float(res.stdout.split("accuracy drop:")[1].split()[0])
    assert drop <= 0.05
