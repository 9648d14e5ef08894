"""mxnet_tpu_torch's symbolic API against the JAX package's, on the CPU.

The same graphs are composed through ``mxnet_tpu.sym`` and
``mxnet_tpu_torch.sym``: their argument, output and aux lists, inferred
shapes and ``tojson`` text must be equal (the text byte for byte), and
each package must load the other's files.  Bound executors get the same
seeded numpy inputs: forwards in fp32 within 1e-5 relative (1e-6
absolute), gradients of the training step within 1e-5 relative on the
MLP; the narrow two-stage ResNet v1's training step (BatchNorm over a few
samples of small maps, ill-conditioned in fp32) runs in float64 in both
packages (``jax.enable_x64``) within 1e-9.  The two kernel ops that the
port registers since this slice (``FusedConvUnit``,
``dot_product_attention``) are held against the JAX ops through ``nd``,
``F`` and ``sym`` within 1e-5 (1e-4 of the summed magnitude for the
statistics).
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch.base import MXNetError

CPU_J, CPU_T = jmx.cpu(), tmx.cpu()
RTOL, ATOL = 1e-5, 1e-6


def _close(t, j, rtol=RTOL, atol=ATOL):
    t = t.asnumpy() if hasattr(t, "asnumpy") else np.asarray(t)
    j = j.asnumpy() if hasattr(j, "asnumpy") else np.asarray(j)
    assert t.shape == j.shape, (t.shape, j.shape)
    np.testing.assert_allclose(t, j, rtol=rtol, atol=atol)


def mlp(s, hidden=16, classes=4):
    data = s.var("data")
    fc1 = s.FullyConnected(data, num_hidden=hidden, name="fc1")
    act = s.Activation(fc1, act_type="relu", name="relu1")
    fc2 = s.FullyConnected(act, num_hidden=classes, name="fc2")
    return s.SoftmaxOutput(fc2, name="softmax")


def _conv_bn(s, x, ch, k, stride, pad, name, relu=True):
    c = s.Convolution(x, num_filter=ch, kernel=(k, k), stride=(stride,
                      stride), pad=(pad, pad), no_bias=True,
                      name=f"{name}_conv")
    b = s.BatchNorm(c, fix_gamma=False, eps=2e-5, momentum=0.9,
                    name=f"{name}_bn")
    return s.Activation(b, act_type="relu", name=f"{name}_relu") \
        if relu else b


def resnet_v1(s, stages=((8, 1), (16, 2)), classes=10, bottleneck=False):
    """A ResNet v1 in ``s`` (either package's ``sym``): the stem (3x3
    here; 7x7 stride 2 and a 3x3 max pool at full width), then one block
    a stage, basic or bottleneck (the stride on the first 1x1, as
    ``gluon.model_zoo.vision.resnet``'s V1), a 1x1 projection where the
    shape changes, global average pooling and a SoftmaxOutput head."""
    x = s.var("data")
    x = _conv_bn(s, x, stages[0][0], 3, 1, 1, "stem")
    x = s.Pooling(x, kernel=(3, 3), stride=(2, 2), pad=(1, 1),
                  pool_type="max", name="stem_pool")
    cin = stages[0][0]
    for i, (ch, stride) in enumerate(stages):
        name = f"stage{i + 1}"
        if bottleneck:
            h = _conv_bn(s, x, ch // 4, 1, stride, 0, f"{name}_a")
            h = _conv_bn(s, h, ch // 4, 3, 1, 1, f"{name}_b")
            h = _conv_bn(s, h, ch, 1, 1, 0, f"{name}_c", relu=False)
        else:
            h = _conv_bn(s, x, ch, 3, stride, 1, f"{name}_a")
            h = _conv_bn(s, h, ch, 3, 1, 1, f"{name}_b", relu=False)
        sc = x if (ch == cin and stride == 1) else _conv_bn(
            s, x, ch, 1, stride, 0, f"{name}_proj", relu=False)
        x = s.Activation(h + sc, act_type="relu", name=f"{name}_out")
        cin = ch
    x = s.Pooling(x, global_pool=True, pool_type="avg", kernel=(1, 1),
                  name="pool")
    x = s.Flatten(x, name="flat")
    x = s.FullyConnected(x, num_hidden=classes, name="fc")
    return s.SoftmaxOutput(x, name="softmax")


def _params(sym_t, shapes, seed, dtype=np.float32):
    """Seeded arguments and aux states for a graph: weights ~ N(0, 1/fan
    in), BatchNorm gamma near 1, moving variances positive."""
    rs = np.random.RandomState(seed)
    arg_shapes, _, aux_shapes = sym_t.infer_shape(**shapes)
    args = {}
    for n, shp in zip(sym_t.list_arguments(), arg_shapes):
        if n in shapes:
            continue
        if n.endswith("gamma"):
            v = 1 + 0.1 * rs.randn(*shp)
        elif n.endswith(("beta", "bias")):
            v = 0.1 * rs.randn(*shp)
        else:
            v = rs.randn(*shp) / np.sqrt(np.prod(shp[1:]))
        args[n] = v.astype(dtype)
    aux = {}
    for n, shp in zip(sym_t.list_auxiliary_states(), aux_shapes):
        v = 0.1 * rs.randn(*shp) if n.endswith("mean") else \
            0.5 + rs.rand(*shp)
        aux[n] = v.astype(dtype)
    return args, aux


def _bind_both(make, inputs, args, aux, grad_req="write", dtype="float32"):
    """Bind ``make(sym)`` in both packages on the same numpy values."""
    exes = []
    for mx_, ctx in ((jmx, CPU_J), (tmx, CPU_T)):
        s = make(mx_.sym)
        vals = {**inputs, **args}
        nd_args = {n: mx_.nd.array(vals[n], ctx=ctx, dtype=dtype)
                   for n in s.list_arguments()}
        nd_aux = [mx_.nd.array(aux[n], ctx=ctx, dtype=dtype)
                  for n in s.list_auxiliary_states()]
        exes.append(s.bind(ctx, nd_args, grad_req=grad_req,
                           aux_states=nd_aux))
    return exes


# ---------------------------------------------------------------------------
# composition, shapes, operators
# ---------------------------------------------------------------------------

def test_compose_lists_match():
    for make in (mlp, resnet_v1):
        j, t = make(jmx.sym), make(tmx.sym)
        assert t.list_arguments() == j.list_arguments()
        assert t.list_outputs() == j.list_outputs()
        assert t.list_auxiliary_states() == j.list_auxiliary_states()
    assert mlp(tmx.sym).list_arguments() == [
        "data", "fc1_weight", "fc1_bias", "fc2_weight", "fc2_bias",
        "softmax_label"]


@pytest.mark.parametrize("make,shapes", [
    (mlp, {"data": (8, 10)}),
    (resnet_v1, {"data": (2, 3, 8, 8)}),
    (lambda s: s.Pooling(s.Convolution(s.var("data"), kernel=(3, 3),
                                       num_filter=8, pad=(1, 1),
                                       name="conv1"),
                         kernel=(2, 2), stride=(2, 2), pool_type="max",
                         name="pool1"), {"data": (2, 3, 8, 8)}),
    (lambda s: s.Embedding(s.var("data"), input_dim=20, output_dim=5,
                           name="embed0"), {"data": (3, 7)}),
    (lambda s: s.BatchNorm(s.var("data"), name="bn"),
     {"data": (4, 6, 5, 5)}),
    (lambda s: s.Convolution(s.var("data"), kernel=(3, 3), num_filter=8,
                             num_group=2, name="gconv"),
     {"data": (1, 4, 8, 8)}),
], ids=["mlp", "resnet", "conv_pool", "embedding", "batchnorm", "group"])
def test_infer_shape_both_ways_matches(make, shapes):
    j, t = make(jmx.sym), make(tmx.sym)
    assert t.infer_shape(**shapes) == tuple(
        [tuple(s) for s in part] for part in j.infer_shape(**shapes))
    # backwards: a weight's shape known, the data's not
    jp = j.infer_shape_partial()
    tp = t.infer_shape_partial()
    assert tp == tuple(list(p) for p in jp)
    with pytest.raises(MXNetError, match="incomplete"):
        t.infer_shape()


def test_mlp_shape_values():
    arg, out, aux = mlp(tmx.sym).infer_shape(data=(8, 10))
    assert arg == [(8, 10), (16, 10), (16,), (4, 16), (4,), (8,)]
    assert out == [(8, 4)] and aux == []


def _eval_both(make, feed):
    outs = []
    for mx_, ctx in ((jmx, CPU_J), (tmx, CPU_T)):
        s = make(mx_.sym)
        ex = s.bind(ctx, {k: mx_.nd.array(v, ctx=ctx)
                          for k, v in feed.items()})
        outs.append([o.asnumpy() for o in ex.forward()])
    return outs


A2 = np.array([[2.0, 3.0]], "f4")


@pytest.mark.parametrize("expr", [
    lambda s: (s.var("a") + s.var("b")) * 2.0 - s.var("b") / 2.0,
    lambda s: 1.0 - s.var("a") / s.var("b") + 3.0 / s.var("a"),
    lambda s: -(s.var("a") ** 2.0) + s.var("a") ** s.var("b"),
    lambda s: s.maximum(s.var("a"), 2.5) + s.minimum(s.var("a"),
                                                     s.var("b")),
    lambda s: s.power(2, s.var("a")) + s.modulo(7, s.var("a")),
    lambda s: s.logical_xor(s.var("a"), 1.0) + s.logical_and(
        s.var("a"), s.var("b")),
    lambda s: s.var("a").reshape((2, 1)).transpose().sum(axis=1),
    lambda s: s.elemwise_mul(s.var("a"), s.var("b")).softmax(),
], ids=["arith", "rscalar", "pow", "maxmin", "rpow_rmod", "logical",
        "shape", "elemwise"])
def test_operators_on_symbols_match(expr):
    feed = {"a": A2, "b": np.array([[0.0, 3.0]], "f4") + 1}
    j, t = _eval_both(expr, feed)
    for a, b in zip(t, j):
        _close(a, b)


def test_group_getitem_and_internals():
    def make(s):
        a = s.var("a")
        return s.Group([a * 2.0, a + 1.0])
    j, t = _eval_both(make, {"a": np.array([1.0, 2.0], "f4")})
    _close(t[0], j[0])
    _close(t[1], j[1])
    g = make(tmx.sym)
    assert len(g.list_outputs()) == 2
    assert g[1].list_outputs() == g.list_outputs()[1:2]
    internals = mlp(tmx.sym).get_internals()
    assert internals.list_outputs() == mlp(jmx.sym).get_internals() \
        .list_outputs()
    fc1 = internals["fc1_output"]
    assert fc1.infer_shape(data=(2, 10))[1] == [(2, 16)]
    assert mlp(tmx.sym).get_children().list_outputs() == ["fc2_output",
                                                          "softmax_label_output"]


def test_attributes_and_name_scopes():
    for mx_ in (jmx, tmx):
        with mx_.name.NameManager():
            with mx_.AttrScope(ctx_group="dev1"):
                a = mx_.sym.var("a", lr_mult=2.0)
                fc = mx_.sym.FullyConnected(a, num_hidden=3)
            assert fc.name == "fullyconnected0"
            assert fc.attr("__ctx_group__") == "dev1"
            assert a.list_attr() == {"__ctx_group__": "dev1",
                                     "__lr_mult__": "2.0"}
        with mx_.name.Prefix("net_"):
            assert mx_.sym.Activation(a, act_type="relu").name == \
                "net_activation0"
    assert tmx.sym.var("x").attr_dict() == jmx.sym.var("x").attr_dict()
    with pytest.raises(MXNetError, match="no attribute 'num_hiden'"):
        tmx.sym.FullyConnected(tmx.sym.var("x"), num_hiden=3)


# ---------------------------------------------------------------------------
# JSON: the same text, loading both ways, the reference's and old layouts
# ---------------------------------------------------------------------------

def _named(make):
    def run(s, mx_):
        with mx_.name.NameManager():
            return make(s)
    return run


GRAPHS = {
    "mlp": mlp,
    "resnet": resnet_v1,
    "bottleneck": lambda s: resnet_v1(s, stages=((16, 1), (32, 2)),
                                      bottleneck=True),
    "auto_names": lambda s: s.Activation(s.FullyConnected(
        s.Dropout(s.var("x", shape=(2, 5)), p=0.25), num_hidden=3),
        act_type="tanh") * 2.0,
    "attention": lambda s: s.dot_product_attention(
        s.var("q"), s.var("k"), s.var("v"), valid_mask=s.var("m"),
        num_heads=2, causal=True),
}


@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_tojson_text_equal_and_loads_both_ways(name, tmp_path):
    make = GRAPHS[name]
    with jmx.name.NameManager():
        jtxt = make(jmx.sym).tojson()
    with tmx.name.NameManager():
        ttxt = make(tmx.sym).tojson()
    assert ttxt == jtxt
    data = json.loads(ttxt)
    for node in data["nodes"]:
        assert set(node) <= {"op", "name", "attrs", "inputs"}
    # each package loads the other's file and writes it back unchanged
    path = tmp_path / "net-symbol.json"
    path.write_text(jtxt)
    assert tmx.sym.load(str(path)).tojson() == jtxt
    path.write_text(ttxt)
    j2 = jmx.sym.load(str(path))
    assert j2.tojson() == ttxt
    t2 = tmx.sym.load_json(jtxt)
    assert t2.list_arguments() == j2.list_arguments()
    assert t2.list_auxiliary_states() == j2.list_auxiliary_states()


def test_load_reference_format_json():
    """A reference ``-symbol.json``: attrs as strings (under the legacy
    ``param`` key for BatchNorm), 2-long input entries, no aux marks, a
    ``relu`` node; the loaded graph's shapes and forward match the JAX
    package's."""
    ref_json = json.dumps({
        "nodes": [
            {"op": "null", "name": "data", "inputs": []},
            {"op": "null", "name": "conv_weight", "inputs": []},
            {"op": "Convolution", "name": "conv",
             "attrs": {"kernel": "(3, 3)", "num_filter": "8",
                       "pad": "(1, 1)", "no_bias": "True",
                       "cudnn_off": "False", "workspace": "512"},
             "inputs": [[0, 0, 0], [1, 0, 0]]},
            {"op": "null", "name": "bn_gamma", "inputs": []},
            {"op": "null", "name": "bn_beta", "inputs": []},
            {"op": "null", "name": "bn_moving_mean", "inputs": []},
            {"op": "null", "name": "bn_moving_var", "inputs": []},
            {"op": "BatchNorm", "name": "bn",
             "param": {"eps": "0.001", "momentum": "0.9",
                       "output_mean_var": "False", "cudnn_off": "False"},
             "inputs": [[2, 0], [3, 0], [4, 0], [5, 0], [6, 0]]},
            {"op": "relu", "name": "act", "inputs": [[7, 0, 0]]},
            {"op": "Pooling", "name": "pool",
             "attrs": {"kernel": "(2, 2)", "stride": "(2, 2)",
                       "pool_type": "max", "count_include_pad": "True"},
             "inputs": [[8, 0, 0]]},
        ],
        "arg_nodes": [0, 1, 3, 4, 5, 6],
        "node_row_ptr": list(range(11)),
        "heads": [[9, 0, 0]],
        "attrs": {"mxnet_version": ["int", 10700]},
    })
    t = tmx.sym.load_json(ref_json)
    j = jmx.sym.load_json(ref_json)
    assert t.list_arguments() == ["data", "conv_weight", "bn_gamma",
                                  "bn_beta"]
    assert t.list_auxiliary_states() == ["bn_moving_mean", "bn_moving_var"]
    assert t.infer_shape(data=(2, 3, 8, 8)) == ([
        (2, 3, 8, 8), (8, 3, 3, 3), (8,), (8,)], [(2, 8, 4, 4)],
        [(8,), (8,)])
    args, aux = _params(t, {"data": (2, 3, 8, 8)}, 5)
    x = np.random.RandomState(6).randn(2, 3, 8, 8).astype("f4")
    ej, et = _bind_both(lambda s: tmx.sym.load_json(ref_json)
                        if s is tmx.sym else j, {"data": x}, args, aux)
    _close(et.forward()[0], ej.forward()[0])


def test_load_json_legacy_encodings():
    merged = json.dumps({
        "nodes": [
            {"op": "null", "name": "x", "inputs": [],
             "param": {}, "attr": {"__shape__": "(2, 5)"}},
            {"op": "null", "name": "fc_weight", "inputs": []},
            {"op": "null", "name": "fc_bias", "inputs": []},
            {"op": "FullyConnected", "name": "fc",
             "param": {"num_hidden": "3"}, "attr": {"__lr_mult__": "2.0"},
             "inputs": [[0, 0, 0], [1, 0, 0], [2, 0, 0]]},
        ],
        "arg_nodes": [0, 1, 2], "heads": [[3, 0, 0]],
    })
    assert tmx.sym.load_json(merged).infer_shape_partial()[1] == [(2, 3)]
    legacy = json.dumps({
        "nodes": [
            {"op": "null", "name": "data", "inputs": [],
             "shape_hint": [2, 3, 8, 8]},
            {"op": "null", "name": "c_weight", "inputs": []},
            {"op": "null", "name": "c_bias", "inputs": []},
            {"op": "Convolution", "name": "c",
             "attrs": {"kernel": "[3, 3]", "num_filter": "4",
                       "pad": "[1, 1]", "no_bias": "false"},
             "inputs": [[0, 0, 0], [1, 0, 0], [2, 0, 0]]},
        ],
        "arg_nodes": [0, 1, 2], "heads": [[3, 0, 0]],
    })
    s = tmx.sym.load_json(legacy)
    assert "c_bias" in s.list_arguments()
    assert s.infer_shape_partial()[1] == [(2, 4, 8, 8)]
    alien = json.dumps({
        "nodes": [{"op": "null", "name": "d", "inputs": []},
                  {"op": "SomeFutureOp", "name": "f", "attrs": {},
                   "inputs": [[0, 0, 0]]}],
        "arg_nodes": [0], "heads": [[1, 0, 0]]})
    s2 = tmx.sym.load_json(alien)
    assert s2.list_arguments() == ["d"]
    with pytest.raises(MXNetError, match="not ported"):
        s2.bind(CPU_T, {"d": tmx.nd.ones((2,), ctx=CPU_T)})


# ---------------------------------------------------------------------------
# the executor against the JAX GraphExecutor
# ---------------------------------------------------------------------------

def _mlp_case(seed=1, n=4):
    rs = np.random.RandomState(seed)
    x = rs.randn(n, 6).astype("f4")
    y = rs.randint(0, 4, n).astype("f4")
    args, _ = _params(mlp(tmx.sym), {"data": (n, 6)}, seed + 10)
    return {"data": x, "softmax_label": y}, args


@pytest.mark.parametrize("grad_req", ["write", "add"])
def test_executor_mlp_forward_backward_match(grad_req):
    inputs, args = _mlp_case()
    ej, et = _bind_both(mlp, inputs, args, {}, grad_req=grad_req)
    _close(et.forward()[0], ej.forward()[0])
    for _ in range(2):
        oj = ej.forward(is_train=True)[0]
        ot = et.forward(is_train=True)[0]
        _close(ot, oj)
        ej.backward()
        et.backward()
    for n in ej.arg_names:
        _close(et.grad_dict[n], ej.grad_dict[n], rtol=1e-5, atol=1e-6)


def test_executor_explicit_out_grads_and_grad_req():
    def prod(s):
        return s.var("a") * s.var("b") + s.var("a")
    vals = {"a": np.array([1.0, 2.0], "f4"), "b": np.array([3.0, 4.0], "f4")}
    ej, et = _bind_both(prod, vals, {}, {})
    for ex, mx_ in ((ej, jmx), (et, tmx)):
        ex.forward(is_train=True)
        ex.backward(out_grads=mx_.nd.array([10.0, -2.0], ctx=ex._ctx))
    for n in ("a", "b"):
        _close(et.grad_dict[n], ej.grad_dict[n])
    _close(et.grad_dict["a"], np.array([40.0, -10.0], "f4"))
    # grad_req add accumulates over two steps; null leaves no buffer
    ej, et = _bind_both(prod, vals, {}, {},
                        grad_req={"a": "add", "b": "null"})
    for ex in (ej, et):
        for _ in range(2):
            ex.forward(is_train=True)
            ex.backward()
    _close(et.grad_dict["a"], ej.grad_dict["a"])
    assert et.grad_dict["b"] is None and ej.grad_dict["b"] is None
    with pytest.raises(MXNetError, match="prior"):
        tmx.sym.var("a").bind(CPU_T, {"a": tmx.nd.ones((1,), ctx=CPU_T)}) \
            .backward()


def test_batchnorm_aux_update_matches():
    def bn(s):
        return s.BatchNorm(s.var("data"), name="bn0")
    x = np.random.RandomState(2).randn(6, 3, 4, 4).astype("f4") + 2.0
    args = {"bn0_gamma": np.ones(3, "f4"), "bn0_beta": np.zeros(3, "f4")}
    aux = {"bn0_moving_mean": np.zeros(3, "f4"),
           "bn0_moving_var": np.ones(3, "f4")}
    ej, et = _bind_both(bn, {"data": x}, args, aux)
    assert et.aux_names == ["bn0_moving_mean", "bn0_moving_var"]
    for ex in (ej, et):
        ex.forward(is_train=True)
        ex.backward()
    for n in et.aux_names:
        _close(et.aux_dict[n], ej.aux_dict[n])
    _close(et.aux_dict["bn0_moving_mean"], 0.1 * x.mean(axis=(0, 2, 3)),
           rtol=1e-5, atol=1e-6)
    _close(et.grad_dict["bn0_gamma"], ej.grad_dict["bn0_gamma"],
           rtol=1e-4, atol=1e-5)


def test_executor_resnet_forward_fp32_and_train_step_float64():
    shapes = {"data": (2, 3, 8, 8)}
    s = resnet_v1(tmx.sym)
    rs = np.random.RandomState(4)
    inputs = {"data": rs.randn(2, 3, 8, 8),
              "softmax_label": rs.randint(0, 10, 2).astype("f8")}
    args, aux = _params(s, shapes, 7, dtype=np.float64)
    # inference forward in fp32
    f32 = lambda d: {k: v.astype("f4") for k, v in d.items()}  # noqa: E731
    ej, et = _bind_both(resnet_v1, f32(inputs), f32(args), f32(aux))
    _close(et.forward()[0], ej.forward()[0], rtol=1e-5, atol=1e-6)
    # the training step in float64: outputs, every gradient, aux states
    with jax.enable_x64(True):
        ej, et = _bind_both(resnet_v1, inputs, args, aux, dtype="float64")
        for _ in range(2):
            oj, ot = ej.forward(is_train=True)[0], et.forward(
                is_train=True)[0]
            ej.backward()
            et.backward()
            _close(ot, oj, rtol=1e-9, atol=1e-12)
            for n in ej.arg_names:
                _close(et.grad_dict[n], ej.grad_dict[n], rtol=1e-9,
                       atol=1e-12)
            for n in ej.aux_names:
                _close(et.aux_dict[n], ej.aux_dict[n], rtol=1e-9,
                       atol=1e-12)


def test_captured_step_signature_sees_swapped_storage():
    """A rebound argument tensor builds a new step instead of reusing
    the old one (on the card: replaying onto stale addresses)."""
    inputs, args = _mlp_case()
    ex = _bind_both(mlp, inputs, args, {})[1]
    before = tmx.sym.executor_stats()["count"]
    ex.forward(is_train=True)
    ex.forward(is_train=True)
    assert tmx.sym.executor_stats()["count"] == before + 1
    ex.forward(is_train=True, data=inputs["data"] * 2)  # copied in place
    assert tmx.sym.executor_stats()["count"] == before + 1
    w = ex.arg_dict["fc1_weight"]
    w._data = w._data.clone()  # swapped, not copied into
    ex.forward(is_train=True)
    assert tmx.sym.executor_stats()["count"] == before + 2
    with tmx._graphs.no_capture():
        ex.forward()
    assert tmx.sym.executor_stats()["count"] == before + 2


def test_dropout_through_the_executor():
    def drop(s):
        return s.Dropout(s.var("data"), p=0.5, name="drop0")
    ex = drop(tmx.sym).bind(CPU_T, {"data": tmx.nd.ones((1000,),
                                                        ctx=CPU_T)})
    np.testing.assert_array_equal(ex.forward()[0].asnumpy(), 1.0)
    tmx.random.seed(3)
    out = ex.forward(is_train=True)[0].asnumpy()
    assert 0.3 < (out > 0).mean() < 0.7 and set(np.unique(out)) <= {0, 2}
    # backward with cotangents recomputes the same mask
    ex.backward(out_grads=tmx.nd.ones((1000,), ctx=CPU_T))
    np.testing.assert_array_equal(ex.grad_dict["data"].asnumpy(), out)


# ---------------------------------------------------------------------------
# the loss heads
# ---------------------------------------------------------------------------

HEADS = {
    "softmax_null": lambda s: s.SoftmaxOutput(s.var("x"), s.var("y")),
    "softmax_batch": lambda s: s.SoftmaxOutput(
        s.var("x"), s.var("y"), normalization="batch", grad_scale=2.0),
    "softmax_valid_ignore": lambda s: s.SoftmaxOutput(
        s.var("x"), s.var("y"), normalization="valid", use_ignore=True,
        ignore_label=1),
    "linear": lambda s: s.LinearRegressionOutput(s.var("x"), s.var("y"),
                                                 grad_scale=3.0),
    "mae": lambda s: s.MAERegressionOutput(s.var("x"), s.var("y")),
    "logistic": lambda s: s.LogisticRegressionOutput(s.var("x"),
                                                     s.var("y")),
    "makeloss": lambda s: s.MakeLoss(s.var("x") * s.var("x")),
    "blockgrad": lambda s: s.BlockGrad(s.var("x")) * s.var("x"),
}


@pytest.mark.parametrize("name", sorted(HEADS))
def test_loss_head_gradients_match(name):
    rs = np.random.RandomState(9)
    x = rs.randn(5, 4).astype("f4")
    y = rs.randint(0, 4, 5).astype("f4") if name.startswith("softmax") \
        else rs.rand(5, 4).astype("f4")
    feed = {"x": x, "y": y}
    make = HEADS[name]
    used = set(make(tmx.sym).list_arguments())
    ej, et = _bind_both(make, {k: v for k, v in feed.items() if k in used},
                        {}, {})
    _close(et.forward(is_train=True)[0], ej.forward(is_train=True)[0])
    ej.backward()
    et.backward()
    for n in et.arg_names:
        _close(et.grad_dict[n], ej.grad_dict[n])
    # the port's nd frontend of the same op forwards the same values
    if name == "softmax_null":
        _close(tmx.nd.SoftmaxOutput(tmx.nd.array(x, ctx=CPU_T),
                                    tmx.nd.array(y, ctx=CPU_T)),
               jmx.nd.SoftmaxOutput(jmx.nd.array(x), jmx.nd.array(y)))


# ---------------------------------------------------------------------------
# the two kernel ops registered by the port (nd, F, sym)
# ---------------------------------------------------------------------------

def _unit_inputs(seed, n=2, hw=6, ci=8, co=12, k=3):
    rs = np.random.RandomState(seed)
    return (rs.randn(n, hw, hw, ci).astype("f4"),
            (rs.randn(co, ci, k, k) / np.sqrt(ci * k * k)).astype("f4"),
            (rs.rand(ci) + 0.5).astype("f4"),
            (rs.randn(ci) * 0.5).astype("f4"),
            (rs.randn(co) * 0.1).astype("f4"))


UNIT_KW = dict(kernel=(3, 3), stride=(1, 1), pad=(1, 1), act_in=True)


def _hold_unit(got, ref):
    y, s1, s2 = (np.asarray(v.asnumpy() if hasattr(v, "asnumpy") else v)
                 for v in got)
    yr, s1r, s2r = (np.asarray(v.asnumpy() if hasattr(v, "asnumpy") else v)
                    for v in ref)
    np.testing.assert_allclose(y, yr, rtol=1e-5, atol=1e-5)
    mag = np.abs(yr).sum(axis=(0, 1, 2))
    assert np.all(np.abs(s1 - s1r) <= 1e-4 * mag + 1e-6)
    assert np.all(np.abs(s2 - s2r) <= 1e-4 * np.abs(s2r) + 1e-6)


def test_nd_fused_conv_unit_matches_the_jax_op():
    ins = _unit_inputs(0)
    got = tmx.nd.FusedConvUnit(*[tmx.nd.array(a, ctx=CPU_T) for a in ins],
                               **UNIT_KW)
    ref = jmx.nd.FusedConvUnit(*[jmx.nd.array(a) for a in ins], **UNIT_KW)
    assert len(got) == 3
    _hold_unit(got, ref)
    assert tmx.ops.FusedConvUnit is tmx.ops.fused_conv_unit


def test_sym_fused_conv_unit_forward_and_train_step():
    """Forward and the ones-cotangent train step of a graph of one
    ``FusedConvUnit`` node against the JAX op's outputs and
    ``jax.vjp``.  The port's node declares the op's three outputs; the
    JAX package registers it with one, so its symbol exposes y only."""
    names = ["data", "weight", "in_scale", "in_bias", "shift"]
    ins = _unit_inputs(1)

    def make(s):
        return s.FusedConvUnit(*[s.var(n) for n in names], name="unit",
                               **UNIT_KW)
    s = make(tmx.sym)
    assert s.list_outputs() == ["unit_output0", "unit_output1",
                                "unit_output2"]
    assert s.infer_shape(data=(2, 6, 6, 8), weight=(12, 8, 3, 3),
                         in_scale=(8,), in_bias=(8,), shift=(12,))[1] == \
        [(2, 6, 6, 12), (12,), (12,)]
    ex = s.bind(CPU_T, {n: tmx.nd.array(a, ctx=CPU_T)
                        for n, a in zip(names, ins)},
                grad_req={"data": "write", "weight": "write",
                          "in_scale": "write", "in_bias": "write"})
    outs = ex.forward(is_train=True)
    ex.backward()
    jsym = make(jmx.sym).bind(CPU_J, {n: jmx.nd.array(a)
                                      for n, a in zip(names, ins)})
    y_sym = jsym.forward()[0]
    ref = jmx.nd.FusedConvUnit(*[jmx.nd.array(a) for a in ins], **UNIT_KW)
    _hold_unit(outs, ref)
    _close(outs[0], y_sym, rtol=1e-5, atol=1e-5)
    from mxnet_tpu.ops.pallas_convbn import fused_conv_unit as jfcu

    prim, vjp = jax.vjp(lambda *a: jfcu(*a, **UNIT_KW),
                        *[jnp.asarray(a) for a in ins])
    grads = vjp(tuple(jnp.ones_like(p) for p in prim))
    for n, g in zip(names[:4], grads[:4]):
        got = ex.grad_dict[n].asnumpy()
        scale = np.abs(np.asarray(g)).max()
        np.testing.assert_allclose(got, np.asarray(g), rtol=1e-4,
                                   atol=1e-5 * scale)
    assert ex.grad_dict["shift"] is None


ATT_CASES = {
    "packed_mask": dict(shape=(2, 5, 8), heads=2, mask=True, causal=False),
    "packed_causal": dict(shape=(2, 5, 8), heads=2, mask=False, causal=True),
    "split_mask": dict(shape=(2, 2, 5, 4), heads=1, mask=True,
                       causal=False),
}


def _att_inputs(case, seed=3):
    rs = np.random.RandomState(seed)
    q, k, v = (rs.randn(*case["shape"]).astype("f4") for _ in range(3))
    m = np.ones((case["shape"][0], case["shape"][-2]), "f4")
    m[0, 3:] = 0
    return q, k, v, (m if case["mask"] else None)


@pytest.mark.parametrize("name", sorted(ATT_CASES))
def test_nd_dot_product_attention_matches_the_jax_op(name):
    case = ATT_CASES[name]
    q, k, v, m = _att_inputs(case)
    kw = dict(num_heads=case["heads"], causal=case["causal"])
    outs = []
    for mx_, ctx in ((jmx, CPU_J), (tmx, CPU_T)):
        arrs = [mx_.nd.array(a, ctx=ctx) for a in (q, k, v)]
        if m is not None:
            kw["valid_mask"] = mx_.nd.array(m, ctx=ctx)
        outs.append(mx_.nd.dot_product_attention(*arrs, **kw))
        # the aliases of the registration
        alias = mx_.nd.FusedAttention(*arrs, **kw)
        _close(alias, outs[-1], rtol=0, atol=0)
    _close(outs[1], outs[0], rtol=1e-5, atol=1e-6)
    assert tmx.ops.FusedAttention is tmx.ops._contrib_dot_product_attention


def test_sym_dot_product_attention_forward_and_dropout():
    """Through the symbol: the forward equals the JAX symbol's, and at
    dropout > 0 the node still draws no mask in training, as in the JAX
    package (the op is not in KEYED_OPS, so it gets no key and no train
    flag)."""
    case = ATT_CASES["packed_mask"]
    q, k, v, m = _att_inputs(case)
    feed = {"q": q, "k": k, "v": v, "m": m}

    def make(s, p=0.0):
        return s.dot_product_attention(s.var("q"), s.var("k"), s.var("v"),
                                       valid_mask=s.var("m"), num_heads=2,
                                       dropout=p)
    j, t = _eval_both(make, feed)
    _close(t[0], j[0], rtol=1e-5, atol=1e-6)
    s = make(tmx.sym, 0.5)
    assert s.infer_shape(q=(2, 5, 8), k=(2, 5, 8), v=(2, 5, 8),
                         m=(2, 5))[1] == [(2, 5, 8)]
    ex = s.bind(CPU_T, {n: tmx.nd.array(a, ctx=CPU_T)
                        for n, a in feed.items()}, grad_req="null")
    _close(ex.forward(is_train=True)[0], j[0], rtol=1e-5, atol=1e-6)
    jex = make(jmx.sym, 0.5).bind(CPU_J, {n: jmx.nd.array(a)
                                          for n, a in feed.items()},
                                  grad_req="null")
    _close(ex.outputs[0], jex.forward(is_train=True)[0], rtol=1e-5,
           atol=1e-6)
    # nd with _train and a generator drops, as the JAX op with a key
    g = torch.Generator().manual_seed(0)
    arrs = [tmx.nd.array(a, ctx=CPU_T) for a in (q, k, v)]
    dropped = tmx.nd.dot_product_attention(*arrs, num_heads=2, dropout=0.5,
                                           _train=True, rng_key=g)
    assert not np.allclose(dropped.asnumpy(), t[0])
