"""The port's user-defined operators (``mxnet_tpu_torch/operator.py``, the
``Custom`` op of ``ops/custom.py``) against the JAX package's on the CPU.

The same ops are registered in both packages.  The JAX package hands user
code host numpy views; the port hands NDArrays on the op's device, so
each op is written in the port in both user styles: ``nd`` ops on the
arrays, and ``.asnumpy()`` with numpy then ``assign`` of a numpy array.
Forward values and gradients are held within rtol 1e-6 and atol 1e-7
(float32 elementwise arithmetic in both); the Module and trainer runs,
whose steps sum over a batch, within rtol 1e-5 and atol 1e-6.  Also:
several outputs, unknown types and bad registrations, ``sym.Custom``'s
shape and type inference from the prop (the user's code never runs on
``meta`` tensors), two forwards in flight each reaching its own
instance, and the eager-entry rule of ``_graphs``: a hybridized block, a
bound symbol and an ``SPMDTrainer`` step that run a ``Custom`` op run the
user's forward on every call, counted in ``custom_eager``.
"""
import numpy as np
import pytest
import torch

import mxnet_tpu as mx

import mxnet_tpu_torch as mt
from mxnet_tpu_torch import gluon as tgluon
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.gluon import load_numpy_params

import torch_parity as tp

CPU = mt.cpu()
RTOL, ATOL = 1e-6, 1e-7
STEP_RTOL, STEP_ATOL = 1e-5, 1e-6


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread while this file runs (the other workers hold
    the cores), restored after it."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# ---------------------------------------------------------------------------
# the ops, in both packages
# ---------------------------------------------------------------------------

def _sigmoid_host(op_base):
    class Sigmoid(op_base):
        calls = 0

        def forward(self, is_train, req, in_data, out_data, aux):
            type(self).calls += 1
            x = in_data[0].asnumpy()
            self.assign(out_data[0], req[0], 1.0 / (1.0 + np.exp(-x)))

        def backward(self, req, out_grad, in_data, out_data, in_grad, aux):
            y = out_data[0].asnumpy()
            self.assign(in_grad[0], req[0],
                        out_grad[0].asnumpy() * y * (1 - y))
    return Sigmoid


class _SigmoidNd(mt.operator.CustomOp):
    """The port's second style: ``nd`` ops on the op's device."""
    calls = 0

    def forward(self, is_train, req, in_data, out_data, aux):
        type(self).calls += 1
        self.assign(out_data[0], req[0],
                    1.0 / (1.0 + mt.nd.exp(-in_data[0])))

    def backward(self, req, out_grad, in_data, out_data, in_grad, aux):
        y = out_data[0]
        self.assign(in_grad[0], req[0], out_grad[0] * y * (1 - y))


def _two_out(op_base):
    class TwoOut(op_base):
        def forward(self, is_train, req, in_data, out_data, aux):
            x = in_data[0].asnumpy()
            self.assign(out_data[0], req[0], x * 2)
            self.assign(out_data[1], req[1], x + 1)

        def backward(self, req, out_grad, in_data, out_data, in_grad, aux):
            self.assign(in_grad[0], req[0], out_grad[0].asnumpy() * 2
                        + out_grad[1].asnumpy())
    return TwoOut


def _masked(op_base):
    """Stateful: the forward's mask, kept on ``self``, scales the
    backward."""
    class Masked(op_base):
        def forward(self, is_train, req, in_data, out_data, aux):
            x = in_data[0].asnumpy()
            self.mask = (x > 0).astype(np.float32)
            self.assign(out_data[0], req[0], x * self.mask)

        def backward(self, req, out_grad, in_data, out_data, in_grad, aux):
            self.assign(in_grad[0], req[0],
                        out_grad[0].asnumpy() * self.mask * 3.0)
    return Masked


def _softmax_host(op_base):
    class Softmax(op_base):
        def forward(self, is_train, req, in_data, out_data, aux):
            x = in_data[0].asnumpy()
            e = np.exp(x - x.max(axis=1, keepdims=True))
            self.assign(out_data[0], req[0], e / e.sum(axis=1, keepdims=True))

        def backward(self, req, out_grad, in_data, out_data, in_grad, aux):
            y = out_data[0].asnumpy().copy()
            lab = in_data[1].asnumpy().astype(np.int64)
            y[np.arange(lab.shape[0]), lab] -= 1.0
            self.assign(in_grad[0], req[0], y)
    return Softmax


class _SoftmaxNd(mt.operator.CustomOp):
    """Reference MXNet's example/numpy-ops/custom_softmax.py with ``nd``
    ops on the op's device."""

    def forward(self, is_train, req, in_data, out_data, aux):
        x = in_data[0]
        e = mt.nd.exp(x - x.max(axis=1, keepdims=True))
        self.assign(out_data[0], req[0], e / e.sum(axis=1, keepdims=True))

    def backward(self, req, out_grad, in_data, out_data, in_grad, aux):
        y = out_data[0]
        self.assign(in_grad[0], req[0],
                    y - mt.nd.one_hot(in_data[1], depth=y.shape[1]))


def _props(pkg, op_of, need_top_grad=True, arguments=("data",),
           outputs=("output",), infer=None):
    class Prop(pkg.operator.CustomOpProp):
        def __init__(self):
            super().__init__(need_top_grad=need_top_grad)

        def list_arguments(self):
            return list(arguments)

        def list_outputs(self):
            return list(outputs)

        def infer_shape(self, in_shape):
            if infer is not None:
                return infer(in_shape)
            return in_shape, [in_shape[0]] * len(outputs), []

        def create_operator(self, ctx, shapes, dtypes):
            return op_of()
    return Prop


def _softmax_shapes(in_shape):
    return [in_shape[0], (in_shape[0][0],)], [in_shape[0]], []


J_SIG = _sigmoid_host(mx.operator.CustomOp)
T_SIG = _sigmoid_host(mt.operator.CustomOp)
J_TWO, T_TWO = _two_out(mx.operator.CustomOp), _two_out(mt.operator.CustomOp)
J_MASK, T_MASK = _masked(mx.operator.CustomOp), _masked(mt.operator.CustomOp)
J_SOFT = _softmax_host(mx.operator.CustomOp)
T_SOFT = _softmax_host(mt.operator.CustomOp)
for _pkg, _sig, _two, _mask, _soft in (
        (mx, J_SIG, J_TWO, J_MASK, J_SOFT),
        (mt, T_SIG, T_TWO, T_MASK, T_SOFT)):
    _pkg.operator.register("tp_sigmoid")(_props(_pkg, _sig))
    _pkg.operator.register("tp_two")(_props(_pkg, _two,
                                            outputs=("a", "b")))
    _pkg.operator.register("tp_mask")(_props(_pkg, _mask))
    _pkg.operator.register("tp_softmax")(_props(
        _pkg, _soft, need_top_grad=False, arguments=("data", "label"),
        infer=_softmax_shapes))
mt.operator.register("tp_sigmoid_nd")(_props(mt, _SigmoidNd))
mt.operator.register("tp_softmax_nd")(_props(
    mt, _SoftmaxNd, need_top_grad=False, arguments=("data", "label"),
    infer=_softmax_shapes))


def _x(shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _close(got, want, rtol=RTOL, atol=ATOL, what=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol,
                               atol=atol, err_msg=what)


# ---------------------------------------------------------------------------
# eager
# ---------------------------------------------------------------------------

def _jax_eager(op_type, x, ct):
    xn = mx.nd.array(x)
    xn.attach_grad()
    with mx.autograd.record():
        y = mx.nd.Custom(xn, op_type=op_type)
    outs = y if isinstance(y, list) else [y]
    mx.autograd.backward(outs, [mx.nd.array(c) for c in ct])
    return [o.asnumpy() for o in outs], xn.grad.asnumpy()


def _port_eager(op_type, x, ct):
    xn = mt.nd.array(x, ctx=CPU)
    xn.attach_grad()
    with mt.autograd.record():
        y = mt.nd.Custom(xn, op_type=op_type)
    outs = y if isinstance(y, list) else [y]
    mt.autograd.backward(outs, [mt.nd.array(c, ctx=CPU) for c in ct])
    return [o.asnumpy() for o in outs], xn.grad.asnumpy()


@pytest.mark.parametrize("port_type", ["tp_sigmoid", "tp_sigmoid_nd"])
def test_eager_forward_and_backward_in_both_styles(port_type):
    x, ct = _x((4, 5)), _x((4, 5), 1)
    (jy,), jg = _jax_eager("tp_sigmoid", x, [ct])
    (ty,), tg = _port_eager(port_type, x, [ct])
    _close(ty, jy, what="forward")
    _close(tg, jg, what="gradient")


def test_several_outputs():
    x, cts = _x((3, 4)), [_x((3, 4), 1), _x((3, 4), 2)]
    jy, jg = _jax_eager("tp_two", x, cts)
    ty, tg = _port_eager("tp_two", x, cts)
    assert len(ty) == 2
    for a, b in zip(ty, jy):
        _close(a, b)
    _close(tg, jg)
    sym = mt.sym.Custom(mt.sym.var("data"), op_type="tp_two", name="two")
    assert sym.list_outputs() == ["two_output0", "two_output1"]


def test_outside_record_runs_the_forward_only():
    x = _x((2, 3))
    ty = mt.nd.Custom(mt.nd.array(x, ctx=CPU), op_type="tp_sigmoid")
    jy = mx.nd.Custom(mx.nd.array(x), op_type="tp_sigmoid")
    _close(ty.asnumpy(), jy.asnumpy())
    assert not ty._data.requires_grad


def test_nd_custom_takes_its_inputs_by_keyword():
    x = mt.nd.array(_x((3, 4)), ctx=CPU)
    lab = mt.nd.array(np.array([0, 3, 1], np.float32), ctx=CPU)
    by_pos = mt.nd.Custom(x, lab, op_type="tp_softmax")
    by_kw = mt.nd.Custom(label=lab, data=x, op_type="tp_softmax")
    np.testing.assert_array_equal(by_kw.asnumpy(), by_pos.asnumpy())
    with pytest.raises(MXNetError, match="no argument"):
        mt.nd.Custom(x, nope=lab, op_type="tp_softmax")


def test_unknown_types_and_bad_registrations_raise_as_in_jax():
    x = mt.nd.array(_x((2,)), ctx=CPU)
    for pkg, arr in ((mt, x), (mx, mx.nd.array(_x((2,))))):
        with pytest.raises(pkg.base.MXNetError,
                           match="unknown custom op_type 'tp_nope'"):
            pkg.nd.Custom(arr, op_type="tp_nope")
        with pytest.raises(pkg.base.MXNetError,
                           match="expects a CustomOpProp subclass"):
            pkg.operator.register("tp_bad")(object)
    with pytest.raises(MXNetError, match="unknown custom op_type"):
        mt.sym.Custom(mt.sym.var("d"), op_type="tp_nope")
    with pytest.raises(MXNetError, match="requires op_type"):
        mt.nd.Custom(x)


def test_the_prop_defaults_match_the_jax_ones():
    tprop, jprop = mt.operator.CustomOpProp(), mx.operator.CustomOpProp()
    for p in (tprop, jprop):
        assert p.need_top_grad_ is True
        assert p.list_arguments() == ["data"]
        assert p.list_outputs() == ["output"]
        assert p.list_auxiliary_states() == []
    assert tprop.infer_shape([[2, 3]]) == jprop.infer_shape([[2, 3]])
    assert tprop.infer_type([np.float32]) == jprop.infer_type([np.float32])
    assert tprop.declare_backward_dependency([1], [2], [3]) == [1, 2, 3]


def test_assign_honours_write_add_and_null():
    dst = mt.nd.array(np.ones(3, np.float32), ctx=CPU)
    src = np.full(3, 2.0, np.float32)
    mt.operator.CustomOp.assign(dst, "null", src)
    assert dst.asnumpy().tolist() == [1, 1, 1]
    mt.operator.CustomOp.assign(dst, "add", mt.nd.array(src, ctx=CPU))
    assert dst.asnumpy().tolist() == [3, 3, 3]
    mt.operator.CustomOp.assign(dst, "write", src)
    assert dst.asnumpy().tolist() == [2, 2, 2]


def test_two_forwards_in_flight_reach_their_own_instances():
    xs = [_x((3, 4), 5), _x((3, 4), 6)]
    got = []
    ts = [mt.nd.array(x, ctx=CPU) for x in xs]
    for t in ts:
        t.attach_grad()
    with mt.autograd.record():
        ys = [mt.nd.Custom(t, op_type="tp_mask") for t in ts]
    for y, t in reversed(list(zip(ys, ts))):  # backward in reverse order
        y.backward()
        got.append(t.grad.asnumpy())
    for x, g in zip(reversed(xs), got):
        np.testing.assert_array_equal(g, (x > 0) * 3.0)
    jts = [mx.nd.array(x) for x in xs]
    for t in jts:
        t.attach_grad()
    with mx.autograd.record():
        jys = [mx.nd.Custom(t, op_type="tp_mask") for t in jts]
    for y in reversed(jys):
        y.backward()
    for t, j in zip(ts, jts):
        np.testing.assert_array_equal(t.grad.asnumpy(), j.grad.asnumpy())


def test_custom_through_both_registries():
    x = _x((3, 5))
    (j,), _ = tp.jax_run("Custom", [x], {"op_type": "tp_sigmoid"})
    (t,), _ = tp.port_run("Custom", [x], {"op_type": "tp_sigmoid"})
    _close(t, j)


# ---------------------------------------------------------------------------
# symbols and the executor
# ---------------------------------------------------------------------------

def test_sym_custom_shapes_and_types_come_from_the_prop():
    data = mt.sym.var("data")
    fc = mt.sym.FullyConnected(data, num_hidden=7, name="fc")
    head = mt.sym.Custom(fc, op_type="tp_softmax", name="softmax")
    # the label argument is made as <name>_label, its shape inferred
    assert head.list_arguments() == ["data", "fc_weight", "fc_bias",
                                     "softmax_label"]
    args, outs, aux = head.infer_shape(data=(4, 3))
    assert args == [(4, 3), (7, 3), (7,), (4,)]
    assert outs == [(4, 7)] and aux == []
    jdata = mx.sym.var("data")
    jfc = mx.sym.FullyConnected(jdata, num_hidden=7, name="fc")
    jhead = mx.sym.Custom(jfc, mx.sym.var("softmax_label"),
                          op_type="tp_softmax", name="softmax")
    jargs, jouts, _ = jhead.infer_shape(data=(4, 3), softmax_label=(4,))
    assert [tuple(s) for s in jargs] == args
    assert [tuple(s) for s in jouts] == outs
    assert head.infer_type()[1] == [np.float32]
    by_kw = mt.sym.Custom(data=fc, label=mt.sym.var("lab"),
                          op_type="tp_softmax", name="s2")
    assert by_kw.list_arguments()[-1] == "lab"
    with pytest.raises(MXNetError, match="no argument"):
        mt.sym.Custom(data=fc, nope=mt.sym.var("x"), op_type="tp_softmax")
    # the JSON round trip keeps the node and its output count
    two = mt.sym.Custom(data, op_type="tp_two", name="two")
    assert len(mt.sym.load_json(two.tojson()).list_outputs()) == 2


def test_bound_symbol_runs_the_user_forward_every_call():
    from mxnet_tpu_torch.symbol import executor_stats

    x = _x((3, 4))
    s = mt.sym.Custom(mt.sym.var("data"), op_type="tp_sigmoid", name="c")
    ex = s.bind(CPU, {"data": mt.nd.array(x, ctx=CPU)})
    before, calls = executor_stats(), T_SIG.calls
    for _ in range(3):
        out = ex.forward(is_train=True)[0].asnumpy()
        ex.backward()
    after = executor_stats()
    assert T_SIG.calls - calls == 3
    assert after["custom_eager"] - before["custom_eager"] == 3
    jex = mx.sym.Custom(mx.sym.var("data"), op_type="tp_sigmoid",
                        name="c").bind(mx.cpu(), {"data": mx.nd.array(x)})
    jout = jex.forward(is_train=True)[0].asnumpy()
    jex.backward()
    _close(out, jout)
    _close(ex.grad_arrays[0].asnumpy(), jex.grad_arrays[0].asnumpy())


def test_a_graph_without_custom_is_not_counted():
    from mxnet_tpu_torch.symbol import executor_stats

    s = mt.sym.FullyConnected(mt.sym.var("data"), num_hidden=3, name="f")
    ex = s.simple_bind(CPU, data=(2, 4))
    before = executor_stats()["custom_eager"]
    ex.forward(is_train=True)
    ex.forward()
    assert executor_stats()["custom_eager"] == before


def _fit(pkg, ctx, head_type, x, y, epochs=2):
    data = pkg.sym.var("data")
    fc1 = pkg.sym.FullyConnected(data, num_hidden=8, name="fc1")
    act = pkg.sym.Activation(fc1, act_type="relu", name="relu1")
    fc2 = pkg.sym.FullyConnected(act, num_hidden=4, name="fc2")
    if head_type is None:
        net = pkg.sym.SoftmaxOutput(fc2, name="softmax")
    else:
        net = pkg.sym.Custom(fc2, pkg.sym.var("softmax_label"),
                             op_type=head_type, name="softmax")
    rng = np.random.RandomState(3)
    arg = {"fc1_weight": rng.randn(8, 6) * 0.3, "fc1_bias": np.zeros(8),
           "fc2_weight": rng.randn(4, 8) * 0.3, "fc2_bias": np.zeros(4)}
    nd_kw = {} if pkg is mx else {"ctx": CPU}
    arg = {k: pkg.nd.array(v.astype(np.float32), **nd_kw)
           for k, v in arg.items()}
    it = pkg.io.NDArrayIter(x, y, batch_size=8, shuffle=False)
    mod = pkg.mod.Module(net, context=ctx)
    mod.fit(it, num_epoch=epochs, optimizer="sgd", arg_params=arg,
            optimizer_params={"learning_rate": 0.1, "momentum": 0.9},
            eval_metric="acc")
    return {k: v.asnumpy() for k, v in mod.get_params()[0].items()}


def test_module_fit_with_a_custom_softmax_head():
    rng = np.random.RandomState(4)
    x = rng.randn(32, 6).astype(np.float32)
    y = rng.randint(0, 4, 32).astype(np.float32)
    ref = _fit(mt, CPU, None, x, y)
    jref = _fit(mx, mx.cpu(), None, x, y)
    for head in ("tp_softmax", "tp_softmax_nd"):
        got = _fit(mt, CPU, head, x, y)
        for k in ref:
            _close(got[k], ref[k], STEP_RTOL, STEP_ATOL, f"{head} {k}")
    jgot = _fit(mx, mx.cpu(), "tp_softmax", x, y)
    for k in ref:
        _close(jgot[k], jref[k], STEP_RTOL, STEP_ATOL, f"jax {k}")
        _close(ref[k], jref[k], STEP_RTOL, STEP_ATOL, f"port vs jax {k}")


# ---------------------------------------------------------------------------
# gluon: a hybridized block, and SPMDTrainer's step
# ---------------------------------------------------------------------------

def _block(pkg, op_type):
    nn = pkg.gluon.nn

    class Net(pkg.gluon.HybridBlock):
        def __init__(self):
            super().__init__()
            self.fc = nn.Dense(5, in_units=4)
            self.out = nn.Dense(3, in_units=5)

        def hybrid_forward(self, F, x):
            return self.out(F.Custom(self.fc(x), op_type=op_type))
    return Net()


def _weights():
    rng = np.random.RandomState(7)
    return {"fc.weight": rng.randn(5, 4).astype(np.float32) * 0.5,
            "fc.bias": rng.randn(5).astype(np.float32) * 0.1,
            "out.weight": rng.randn(3, 5).astype(np.float32) * 0.5,
            "out.bias": rng.randn(3).astype(np.float32) * 0.1}


def _jax_block(op_type, vals):
    net = _block(mx, op_type)
    net.initialize(ctx=mx.cpu())
    net(mx.nd.array(np.zeros((1, 4), np.float32)))
    by_struct = {"fc.weight": net.fc.weight, "fc.bias": net.fc.bias,
                 "out.weight": net.out.weight, "out.bias": net.out.bias}
    for k, p in by_struct.items():
        p.set_data(mx.nd.array(vals[k]))
    return net, by_struct


@pytest.mark.parametrize("port_type", ["tp_sigmoid", "tp_sigmoid_nd"])
def test_hybridized_block_runs_the_user_code_every_call(port_type):
    vals, x = _weights(), _x((6, 4), 8)
    net = _block(mt, port_type)
    net.initialize(ctx=CPU)
    load_numpy_params(net, vals)
    net.hybridize()
    stats = tgluon.block.cached_op_stats
    s0, calls = stats(), (T_SIG if port_type == "tp_sigmoid"
                          else _SigmoidNd).calls
    for _ in range(2):
        y = net(mt.nd.array(x, ctx=CPU))
    with mt.autograd.record():
        loss = (net(mt.nd.array(x, ctx=CPU)) ** 2).sum()
    loss.backward()
    s1 = stats()
    assert (T_SIG if port_type == "tp_sigmoid"
            else _SigmoidNd).calls - calls == 3
    assert s1["custom_eager"] - s0["custom_eager"] == 3
    jnet, jp = _jax_block("tp_sigmoid", vals)
    jnet.hybridize()
    jy = jnet(mx.nd.array(x))
    with mx.autograd.record():
        jloss = (jnet(mx.nd.array(x)) ** 2).sum()
    jloss.backward()
    _close(y.asnumpy(), jy.asnumpy(), 1e-5, 1e-6)
    _close(loss.asnumpy(), jloss.asnumpy(), 1e-5, 1e-6)
    grads = dict(net.collect_params().items())
    for k, p in jp.items():
        _close(grads[k].grad().asnumpy(), p.grad().asnumpy(), 1e-5, 1e-6, k)


def test_spmd_trainer_step_runs_the_user_code_every_step():
    from mxnet_tpu_torch import parallel as tpar
    from mxnet_tpu_torch.gluon import loss as tloss
    from mxnet_tpu_torch.parallel import spmd as tspmd

    vals, x = _weights(), _x((6, 4), 9)
    y = np.array([0, 1, 2, 0, 1, 2], np.float32)
    net = _block(mt, "tp_sigmoid_nd")
    net.initialize(ctx=CPU)
    load_numpy_params(net, vals)
    net.hybridize()
    tr = tpar.SPMDTrainer(net, tloss.SoftmaxCrossEntropyLoss(), "sgd",
                          {"learning_rate": 0.1},
                          mesh=tpar.make_mesh(dp=1, devices=[CPU]))
    s0, calls = tspmd.step_compile_stats(), _SigmoidNd.calls
    losses = [float(tr.step(torch.from_numpy(x), torch.from_numpy(y)))
              for _ in range(3)]
    s1 = tspmd.step_compile_stats()
    assert _SigmoidNd.calls - calls == 3
    assert s1["custom_eager"] - s0["custom_eager"] == 3
    assert s1["count"] - s0["count"] == 1
    # the same steps by hand, through autograd and plain sgd
    ref = _block(mt, "tp_sigmoid")
    ref.initialize(ctx=CPU)
    load_numpy_params(ref, vals)
    want = []
    for _ in range(3):
        ps = dict(ref.named_parameters())
        for p in ps.values():
            p.grad = None
        out = ref(torch.from_numpy(x))
        loss = tloss.SoftmaxCrossEntropyLoss()(out, torch.from_numpy(y))
        loss.mean().backward()
        want.append(float(loss.mean().detach()))
        with torch.no_grad():
            for p in ps.values():
                p -= 0.1 * p.grad
    _close(losses, want, STEP_RTOL, STEP_ATOL)
