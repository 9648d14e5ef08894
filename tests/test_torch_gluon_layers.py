"""gluon.nn, gluon.loss and gluon.contrib of mxnet_tpu_torch against the
JAX package, on the CPU.

* Every layer of nn/basic_layers.py, nn/conv_layers.py and contrib/nn.py
  the port adds, and every loss: the same inputs (numpy, seeded) and the
  same parameters (the JAX layer's, carried across by structural name)
  through both, under ``autograd.record()``; the output, the gradient of
  a seeded weighted sum of it with respect to the input and to every
  parameter, and the running statistics.  fp32: within 1e-4 relative
  plus 1e-5 of the tensor's largest magnitude.
* Deferred shapes: Dense, BatchNorm, LayerNorm, InstanceNorm, GroupNorm
  and the convolutions without in_units/in_channels resolve at the first
  forward (eager and hybridized) to the JAX package's shapes; a
  gluon.Trainer and collect_params() made before see the real tensors;
  the error cases of test_gluon.py::test_parameter_deferred_and_error
  raise the same way.
* A custom block written as MXNet users write it (name_scope, params.get
  with a deferred shape, get_constant, hybrid_forward(F, x, weight, bias,
  scale)), its code shared by both packages, gives the same outputs and
  gradients from one .params file written by the JAX package, eager and
  hybridized; the port's own layers (which read their tensors through
  Block._value) run beside it in one net.
* hybridize(static_alloc=True, static_shape=True) is accepted, as in the
  JAX package.
* On both packages: a block's parameter attribute is a Gluon Parameter
  (the attribute-form lines of the JAX tests: data(), grad(),
  set_data(), list_ctx()); a second initialize() keeps the values
  (BatchNorm's running statistics included) unless force_reinit;
  load_parameters/save_parameters take the JAX keywords (a one-layer
  file into a two-layer net with allow_missing, extra names skipped with
  ignore_extra, each package reading the other's file); prefixes and
  names under name scopes, register_child, summary, export, Parameter.var
  and reset_ctx, Module.init_params_from_loaded.
"""
import numpy as np
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu.gluon import contrib as jcontrib
from mxnet_tpu.gluon import loss as jloss
from mxnet_tpu.gluon import nn as jnn

import mxnet_tpu_torch as mt
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.gluon import contrib as tcontrib
from mxnet_tpu_torch.gluon import load_numpy_params
from mxnet_tpu_torch.gluon import loss as tloss
from mxnet_tpu_torch.gluon import nn as tnn

CPU = mt.cpu()
PKG = {"jax": (mx, jnn, jloss, jcontrib, mx.cpu()),
       "port": (mt, tnn, tloss, tcontrib, CPU)}


def _close(t, j, what):
    t, j = np.asarray(t, np.float64), np.asarray(j, np.float64)
    assert t.shape == j.shape, (what, t.shape, j.shape)
    scale = max(1.0, float(np.abs(j).max())) if j.size else 1.0
    np.testing.assert_allclose(t, j, rtol=1e-4, atol=1e-5 * scale,
                               err_msg=what)


def _params(pkg, block):
    if pkg == "jax":
        return {k: p for k, p in block._collect_params_with_prefix().items()}
    return dict(block.collect_params().items())


def _run(pkg, block, arrays, grad_idx=(0,), seed=5):
    """Forward under record() (train mode), then backward of a seeded
    weighted sum of the output: (out, input grads, {param: (value,
    grad or None)})."""
    m = PKG[pkg][0]
    ctx = PKG[pkg][4]
    xs = [m.nd.array(a, ctx=ctx) if a is not None else None for a in arrays]
    for i in grad_idx:
        xs[i].attach_grad()
    with m.autograd.record():
        out = block(*xs)
        w = np.asarray(np.random.RandomState(seed).randn(*out.shape),
                       np.float32)
        head = (out * m.nd.array(w, ctx=ctx)).sum()
    head.backward()
    ps = {}
    for k, p in _params(pkg, block).items():
        g = p.grad().asnumpy() if p.grad_req != "null" else None
        ps[k] = (p.data().asnumpy(), g)
    return out.asnumpy(), [xs[i].grad.asnumpy() for i in grad_idx], ps


def _both(make, arrays, grad_idx=(0,), hybridize=False, resolve=True):
    """The layer built by ``make(nn, loss, contrib)`` in both packages,
    the JAX one's parameters carried into the port's, run by _run."""
    jb = make(jnn, jloss, jcontrib)
    jb.initialize(mx.initializer.Xavier(), ctx=mx.cpu())
    if resolve:  # resolve deferred shapes with one forward
        jb(*[mx.nd.array(a) if a is not None else None for a in arrays])
    tb = make(tnn, tloss, tcontrib)
    tb.initialize(ctx=CPU)
    vals = {k: p.data().asnumpy() for k, p in _params("jax", jb).items()}
    if vals:
        load_numpy_params(tb, vals)
    if hybridize:
        jb.hybridize()
        tb.hybridize()
    return _run("jax", jb, arrays, grad_idx), _run("port", tb, arrays,
                                                   grad_idx)


def _hold(j, t):
    _close(t[0], j[0], "output")
    for i, (gt, gj) in enumerate(zip(t[1], j[1])):
        _close(gt, gj, f"input grad {i}")
    assert set(t[2]) == set(j[2]), (sorted(t[2]), sorted(j[2]))
    for k in j[2]:
        _close(t[2][k][0], j[2][k][0], f"{k} value")
        assert (t[2][k][1] is None) == (j[2][k][1] is None), k
        if j[2][k][1] is not None:
            _close(t[2][k][1], j[2][k][1], f"{k} grad")


def _x(*shape, seed=0, scale=1.0, shift=0.0):
    return (np.random.RandomState(seed).randn(*shape) * scale
            + shift).astype(np.float32)


LAYERS = {
    # basic_layers
    "Sequential": (lambda nn, L, c: _seq(nn), [_x(4, 6)]),
    "HybridSequential.deferred": (
        lambda nn, L, c: _hseq(nn), [_x(4, 2, 3)]),
    "Dense.deferred.noflatten": (
        lambda nn, L, c: nn.Dense(5, flatten=False, activation="tanh"),
        [_x(3, 2, 4)]),
    "BatchNorm.deferred": (lambda nn, L, c: nn.BatchNorm(),
                           [_x(6, 3, 4, 4, shift=1.0)]),
    "BatchNorm.axis3.noscale": (
        lambda nn, L, c: nn.BatchNorm(axis=3, scale=False, center=False),
        [_x(6, 4, 4, 3)]),
    "InstanceNorm": (lambda nn, L, c: nn.InstanceNorm(),
                     [_x(2, 3, 5, 5, shift=0.5)]),
    "InstanceNorm.1d": (lambda nn, L, c: nn.InstanceNorm(epsilon=1e-3),
                        [_x(2, 4, 7)]),
    "LayerNorm.deferred": (lambda nn, L, c: nn.LayerNorm(), [_x(3, 4, 6)]),
    "LayerNorm.axis1": (lambda nn, L, c: nn.LayerNorm(axis=1),
                        [_x(3, 6, 2)]),
    "GroupNorm": (lambda nn, L, c: nn.GroupNorm(num_groups=2),
                  [_x(2, 4, 3, 3, shift=1.0)]),
    "Identity": (lambda nn, L, c: nn.Identity(), [_x(2, 3)]),
    "LeakyReLU": (lambda nn, L, c: nn.LeakyReLU(0.1), [_x(3, 5)]),
    "PReLU": (lambda nn, L, c: nn.PReLU(), [_x(3, 5)]),
    "ELU": (lambda nn, L, c: nn.ELU(alpha=0.7), [_x(3, 5)]),
    "SELU": (lambda nn, L, c: nn.SELU(), [_x(3, 5)]),
    "GELU.erf": (lambda nn, L, c: nn.GELU(), [_x(3, 5)]),
    "GELU.tanh": (lambda nn, L, c: nn.GELU(approximation="tanh"),
                  [_x(3, 5)]),
    "Swish": (lambda nn, L, c: nn.Swish(beta=1.5), [_x(3, 5)]),
    "SiLU": (lambda nn, L, c: nn.SiLU(), [_x(3, 5)]),
    "Activation.softrelu": (lambda nn, L, c: nn.Activation("softrelu"),
                            [_x(3, 5, scale=4.0)]),
    "Activation.sigmoid": (lambda nn, L, c: nn.Activation("sigmoid"),
                           [_x(3, 5)]),
    "Activation.softsign": (lambda nn, L, c: nn.Activation("softsign"),
                            [_x(3, 5)]),
    "Lambda": (lambda nn, L, c: nn.Lambda("relu"), [_x(3, 5)]),
    "HybridLambda.name": (lambda nn, L, c: nn.HybridLambda("tanh"),
                          [_x(3, 5)]),
    "HybridLambda.fn": (lambda nn, L, c: nn.HybridLambda(
        lambda F, x: F.relu(x) * 2 + x), [_x(3, 5)]),
    # conv_layers
    "Conv1D.deferred": (lambda nn, L, c: nn.Conv1D(4, 3, padding=1,
                                                   strides=2),
                        [_x(2, 3, 9)]),
    "Conv1D.NWC": (lambda nn, L, c: nn.Conv1D(4, 3, layout="NWC",
                                              in_channels=2),
                   [_x(2, 7, 2)]),
    "Conv2D.deferred.groups": (
        lambda nn, L, c: nn.Conv2D(6, (3, 3), padding=(1, 1), groups=2,
                                   activation="relu"), [_x(2, 4, 6, 6)]),
    "Conv2D.dilation": (lambda nn, L, c: nn.Conv2D(
        3, 3, dilation=2, in_channels=2), [_x(1, 2, 9, 9)]),
    "Conv3D.deferred": (lambda nn, L, c: nn.Conv3D(3, 2, strides=(1, 2, 1)),
                        [_x(2, 2, 4, 5, 4)]),
    "Conv1DTranspose": (lambda nn, L, c: nn.Conv1DTranspose(
        3, 3, strides=2, padding=1, output_padding=1, in_channels=2),
        [_x(2, 2, 5)]),
    "Conv2DTranspose.deferred": (lambda nn, L, c: nn.Conv2DTranspose(
        4, (3, 3), strides=(2, 2), padding=(1, 1), output_padding=(1, 1)),
        [_x(2, 3, 4, 4)]),
    "Conv2DTranspose.groups": (lambda nn, L, c: nn.Conv2DTranspose(
        4, 2, strides=2, groups=2, in_channels=4), [_x(1, 4, 3, 3)]),
    "Conv3DTranspose": (lambda nn, L, c: nn.Conv3DTranspose(
        2, 2, strides=2, in_channels=3), [_x(1, 3, 2, 3, 2)]),
    "MaxPool1D": (lambda nn, L, c: nn.MaxPool1D(3, 2, 1), [_x(2, 3, 9)]),
    "MaxPool2D.ceil": (lambda nn, L, c: nn.MaxPool2D(3, 2, ceil_mode=True),
                       [_x(2, 3, 8, 8)]),
    "MaxPool2D.widepad": (lambda nn, L, c: nn.MaxPool2D(2, 1, padding=1),
                          [_x(1, 2, 5, 5)]),
    "MaxPool3D": (lambda nn, L, c: nn.MaxPool3D(2), [_x(1, 2, 4, 4, 4)]),
    "AvgPool1D": (lambda nn, L, c: nn.AvgPool1D(3, 2, 1), [_x(2, 3, 9)]),
    "AvgPool2D.nopad_count": (lambda nn, L, c: nn.AvgPool2D(
        3, 2, 1, count_include_pad=False), [_x(2, 3, 7, 7)]),
    "AvgPool2D.ceil": (lambda nn, L, c: nn.AvgPool2D(3, 2, ceil_mode=True),
                       [_x(2, 3, 8, 8)]),
    "AvgPool2D.NHWC": (lambda nn, L, c: nn.AvgPool2D(2, layout="NHWC"),
                       [_x(2, 6, 6, 3)]),
    "AvgPool3D": (lambda nn, L, c: nn.AvgPool3D(2, padding=1),
                  [_x(1, 2, 4, 4, 4)]),
    "GlobalMaxPool1D": (lambda nn, L, c: nn.GlobalMaxPool1D(),
                        [_x(2, 3, 9)]),
    "GlobalMaxPool2D": (lambda nn, L, c: nn.GlobalMaxPool2D(),
                        [_x(2, 3, 5, 5)]),
    "GlobalMaxPool3D": (lambda nn, L, c: nn.GlobalMaxPool3D(),
                        [_x(1, 2, 3, 4, 3)]),
    "GlobalAvgPool1D": (lambda nn, L, c: nn.GlobalAvgPool1D(),
                        [_x(2, 3, 9)]),
    "GlobalAvgPool3D": (lambda nn, L, c: nn.GlobalAvgPool3D(),
                        [_x(1, 2, 3, 4, 3)]),
    "ReflectionPad2D": (lambda nn, L, c: nn.ReflectionPad2D(2),
                        [_x(1, 2, 5, 5)]),
    # contrib
    "contrib.HybridConcurrent": (lambda nn, L, c: _concurrent(nn, c),
                                 [_x(3, 4)]),
    "contrib.Identity": (lambda nn, L, c: c.nn.Identity(), [_x(3, 4)]),
    "contrib.SparseEmbedding": (
        lambda nn, L, c: c.nn.SparseEmbedding(10, 4),
        [np.array([[1, 3, 9], [0, 3, 2]], np.float32)]),
    "contrib.SyncBatchNorm": (lambda nn, L, c: c.nn.SyncBatchNorm(),
                              [_x(4, 3, 2, 2, shift=0.5)]),
    "contrib.PixelShuffle2D": (lambda nn, L, c: c.nn.PixelShuffle2D(2),
                               [_x(2, 8, 3, 3)]),
}


def _seq(nn):
    net = nn.Sequential()
    net.add(nn.Dense(5, activation="relu"), nn.Dense(3))
    return net


def _hseq(nn):
    net = nn.HybridSequential()
    net.add(nn.Dense(4), nn.BatchNorm(), nn.Activation("relu"), nn.Dense(2))
    return net


def _concurrent(nn, c):
    net = c.nn.HybridConcurrent(axis=1)
    net.add(nn.Dense(3, in_units=4))
    net.add(nn.Dense(2, in_units=4))
    net.add(c.nn.Identity())
    return net


NO_INPUT_GRAD = {"contrib.SparseEmbedding"}


@pytest.mark.parametrize("name", sorted(LAYERS))
def test_layer_matches_the_jax_class(name):
    make, arrays = LAYERS[name]
    grad_idx = () if name in NO_INPUT_GRAD else (0,)
    j, t = _both(make, arrays, grad_idx)
    _hold(j, t)


@pytest.mark.parametrize("name", ["HybridSequential.deferred",
                                  "Conv2D.deferred.groups",
                                  "BatchNorm.deferred", "GroupNorm",
                                  "contrib.HybridConcurrent"])
def test_hybridized_layer_matches_the_jax_class(name):
    make, arrays = LAYERS[name]
    j, t = _both(make, arrays, hybridize=True)
    _hold(j, t)


def _y(*shape, seed=1, lo=0, hi=2):
    return np.random.RandomState(seed).randint(lo, hi, shape).astype(
        np.float32)


def _pos(*shape, seed=2):
    return np.random.RandomState(seed).uniform(0.05, 0.95, shape).astype(
        np.float32)


LOSSES = {
    "L2Loss": (lambda L: L.L2Loss(), [_x(4, 3), _x(4, 3, seed=1)]),
    "L2Loss.weight": (lambda L: L.L2Loss(weight=0.5),
                      [_x(4, 3), _x(4, 3, seed=1), _pos(4, 1)]),
    "L1Loss": (lambda L: L.L1Loss(), [_x(4, 3), _x(4, 3, seed=1)]),
    "SigmoidBCE.logits": (lambda L: L.SigmoidBinaryCrossEntropyLoss(),
                          [_x(4, 3, scale=3.0), _y(4, 3)]),
    "SigmoidBCE.from_sigmoid": (
        lambda L: L.SigmoidBCELoss(from_sigmoid=True), [_pos(4, 3),
                                                        _y(4, 3)]),
    "SigmoidBCE.pos_weight": (
        lambda L: L.SigmoidBinaryCrossEntropyLoss(),
        [_x(4, 3, scale=3.0), _y(4, 3), None, _pos(4, 3, seed=5) * 3]),
    "SoftmaxCELoss.dense": (
        lambda L: L.SoftmaxCrossEntropyLoss(sparse_label=False),
        [_x(4, 5), np.eye(5, dtype=np.float32)[[0, 3, 1, 4]]]),
    "KLDivLoss": (lambda L: L.KLDivLoss(from_logits=False),
                  [_x(4, 5), _pos(4, 5) / _pos(4, 5).sum(1,
                                                         keepdims=True)]),
    "HuberLoss": (lambda L: L.HuberLoss(rho=0.7),
                  [_x(4, 3, scale=2.0), _x(4, 3, seed=1)]),
    "HingeLoss": (lambda L: L.HingeLoss(), [_x(4, 3), _y(4, 3) * 2 - 1]),
    "SquaredHingeLoss": (lambda L: L.SquaredHingeLoss(margin=0.5),
                         [_x(4, 3), _y(4, 3) * 2 - 1]),
    "LogisticLoss.signed": (lambda L: L.LogisticLoss(),
                            [_x(4, 3, scale=3.0), _y(4, 3) * 2 - 1]),
    "LogisticLoss.binary": (lambda L: L.LogisticLoss(label_format="binary"),
                            [_x(4, 3, scale=3.0), _y(4, 3)]),
    "TripletLoss": (lambda L: L.TripletLoss(margin=0.5),
                    [_x(4, 3), _x(4, 3, seed=1), _x(4, 3, seed=2)]),
    "CosineEmbeddingLoss": (lambda L: L.CosineEmbeddingLoss(margin=0.1),
                            [_x(4, 6), _x(4, 6, seed=1),
                             _y(4) * 2 - 1]),
    "PoissonNLLLoss.logits": (lambda L: L.PoissonNLLLoss(),
                              [_x(4, 3), _pos(4, 3) * 4]),
    "PoissonNLLLoss.full": (
        lambda L: L.PoissonNLLLoss(from_logits=False, compute_full=True),
        [_pos(4, 3) * 3, np.array([[0, 1, 2], [3, 4, 5], [1, 2, 6],
                                   [0, 7, 2]], np.float32)]),
}


@pytest.mark.parametrize("name", sorted(LOSSES))
def test_loss_matches_the_jax_class(name, monkeypatch):
    # the JAX package's _reshape_like calls nd.reshape_like, which its nd
    # lacks (TripletLoss, PoissonNLLLoss and the dense SoftmaxCELoss raise
    # AttributeError there); the reference runs with the helper's evident
    # meaning, x reshaped to y's shape (ROADMAP §C)
    monkeypatch.setattr(jloss, "_reshape_like",
                        lambda F, x, y: x.reshape(y.shape))
    make, arrays = LOSSES[name]
    grad_idx = (0, 1) if name.startswith(("TripletLoss", "Cosine")) \
        else (0,)
    j = _run("jax", make(jloss), arrays, grad_idx)
    t = _run("port", make(tloss), arrays, grad_idx)
    _hold(j, t)


DEFERRED = {
    "Dense": (lambda nn: nn.Dense(7), (3, 2, 5)),
    "Dense.noflatten": (lambda nn: nn.Dense(7, flatten=False), (3, 2, 5)),
    "BatchNorm": (lambda nn: nn.BatchNorm(axis=3), (2, 3, 3, 6)),
    "LayerNorm": (lambda nn: nn.LayerNorm(axis=1), (2, 5, 3)),
    "InstanceNorm": (lambda nn: nn.InstanceNorm(), (2, 4, 3)),
    "GroupNorm": (lambda nn: nn.GroupNorm(num_groups=3), (2, 6, 3)),
    "Conv2D": (lambda nn: nn.Conv2D(4, 3, groups=2), (1, 6, 5, 5)),
    "Conv2D.NHWC": (lambda nn: nn.Conv2D(4, 3, layout="NHWC"),
                    (1, 5, 5, 6)),
    "Conv2DTranspose": (lambda nn: nn.Conv2DTranspose(4, 3, groups=2),
                        (1, 6, 5, 5)),
    "Conv3D": (lambda nn: nn.Conv3D(2, 2), (1, 3, 3, 3, 3)),
}


@pytest.mark.parametrize("hybridize", [False, True])
@pytest.mark.parametrize("name", sorted(DEFERRED))
def test_deferred_shapes_resolve_to_the_jax_shapes(name, hybridize):
    make, shape = DEFERRED[name]
    x = _x(*shape)
    jb = make(jnn)
    jb.initialize(ctx=mx.cpu())
    jb(mx.nd.array(x))
    want = {k: tuple(p.shape)
            for k, p in jb._collect_params_with_prefix().items()}
    tb = make(tnn)
    tb.initialize(ctx=CPU)
    before = tb.collect_params()
    assert any(0 in p.shape for p in before.values())
    with pytest.raises(mt.gluon.DeferredInitializationError):
        next(p for p in before.values() if 0 in p.shape).data()
    if hybridize:
        tb.hybridize()
    with mt.autograd.record():
        out = tb(mt.nd.array(x, ctx=CPU))
    out.backward()
    got = {k: p.shape for k, p in before.items()}
    assert got == want
    # the handles made before the first forward see the real tensors
    for k, p in before.items():
        assert p.data().shape == want[k]


def test_trainer_made_before_the_first_forward_trains_deferred_params():
    net = tnn.HybridSequential()
    net.add(tnn.Dense(4, activation="relu"), tnn.Dense(2))
    net.initialize(mt.initializer.Xavier(), ctx=CPU)
    params = net.collect_params()
    tr = mt.gluon.Trainer(params, "sgd", {"learning_rate": 0.5})
    net.hybridize()
    x = mt.nd.array(_x(8, 3), ctx=CPU)
    with mt.autograd.record():
        loss = (net(x) ** 2).sum()
    loss.backward()
    w0 = params["0.weight"].data().asnumpy().copy()
    g = params["0.weight"].grad().asnumpy().copy()
    tr.step(8)
    assert w0.shape == (4, 3) and np.abs(g).max() > 0
    np.testing.assert_allclose(params["0.weight"].data().asnumpy(),
                               w0 - 0.5 / 8 * g, rtol=1e-6, atol=1e-7)


def test_tied_name_sees_the_resolved_parameter():
    a = tnn.Dense(3)
    b = tnn.HybridSequential()
    b.add(a)
    b.tied = a.weight  # a second structural name for the placeholder
    b.initialize(ctx=CPU)
    b(mt.nd.array(_x(2, 5), ctx=CPU))
    sd = b.state_dict(keep_vars=True)
    assert sd["tied"] is sd["0.weight"] and tuple(sd["tied"].shape) == (3, 5)


def test_parameter_deferred_and_error():
    """The port's counterpart of tests/test_gluon.py's test of the same
    name: the same calls raise the same way."""
    p = mt.gluon.Parameter("w", shape=(0, 4), allow_deferred_init=True)
    p.initialize(ctx=CPU)
    with pytest.raises(mt.gluon.parameter.DeferredInitializationError):
        p.data()
    p.shape = (2, 4)
    p._finish_deferred_init()
    assert p.data().shape == (2, 4)
    q = mt.gluon.Parameter("q", shape=(3,))
    with pytest.raises(MXNetError):
        q.data()
    # the same in the JAX package
    jp = mx.gluon.Parameter("w", shape=(0, 4), allow_deferred_init=True)
    jp.initialize(ctx=mx.cpu())
    with pytest.raises(mx.gluon.parameter.DeferredInitializationError):
        jp.data()
    # an unknown shape without allow_deferred_init raises at initialize;
    # only unknown dims may change
    r = mt.gluon.Parameter("r", shape=(0, 2))
    with pytest.raises(MXNetError, match="allow_deferred_init"):
        r.initialize(ctx=CPU)
    with pytest.raises(MXNetError, match="cannot change shape"):
        p.shape = (3, 4)
    d = tnn.Dense(3)
    d.initialize(ctx=CPU)
    with pytest.raises(MXNetError, match="cannot change shape"):
        d._set_shape("weight", (4, 5))


def _custom_block(pkg_gluon, units=3):
    """A layer as MXNet users write it; the same code in both packages."""

    class ScaledDense(pkg_gluon.HybridBlock):
        def __init__(self, units, in_units=0, **kwargs):
            super().__init__(**kwargs)
            self._units = units
            with self.name_scope():
                self.weight = self.params.get(
                    "weight", shape=(units, in_units),
                    allow_deferred_init=True)
                self.bias = self.params.get("bias", shape=(units,),
                                            init="zeros")
                self.scale = self.params.get_constant(
                    "scale", np.linspace(0.5, 1.5, units).astype(
                        np.float32))

        def _infer_param_shapes(self, x, *args):
            self.params.get("weight", shape=(self._units, x.shape[-1]))

        def hybrid_forward(self, F, x, weight, bias, scale):
            y = F.FullyConnected(x, weight, bias, num_hidden=self._units)
            return F.broadcast_mul(F.relu(y), scale)

    return ScaledDense(units)


def _custom_net(pkg_gluon, nn):
    net = nn.HybridSequential()
    net.add(_custom_block(pkg_gluon, 4), nn.Dense(2))
    return net


@pytest.mark.parametrize("hybridize", [False, True])
def test_custom_block_runs_in_both_packages_from_one_params_file(
        hybridize, tmp_path):
    x = _x(5, 6)
    jnet = _custom_net(mx.gluon, jnn)
    jnet.initialize(mx.initializer.Xavier(), ctx=mx.cpu())
    jnet(mx.nd.array(x))
    f = str(tmp_path / "custom.params")
    jnet.save_parameters(f)
    tnet = _custom_net(mt.gluon, tnn)
    tnet.initialize(ctx=CPU)
    assert tuple(tnet[0].weight.shape) == (4, 0)
    tnet.load_parameters(f)
    assert sorted(tnet.state_dict()) == sorted(
        jnet._collect_params_with_prefix())
    if hybridize:
        jnet.hybridize()
        tnet.hybridize(static_alloc=True, static_shape=True)
    j = _run("jax", jnet, [x])
    t = _run("port", tnet, [x])
    _hold(j, t)
    assert t[2]["0.scale"][1] is None  # a constant has no gradient


def test_custom_block_resolves_its_deferred_shape_in_the_port():
    blk = _custom_block(mt.gluon)
    blk.initialize(ctx=CPU)
    blk.hybridize()
    with mt.autograd.record():
        out = blk(mt.nd.array(_x(2, 7), ctx=CPU))
    out.backward()
    assert tuple(blk.weight.shape) == (3, 7)
    assert blk.collect_params()["weight"].grad().shape == (3, 7)


def test_hybridize_takes_static_alloc_and_static_shape():
    net = tnn.HybridSequential()
    net.add(tnn.Dense(3, in_units=4), tnn.BatchNorm(in_channels=3))
    net.initialize(ctx=CPU)
    net.hybridize(static_alloc=True, static_shape=True)
    assert net[1]._flags["static_alloc"] and net[1]._flags["static_shape"]
    x = mt.nd.array(_x(2, 4), ctx=CPU)
    assert net(x).shape == (2, 3)
    seq = tnn.Sequential()
    seq.add(tnn.Dense(2, in_units=3))
    seq.hybridize(static_alloc=True)
    assert seq[0]._active


def test_new_ops_are_registered_under_the_jax_names():
    from mxnet_tpu_torch.ops import registry

    for name in ("Deconvolution", "InstanceNorm", "GroupNorm", "LeakyReLU",
                 "pad", "softmin", "square", "where", "reshape_like",
                 "depth_to_space", "space_to_depth"):
        assert name in registry.list_ops(), name
        assert callable(getattr(mt.ops, name))
    x = _x(2, 3, 4, 4)
    for mode in ("constant", "edge", "reflect"):
        pw = (0, 0, 0, 0, 1, 2, 2, 1)
        t = mt.nd.pad(mt.nd.array(x, ctx=CPU), mode=mode, pad_width=pw)
        j = mx.nd.pad(mx.nd.array(x), mode=mode, pad_width=pw)
        _close(t.asnumpy(), j.asnumpy(), mode)
    t = mt.nd.softmin(mt.nd.array(x, ctx=CPU), axis=1)
    _close(t.asnumpy(), mx.nd.softmin(mx.nd.array(x), axis=1).asnumpy(),
           "softmin")
    for act in ("leaky", "elu", "selu", "gelu", "rrelu"):
        t = mt.nd.LeakyReLU(mt.nd.array(x, ctx=CPU), act_type=act)
        j = mx.nd.LeakyReLU(mx.nd.array(x), act_type=act)
        _close(t.asnumpy(), j.asnumpy(), act)


def test_params_get_registers_under_the_attribute_name():
    class Scale(mt.gluon.HybridBlock):
        def __init__(self):
            super().__init__()
            with self.name_scope():
                self.w = self.params.get("weight", shape=(3,),
                                         init="ones")
                self.c = self.params.get_constant("offset", [1., 2., 3.])

        def hybrid_forward(self, F, x, w, c):
            return x * w + c

    blk = Scale()
    assert sorted(blk.state_dict()) == ["c", "w"]
    assert blk.params.get("weight") is blk.w  # retrieved by its get name
    blk.initialize(ctx=CPU)
    out = blk(mt.nd.array(np.ones((2, 3), np.float32), ctx=CPU))
    np.testing.assert_array_equal(out.asnumpy(), [[2, 3, 4], [2, 3, 4]])


# ---------------------------------------------------------------------------
# a block's parameter attributes, initialize(force_reinit), the keywords
# of load_parameters/save_parameters, and the rest of Block's members
# ---------------------------------------------------------------------------

def _each_pkg(fn):
    """fn(pkg, mod, nn, ctx) for both packages: {pkg: result}."""
    return {pkg: fn(pkg, PKG[pkg][0], PKG[pkg][1], PKG[pkg][4])
            for pkg in ("jax", "port")}


def test_parameter_attributes_are_gluon_parameters():
    """The attribute-form lines of the JAX package's tests
    (test_gluon.py:140, 414-421, 494, 548; test_parallel.py:452-453) on
    both packages: data(), grad(), set_data(), list_ctx() and writes
    through grad()."""
    def run(pkg, m, nn, ctx):
        net = nn.Dense(1, in_units=2, use_bias=False)
        net.initialize(m.initializer.One(), ctx=ctx)
        tr = m.gluon.Trainer(net.collect_params(), "sgd",
                             {"learning_rate": 0.1})
        with m.autograd.record():
            loss = net(m.nd.ones((1, 2), ctx=ctx)).sum()
        loss.backward()
        grad = net.weight.grad().asnumpy().copy()
        tr.step(1)
        out = {"data": net.weight.data().asnumpy(), "grad": grad,
               "ctx": [str(c) for c in net.weight.list_ctx()],
               "req": net.weight.grad_req}
        net.weight.grad()[:] = 5.0  # a write through the gradient buffer
        out["written"] = net.weight.grad().asnumpy()
        net.weight.set_data(m.nd.array([[2.0, 3.0]], ctx=ctx))
        out["set"] = net.weight.data().asnumpy()
        seq = nn.HybridSequential()
        seq.add(nn.Dense(4, in_units=3), nn.BatchNorm(in_channels=4))
        seq.initialize(ctx=ctx)
        out["bn"] = (seq[1].running_mean.data().asnumpy(),
                     seq[1].running_mean.grad_req, seq[0].bias.shape)
        return out
    res = _each_pkg(run)
    j, t = res["jax"], res["port"]
    np.testing.assert_allclose(j["data"], [[0.9, 0.9]], rtol=1e-6)
    for k in ("data", "grad", "written", "set"):
        np.testing.assert_array_equal(t[k], j[k], err_msg=k)
    assert t["req"] == j["req"] == "write"
    assert len(t["ctx"]) == len(j["ctx"]) == 1
    np.testing.assert_array_equal(t["bn"][0], j["bn"][0])
    assert t["bn"][1] == j["bn"][1] == "null"
    assert tuple(t["bn"][2]) == tuple(j["bn"][2]) == (4,)
    # one handle a name, the one params.get gives; the forward still
    # reads the tensor
    net = tnn.Dense(3, in_units=2)
    assert net.weight is net.weight
    assert isinstance(net.weight, mt.gluon.Parameter)
    assert net._value("weight") is net.collect_params()["weight"]._tensor


def test_second_initialize_keeps_the_values_unless_force_reinit():
    def run(pkg, m, nn, ctx):
        net = nn.HybridSequential()
        net.add(nn.Dense(3, in_units=2), nn.BatchNorm(in_channels=3))
        net.initialize(ctx=ctx)
        net[0].weight.set_data(m.nd.ones((3, 2), ctx=ctx) * 7.0)
        net[1].running_mean.set_data(m.nd.ones((3,), ctx=ctx) * 3.0)
        net.initialize(ctx=ctx)
        kept = (net[0].weight.data().asnumpy(),
                net[1].running_mean.data().asnumpy())
        net.initialize(ctx=ctx, force_reinit=True)
        return kept + (net[0].weight.data().asnumpy(),
                       net[1].running_mean.data().asnumpy())
    res = _each_pkg(run)
    for pkg, (w, rm, w2, rm2) in res.items():
        assert (w == 7.0).all() and (rm == 3.0).all(), pkg
        assert not (w2 == 7.0).any() and (rm2 == 0.0).all(), pkg


def test_load_parameters_takes_the_jax_keywords(tmp_path):
    rs = np.random.RandomState(8)
    w = {"0.weight": rs.randn(4, 3).astype(np.float32),
         "0.bias": rs.randn(4).astype(np.float32)}

    def net_of(nn, ctx, layers):
        net = nn.HybridSequential()
        for _ in range(layers):
            net.add(nn.Dense(4, in_units=3 if not len(net) else 4))
        net.initialize(ctx=ctx)
        return net

    def run(pkg, m, nn, ctx):
        one = net_of(nn, ctx, 1)
        for k, p in _params(pkg, one).items():
            p.set_data(m.nd.array(w[k], ctx=ctx))
        f = str(tmp_path / f"{pkg}-one.params")
        one.save_parameters(f, deduplicate=True)
        two = net_of(nn, ctx, 2)
        before = two[1].weight.data().asnumpy().copy()
        with pytest.raises(Exception, match="missing"):
            two.load_parameters(f)
        other = str(tmp_path / f"{'port' if pkg == 'jax' else 'jax'}"
                    "-one.params")
        two.load_parameters(other if pkg == "port" else f, ctx=ctx,
                            allow_missing=True, cast_dtype=True,
                            dtype_source="saved")
        out = {"loaded": two[0].weight.data().asnumpy(),
               "kept": np.array_equal(two[1].weight.data().asnumpy(),
                                      before)}
        # a two-layer file into the one-layer net: the extra names
        ftwo = str(tmp_path / f"{pkg}-two.params")
        two.save_params(ftwo)
        with pytest.raises(Exception, match="not|exist"):
            one.load_parameters(ftwo)
        one.load_params(ftwo, ignore_extra=True)
        out["extra"] = one[0].bias.data().asnumpy()
        return out
    res = _each_pkg(run)
    for pkg, out in res.items():
        np.testing.assert_array_equal(out["loaded"], w["0.weight"])
        assert out["kept"], pkg
        np.testing.assert_array_equal(out["extra"], w["0.bias"])


def test_names_prefixes_and_children():
    def run(pkg, m, nn, ctx):
        seq = nn.HybridSequential(prefix="net_")
        with seq.name_scope():
            seq.add(nn.Dense(4, in_units=3), nn.Dense(2, in_units=4))
        fc = nn.Dense(3, prefix="fc_", in_units=2)
        blk = nn.HybridSequential(prefix="blk_")
        blk.register_child(nn.Dense(5, in_units=2), "head")
        names = sorted(_params(pkg, blk))
        return (seq.prefix, seq.name, [c.prefix for c in seq],
                [c.name for c in seq], fc.prefix, fc.name, names)
    res = _each_pkg(run)
    assert res["port"] == res["jax"]
    assert res["port"][2] == ["net_dense0_", "net_dense1_"]


def test_summary_counts_each_blocks_parameters(capsys):
    import re

    def run(pkg, m, nn, ctx):
        net = nn.HybridSequential(prefix="net_")
        with net.name_scope():
            net.add(nn.Dense(8, in_units=4), nn.BatchNorm(in_channels=8),
                    nn.Dense(2, in_units=8))
        net.initialize(ctx=ctx)
        net.summary(m.nd.ones((1, 4), ctx=ctx))
        return capsys.readouterr().out.splitlines()
    res = _each_pkg(run)
    # the JAX package counts its registered parameters, running
    # statistics included (they are Parameters there as here)
    assert res["port"] == res["jax"]
    assert re.match(r"  Dense\(net_dense0\): 40 params", res["port"][1])


def test_export_writes_what_both_packages_read_back(tmp_path):
    import json

    x = np.random.RandomState(2).randn(2, 3).astype(np.float32)

    def run(pkg, m, nn, ctx):
        net = nn.HybridSequential()
        net.add(nn.Dense(4, in_units=3), nn.Dense(2, in_units=4))
        net.initialize(m.initializer.Xavier(), ctx=ctx)
        net.hybridize()
        with pytest.raises(Exception, match="forward"):
            net.export(str(tmp_path / f"{pkg}-early"))
        out = net(m.nd.array(x, ctx=ctx)).asnumpy()
        files = net.export(str(tmp_path / pkg), epoch=3)
        return out, files, net
    res = _each_pkg(run)
    (tout, tfiles, tnet), (_, jfiles, jnet) = res["port"], res["jax"]
    assert tfiles == (str(tmp_path / "port-symbol.json"),
                      str(tmp_path / "port-0003.params"))
    tmeta, jmeta = (json.load(open(f[0])) for f in (tfiles, jfiles))
    assert set(tmeta) == set(jmeta) and tmeta["block"] == jmeta["block"]
    assert sorted(map(tuple, tmeta["params"].values())) == \
        sorted(map(tuple, jmeta["params"].values()))
    # the port's file loads into a fresh net of either package and gives
    # the exported net's outputs
    for pkg in ("jax", "port"):
        m, nn, ctx = PKG[pkg][0], PKG[pkg][1], PKG[pkg][4]
        net = nn.HybridSequential()
        net.add(nn.Dense(4, in_units=3), nn.Dense(2, in_units=4))
        net.initialize(ctx=ctx)
        net.load_parameters(tfiles[1])
        _close(net(m.nd.array(x, ctx=ctx)).asnumpy(), tout, pkg)


def test_parameter_var_and_reset_ctx():
    def run(pkg, m, nn, ctx):
        p = m.gluon.Parameter("w", shape=(2, 3))
        p.initialize(ctx=ctx)
        before = p.data().asnumpy()
        p.reset_ctx(ctx)
        net = nn.Dense(2, in_units=3)
        net.initialize(ctx=ctx)
        net.collect_params().reset_ctx(ctx)
        return (p.var().tojson(), np.array_equal(p.data().asnumpy(), before),
                [str(c) for c in p.list_ctx()],
                [str(c) for c in net.weight.list_ctx()])
    res = _each_pkg(run)
    assert res["port"][0] == res["jax"][0]
    assert res["port"][1] and res["jax"][1]
    assert res["port"][2] == res["port"][3] == res["jax"][2] == ["cpu(0)"]


def test_module_init_params_from_loaded(tmp_path):
    rs = np.random.RandomState(4)
    x = rs.randn(8, 5).astype(np.float32)

    def sym_of(m):
        data = m.sym.var("data")
        fc = m.sym.FullyConnected(data, num_hidden=3, name="fc")
        return m.sym.SoftmaxOutput(fc, name="softmax")

    jmod = mx.mod.Module(sym_of(mx), context=mx.cpu())
    jmod.bind(data_shapes=[("data", (8, 5))],
              label_shapes=[("softmax_label", (8,))])
    jmod.init_params(mx.initializer.Xavier())
    jmod.save_checkpoint(str(tmp_path / "m"), 1)
    args, _ = jmod.get_params()
    for m, ctx in ((mx, mx.cpu()), (mt, CPU)):
        mod = m.mod.Module.load(str(tmp_path / "m"), 1, context=ctx)
        mod.bind(data_shapes=[("data", (8, 5))],
                 label_shapes=[("softmax_label", (8,))])
        mod.init_params_from_loaded()
        got, _ = mod.get_params()
        for k, v in args.items():
            np.testing.assert_array_equal(got[k].asnumpy(), v.asnumpy())
        assert mod.params_initialized
