"""The port's ``Monitor`` (``Module.install_monitor``, ``fit(monitor=)``)
and ``visualization`` against the JAX package's on the CPU.

Monitor: ``Module.fit`` of the MLP symbol in both packages from the
same seeded parameters over the same unshuffled batches, with
``Monitor(interval=2, pattern=..., sort=True)``: the same ``(step,
name)`` sequence comes out, each stat within 1e-6 relative (fp32; the
weights after the fit agree within 1e-5, ``test_torch_module.py``'s
bound).  The monitored fit ends with the unmonitored fit's weights bit
for bit, and a ``BucketingModule`` installs the monitor on each bucket's
module.

Visualization: ``print_summary``'s text (captured) and ``plot_network``'s
DOT source are identical for LeNet and for a narrow bottleneck ResNet
v1, with and without shapes and hidden weights.
"""
import logging

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu.module import Module as JModule

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch.module import Module as TModule

from test_torch_symbol import _params, mlp, resnet_v1

SGD = {"learning_rate": 0.05, "momentum": 0.9, "wd": 1e-4}
STAT_RTOL = 1e-6


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _toy(n=64, dim=10, classes=4, seed=0):
    rs = np.random.RandomState(seed)
    w = rs.randn(dim, classes)
    x = rs.randn(n, dim).astype("f4")
    return x, (x @ w).argmax(axis=1).astype("f4")


def _recording(mon_cls):
    class Recording(mon_cls):
        """toc_print keeps what toc returns."""

        rows = None

        def toc_print(self):
            self.rows = (self.rows or []) + self.toc()
    return Recording


def _fit(mx_, ctx, Mod, x, y, args, aux, monitor=None):
    it = mx_.io.NDArrayIter(x, y, batch_size=16, shuffle=False)
    mod = Mod(mlp(mx_.sym), context=ctx)
    mod.fit(it, num_epoch=1, optimizer_params=SGD, monitor=monitor,
            arg_params={k: mx_.nd.array(v, ctx=ctx) for k, v in args.items()},
            aux_params={k: mx_.nd.array(v, ctx=ctx) for k, v in aux.items()})
    return mod


@pytest.mark.parametrize("pattern", [".*", "fc1.*|softmax.*"])
def test_monitor_in_fit_matches_the_jax_module(pattern):
    x, y = _toy()
    args, aux = _params(mlp(tmx.sym), {"data": (16, 10)}, 3)
    rows, mods = [], []
    for mx_, ctx, Mod in ((jmx, jmx.cpu(), JModule),
                          (tmx, tmx.cpu(), TModule)):
        mon = _recording(mx_.monitor.Monitor)(2, pattern=pattern, sort=True)
        mods.append(_fit(mx_, ctx, Mod, x, y, args, aux, monitor=mon))
        rows.append(mon.rows)
    jrows, trows = rows
    assert [(n, k) for n, k, _ in trows] == [(n, k) for n, k, _ in jrows]
    steps = sorted({n for n, _, _ in trows})
    assert steps == [1, 3]  # batches 0 and 2 of 4 are tapped
    names = {k for _, k, _ in trows}
    if pattern == ".*":
        assert {"fc1_weight", "fc1_weight_grad", "softmax_output",
                "fc2_bias_grad"} <= names
    else:
        assert names == {"fc1_weight", "fc1_bias", "fc1_weight_grad",
                         "fc1_bias_grad", "softmax_output"}
    for (_, k, jv), (_, _, tv) in zip(jrows, trows):
        np.testing.assert_allclose(float(tv), float(jv), rtol=STAT_RTOL,
                                   err_msg=k)
    (ja, _), (ta, _) = mods[0].get_params(), mods[1].get_params()
    for k in ja:
        np.testing.assert_allclose(ta[k].asnumpy(), ja[k].asnumpy(),
                                   rtol=1e-5, atol=1e-6)


def test_monitor_changes_nothing_the_step_computes(caplog):
    x, y = _toy()
    args, aux = _params(mlp(tmx.sym), {"data": (16, 10)}, 3)
    mon = tmx.monitor.Monitor(1, stat_func=lambda a: a.abs().max())
    with caplog.at_level(logging.INFO):
        watched = _fit(tmx, tmx.cpu(), TModule, x, y, args, aux, mon)
    plain = _fit(tmx, tmx.cpu(), TModule, x, y, args, aux)
    for k, v in plain.get_params()[0].items():
        assert np.array_equal(watched.get_params()[0][k].asnumpy(),
                              v.asnumpy())
    logged = [r.getMessage() for r in caplog.records
              if r.getMessage().startswith("Batch:")]
    assert len(logged) == 4 * len(mon._modules[0].get_params()[0]) * 2 + 4
    assert mon.toc() == []  # nothing armed between batches
    # a module not yet initialised has nothing to tap
    idle = tmx.monitor.Monitor(1)
    idle.install(TModule(mlp(tmx.sym), context=tmx.cpu()))
    idle.tic()
    assert idle.toc() == []


def test_bucketing_module_installs_on_every_bucket():
    def sym_gen(key):
        return mlp(tmx.sym), ("data",), ("softmax_label",)

    bm = tmx.mod.BucketingModule(sym_gen, default_bucket_key=10,
                                 context=tmx.cpu())
    bm.bind([("data", (16, 10))], [("softmax_label", (16,))])
    bm.switch_bucket(12, [("data", (16, 10))], [("softmax_label", (16,))])
    mon = tmx.monitor.Monitor(1)
    bm.install_monitor(mon)
    assert len(mon._modules) == 2


def lenet(s):
    data = s.var("data")
    x = s.Convolution(data, kernel=(5, 5), num_filter=6, name="conv1")
    x = s.Activation(x, act_type="tanh", name="tanh1")
    x = s.Pooling(x, kernel=(2, 2), stride=(2, 2), pool_type="max",
                  name="pool1")
    x = s.Convolution(x, kernel=(5, 5), num_filter=16, name="conv2")
    x = s.BatchNorm(x, name="bn2")
    x = s.Activation(x, act_type="tanh", name="tanh2")
    x = s.Pooling(x, kernel=(2, 2), stride=(2, 2), pool_type="max",
                  name="pool2")
    x = s.Flatten(x, name="flat")
    x = s.FullyConnected(x, num_hidden=120, name="fc1")
    x = s.FullyConnected(x, num_hidden=10, name="fc2")
    return s.SoftmaxOutput(x, name="softmax")


def _resnet_unit(s):
    return resnet_v1(s, stages=((16, 1), (32, 2)), bottleneck=True)


NETS = {"lenet": (lenet, {"data": (2, 1, 28, 28)}),
        "resnet": (_resnet_unit, {"data": (2, 3, 16, 16)})}


def _built(make, mx_):
    """``make``'s symbol in ``mx_``, its automatic node names counted in
    a NameManager of its own: the two packages' process-wide counters
    differ by whatever other test files built before in this process."""
    with mx_.name.NameManager():
        return make(mx_.sym)


@pytest.mark.parametrize("net", sorted(NETS))
@pytest.mark.parametrize("with_shape", [True, False])
def test_print_summary_text_is_identical(net, with_shape, capsys):
    make, shape = NETS[net]
    out = []
    for mx_ in (jmx, tmx):
        mx_.visualization.print_summary(_built(make, mx_),
                                        shape=shape if with_shape else None)
        out.append(capsys.readouterr().out)
    assert out[0] == out[1]
    assert "Total params:" in out[1]
    if with_shape and net == "lenet":
        assert "(2, 6, 24, 24)" in out[1]


@pytest.mark.parametrize("net", sorted(NETS))
@pytest.mark.parametrize("hide", [True, False])
def test_plot_network_dot_is_identical(net, hide):
    make, _ = NETS[net]

    def dot(g):
        return g if isinstance(g, str) else g.source
    j = dot(jmx.visualization.plot_network(_built(make, jmx), title=net,
                                           hide_weights=hide))
    t = dot(tmx.viz.plot_network(_built(make, tmx), title=net,
                                 hide_weights=hide))
    assert t == j
    assert t.startswith(f'digraph "{net}"') and ('_weight"' in t) != hide
