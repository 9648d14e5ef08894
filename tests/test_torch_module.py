"""mxnet_tpu_torch's Module API against the JAX package's, on the CPU.

``Module.fit`` of the MLP and of a narrow two-stage ResNet v1 (the
symbolic builders of ``test_torch_symbol.py``) from the same
``arg_params``/``aux_params`` over the same unshuffled ``NDArrayIter``:
after two epochs the weights, the BatchNorm moving statistics and the
SGD momenta equal the JAX Module's within 1e-5 relative (1e-6 absolute)
on the MLP in fp32; the ResNet's steps (BatchNorm over small maps, whose
fp32 rounding the steps amplify) run in float64 in both packages
(``jax.enable_x64``) within 1e-9.  Then score and predict, checkpoints
written by one package and read by the other (``Module.load``,
``model.load_checkpoint``, ``SymbolBlock.imports``), optimizer states
both ways, callbacks, an lr scheduler inside ``fit`` and the errors for
what is not ported.
"""
import logging
import os

import jax
import numpy as np
import pytest

import mxnet_tpu as jmx
from mxnet_tpu.module import Module as JModule

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.module import Module as TModule

from test_torch_symbol import _params, mlp, resnet_v1

CPU_J, CPU_T = jmx.cpu(), tmx.cpu()


def _close(t, j, rtol=1e-5, atol=1e-6):
    t = t.asnumpy() if hasattr(t, "asnumpy") else np.asarray(t)
    j = j.asnumpy() if hasattr(j, "asnumpy") else np.asarray(j)
    assert t.shape == j.shape
    np.testing.assert_allclose(t, j, rtol=rtol, atol=atol)


def _toy(n=96, dim=10, classes=4, seed=0):
    rs = np.random.RandomState(seed)
    w = rs.randn(dim, classes)
    x = rs.randn(n, dim).astype("f4")
    return x, (x @ w).argmax(axis=1).astype("f4")


def _images(n=12, seed=1):
    rs = np.random.RandomState(seed)
    return (rs.randn(n, 3, 8, 8).astype("f4"),
            rs.randint(0, 10, n).astype("f4"))


def _as_dtype(mx_, it, dtype):
    """``it``'s batches cast to ``dtype`` (NDArrayIter keeps float32)."""
    class Cast(mx_.io.DataIter):
        provide_data = property(lambda self: it.provide_data)
        provide_label = property(lambda self: it.provide_label)

        def reset(self):
            it.reset()

        def next(self):
            b = it.next()
            return mx_.io.DataBatch([d.astype(dtype) for d in b.data],
                                    [v.astype(dtype) for v in b.label],
                                    pad=b.pad)
    return Cast(it.batch_size)


def _fit_both(make, x, y, batch, args, aux, dtype, epochs=2, **fit_kw):
    """Fit a Module of ``make(sym)`` in each package from the same
    parameters and batches in ``dtype``; returns the two modules."""
    mods = []
    for mx_, ctx, Mod in ((jmx, CPU_J, JModule), (tmx, CPU_T, TModule)):
        it = _as_dtype(mx_, mx_.io.NDArrayIter(x, y, batch_size=batch,
                                               shuffle=False), dtype)
        mod = Mod(make(mx_.sym), context=ctx)
        mod.fit(it, num_epoch=epochs,
                arg_params={k: mx_.nd.array(v, ctx=ctx, dtype=dtype)
                            for k, v in args.items()},
                aux_params={k: mx_.nd.array(v, ctx=ctx, dtype=dtype)
                            for k, v in aux.items()},
                **fit_kw)
        mods.append(mod)
    return mods


def _hold_modules(jm, tm, rtol, atol):
    ja, jx = jm.get_params()
    ta, tx = tm.get_params()
    assert sorted(ta) == sorted(ja) and sorted(tx) == sorted(jx)
    for k in ja:
        _close(ta[k], ja[k], rtol, atol)
    for k in jx:
        _close(tx[k], jx[k], rtol, atol)
    js, ts = jm._updater.states, tm._updater.states
    assert sorted(ts) == sorted(js)
    for i in js:
        if js[i] is None:  # plain SGD keeps no state
            assert ts[i] is None
        else:
            _close(ts[i], js[i], rtol, atol)


SGD = {"learning_rate": 0.05, "momentum": 0.9, "wd": 1e-4}


def test_fit_mlp_matches_the_jax_module():
    x, y = _toy()
    args, aux = _params(mlp(tmx.sym), {"data": (32, 10)}, 3)
    jm, tm = _fit_both(mlp, x, y, 32, args, aux, "float32",
                       optimizer_params=SGD)
    _hold_modules(jm, tm, 1e-5, 1e-6)


def test_fit_resnet_matches_the_jax_module_float64():
    x, y = _images()
    args, aux = _params(resnet_v1(tmx.sym), {"data": (4, 3, 8, 8)}, 5,
                        dtype=np.float64)
    with jax.enable_x64(True):
        jm, tm = _fit_both(resnet_v1, x, y, 4, args, aux, "float64",
                           optimizer_params=SGD)
        _hold_modules(jm, tm, 1e-9, 1e-12)


def test_fit_with_an_lr_scheduler_and_callbacks(tmp_path, caplog):
    x, y = _toy(n=64)
    args, aux = _params(mlp(tmx.sym), {"data": (16, 10)}, 4)
    prefix = {m: str(tmp_path / m) for m in ("j", "t")}
    mods = []
    with caplog.at_level(logging.INFO):
        for mx_, ctx, Mod, tag in ((jmx, CPU_J, JModule, "j"),
                                   (tmx, CPU_T, TModule, "t")):
            it = mx_.io.NDArrayIter(x, y, batch_size=16)
            val = mx_.io.NDArrayIter(x, y, batch_size=16)
            sched = mx_.lr_scheduler.FactorScheduler(step=3, factor=0.5)
            mod = Mod(mlp(mx_.sym), context=ctx)
            mod.fit(it, eval_data=val, num_epoch=2,
                    arg_params={k: mx_.nd.array(v, ctx=ctx)
                                for k, v in args.items()},
                    optimizer_params={"learning_rate": 0.1,
                                      "lr_scheduler": sched},
                    batch_end_callback=[
                        mx_.callback.Speedometer(16, frequent=2),
                        mx_.callback.log_train_metric(2)],
                    epoch_end_callback=mx_.callback.do_checkpoint(
                        prefix[tag]))
            mods.append((mod, sched))
    (jm, js), (tm, ts) = mods
    # 8 updates, two halvings of the scheduler's own base_lr (0.01): as in
    # the JAX package, the optimizer's learning_rate does not reach _cur
    assert ts._cur == js._cur == 0.0025
    _hold_modules(jm, tm, 1e-5, 1e-6)
    for tag in ("j", "t"):
        assert os.path.exists(f"{prefix[tag]}-symbol.json")
        assert os.path.exists(f"{prefix[tag]}-0002.params")
    assert any("Speed" in r.message for r in caplog.records)
    assert any("Validation-accuracy" in r.message for r in caplog.records)


def test_score_predict_and_outputs():
    x, y = _toy(n=40)
    args, _ = _params(mlp(tmx.sym), {"data": (16, 10)}, 6)
    res = []
    for mx_, ctx, Mod in ((jmx, CPU_J, JModule), (tmx, CPU_T, TModule)):
        it = mx_.io.NDArrayIter(x, y, batch_size=16)  # pads the last
        mod = Mod(mlp(mx_.sym), context=ctx)
        mod.bind(data_shapes=it.provide_data, label_shapes=it.provide_label,
                 for_training=False)
        mod.init_params(arg_params={k: mx_.nd.array(v, ctx=ctx)
                                    for k, v in args.items()})
        res.append((mod.predict(it), dict(mod.score(it, "acc")),
                    mod.output_shapes))
    (jp, jsc, jsh), (tp, tsc, tsh) = res
    assert tp.shape == (40, 4)
    _close(tp, jp)
    assert tsc == jsc and tsh == jsh


def test_forward_backward_input_grads_and_reshape():
    x, y = _toy(n=8)
    args, _ = _params(mlp(tmx.sym), {"data": (8, 10)}, 7)
    grads = []
    for mx_, ctx, Mod in ((jmx, CPU_J, JModule), (tmx, CPU_T, TModule)):
        it = mx_.io.NDArrayIter(x, y, batch_size=8)
        mod = Mod(mlp(mx_.sym), context=ctx)
        mod.bind(data_shapes=it.provide_data, label_shapes=it.provide_label,
                 inputs_need_grad=True)
        mod.init_params(arg_params={k: mx_.nd.array(v, ctx=ctx)
                                    for k, v in args.items()})
        mod.forward_backward(next(iter(it)))
        grads.append(mod.get_input_grads()[0])
        mod.reshape([("data", (4, 10))], [("softmax_label", (4,))])
        mod.forward(mx_.io.DataBatch([mx_.nd.array(x[:4], ctx=ctx)],
                                     [mx_.nd.array(y[:4], ctx=ctx)]),
                    is_train=False)
        grads.append(mod.get_outputs()[0])
    _close(grads[2], grads[0])
    _close(grads[3], grads[1])
    assert grads[3].shape == (4, 4)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_checkpoints_load_both_ways(writer, tmp_path):
    """A checkpoint and optimizer states written by one package load in
    the other through Module.load, model.load_checkpoint and
    SymbolBlock.imports, and predict the same."""
    x, y = _toy(n=32)
    args, _ = _params(mlp(tmx.sym), {"data": (16, 10)}, 8)
    prefix = str(tmp_path / "mlp")
    w_mx, w_ctx, w_mod, r_mx, r_ctx, r_mod = (
        (jmx, CPU_J, JModule, tmx, CPU_T, TModule) if writer == "jax"
        else (tmx, CPU_T, TModule, jmx, CPU_J, JModule))
    it = w_mx.io.NDArrayIter(x, y, batch_size=16)
    mod = w_mod(mlp(w_mx.sym), context=w_ctx)
    mod.fit(it, num_epoch=1, optimizer_params=SGD,
            arg_params={k: w_mx.nd.array(v, ctx=w_ctx)
                        for k, v in args.items()})
    mod.save_checkpoint(prefix, 3, save_optimizer_states=True)
    before = mod.predict(it)
    rit = r_mx.io.NDArrayIter(x, y, batch_size=16)
    loaded = r_mod.load(prefix, 3, load_optimizer_states=True,
                        context=r_ctx)
    loaded.bind(data_shapes=rit.provide_data,
                label_shapes=rit.provide_label)
    _close(loaded.predict(rit), before)
    loaded.init_optimizer(optimizer_params=SGD)
    if r_mx is jmx:  # the JAX Module does not read preloaded states
        loaded.load_optimizer_states(f"{prefix}-0003.states")
    for i, s in mod._updater.states.items():
        _close(loaded._updater.states[i], s, rtol=0, atol=0)
    sym, arg, aux = r_mx.model.load_checkpoint(prefix, 3)
    assert sym.tojson() == mod.symbol.tojson() and aux == {}
    for k, v in mod.get_params()[0].items():
        _close(arg[k], v, rtol=0, atol=0)
    # the label is an input of the graph; the head's forward ignores it
    net = r_mx.gluon.SymbolBlock.imports(
        f"{prefix}-symbol.json", ["data", "softmax_label"],
        f"{prefix}-0003.params", ctx=r_ctx)
    out = net(r_mx.nd.array(x, ctx=r_ctx), r_mx.nd.array(y, ctx=r_ctx))
    _close(out, before)


def test_symbol_block_trains_and_matches_the_jax_block():
    x, _ = _images(n=4)

    def net(s):
        h = s.Convolution(s.var("data"), kernel=(3, 3), num_filter=4,
                          pad=(1, 1), name="c")
        return s.FullyConnected(s.Activation(s.BatchNorm(h, name="bn"),
                                             act_type="relu"),
                                num_hidden=3, name="fc")
    args, aux = _params(net(tmx.sym), {"data": x.shape}, 9)
    outs = []
    for mx_, ctx in ((jmx, CPU_J), (tmx, CPU_T)):
        params = {k: mx_.nd.array(v, ctx=ctx) for k, v in {**args,
                                                          **aux}.items()}
        blk = mx_.gluon.SymbolBlock(net(mx_.sym), "data")
        blk.initialize(ctx=ctx)
        xd = mx_.nd.array(x, ctx=ctx)
        blk(xd)
        for name, p in blk.collect_params().items():
            p.set_data(params[name])
        with mx_.autograd.record():
            y = blk(xd)
        y.backward()
        outs.append((y, {n: p.grad() for n, p in
                         blk.collect_params().items()
                         if p.grad_req != "null"},
                     {n: p.data() for n, p in blk.collect_params().items()
                      if n.startswith("bn_moving")}))
    (jy, jg, ja), (ty, tg, ta) = outs
    _close(ty, jy)
    assert sorted(tg) == sorted(jg)
    for n in jg:
        _close(tg[n], jg[n], rtol=1e-4, atol=1e-5)
    for n in ja:
        _close(ta[n], ja[n])


def test_several_contexts_and_unported_parts_raise():
    # several contexts: one executor each (tests/test_torch_module_replicas
    # holds them against the JAX Module); a dist store in one process
    two = TModule(mlp(tmx.sym), context=[tmx.cpu(0), tmx.cpu(1)])
    two.bind(data_shapes=[("data", (8, 10))],
             label_shapes=[("softmax_label", (8,))])
    assert [ex._ctx for ex in two._exec_group.execs] == [
        tmx.cpu(0).torch_device] * 2
    assert two._exec_group.slices == [slice(0, 4), slice(4, 8)]
    mod = TModule(mlp(tmx.sym), context=CPU_T)
    mon = tmx.monitor.Monitor(1)
    mod.install_monitor(mon)
    assert mon._modules == [mod]
    assert tmx.kv.create("dist_sync").num_workers == 1
    import torch

    if not torch.cuda.is_available():
        with pytest.raises(MXNetError, match="no CUDA device"):
            TModule(mlp(tmx.sym))


def test_feedforward_adapter():
    x, y = _toy(n=64)
    ff = tmx.model.FeedForward(mlp(tmx.sym), ctx=CPU_T, num_epoch=3,
                               numpy_batch_size=32,
                               initializer=tmx.init.Xavier(),
                               optimizer_params={"learning_rate": 0.1})
    ff.fit(x, y)
    assert ff.predict(x).shape == (64, 4)


def test_fused_update_of_float64_weights_is_the_eager_update():
    """Module.update runs FusedUpdater; over float64 weights its per-step
    scalars are float64 too, so the captured update gives the eager
    per-parameter update's bits (fp32 scalars rounded lr 0.05 by 1.5e-8
    relative)."""
    import torch

    from mxnet_tpu_torch.optimizer import FusedUpdater, Updater

    rs = np.random.RandomState(11)
    ws = [rs.randn(*s) for s in ((4, 3), (5,))]
    gs = [rs.randn(*w.shape) for w in ws]
    out = []
    for make in (FusedUpdater, Updater):
        opt = tmx.optimizer.create("sgd", learning_rate=0.05, momentum=0.9,
                                   wd=1e-4)
        upd = make(opt)
        w = [tmx.nd.array(a, ctx=CPU_T, dtype="float64") for a in ws]
        g = [tmx.nd.array(a, ctx=CPU_T, dtype="float64") for a in gs]
        for _ in range(3):
            if make is FusedUpdater:
                upd.update_all([0, 1], g, w)
            else:
                for i in range(2):
                    upd(i, g[i], w[i])
        out.append([a._data.clone() for a in w]
                   + [upd.states[i]._data.clone() for i in range(2)])
    for a, b in zip(*out):
        assert a.dtype == torch.float64
        assert torch.equal(a, b)
