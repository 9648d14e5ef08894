"""``Module`` over several contexts against the JAX package's ``Module``
on the same contexts, parameters and batches.

* The MLP and a small ResNet v1 symbol (BatchNorm) bound on
  ``[cpu(0), cpu(1)]``, fitted two epochs with SGD (momentum, wd)
  through ``kvstore='device'`` and ``'local'``: the parameters, the aux
  states (the first executor's) and the optimizer states, 1e-5 relative
  + 1e-6 for the MLP, 1e-4 + 1e-5 for the ResNet (fp32, the same sums of
  the executors' gradients; eight steps through BatchNorm leave
  1.03e-6 on a weight near 0.003).
* The executors: one per context, the batch sliced by ``_split_slice``
  (an uneven batch over three contexts included), the merged outputs
  and input gradients of a forward/backward against the JAX Module's,
  ``update_metric`` on the merged outputs, each executor's BatchNorm
  statistics its own slice's.
* ``init_optimizer(kvstore='dist_sync')`` in one process: a store of one
  worker, the same update as ``'device'``.
"""
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu.module import Module as JModule
from mxnet_tpu.module.executor_group import _split_slice as jsplit
from mxnet_tpu_torch.module import Module as TModule
from mxnet_tpu_torch.module.executor_group import _split_slice as tsplit

from test_torch_symbol import _params, mlp, resnet_v1

J2 = [jmx.cpu(0), jmx.cpu(1)]
T2 = [tmx.cpu(0), tmx.cpu(1)]
OPT = (("learning_rate", 0.1), ("momentum", 0.9), ("wd", 1e-4))


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _close(t, j, rtol=1e-5, atol=1e-6, what=""):
    t = t.asnumpy() if hasattr(t, "asnumpy") else np.asarray(t)
    j = j.asnumpy() if hasattr(j, "asnumpy") else np.asarray(j)
    assert t.shape == j.shape, what
    np.testing.assert_allclose(t, j, rtol=rtol, atol=atol, err_msg=what)


def _data(kind, n):
    rs = np.random.RandomState(7)
    if kind == "mlp":
        x = rs.randn(n, 10).astype("f4")
        return x, (x.sum(axis=1) > 0).astype("f4") + \
            (x[:, 0] > 0).astype("f4")
    return rs.randn(n, 3, 8, 8).astype("f4"), \
        rs.randint(0, 10, n).astype("f4")


def _make(kind, mx_):
    """The symbol in ``mx_``, named under a NameManager of its own (the
    process-wide counters stay where other files' tests expect them)."""
    with mx_.name.NameManager():
        return mlp(mx_.sym) if kind == "mlp" else resnet_v1(mx_.sym)


def _fit(kind, kvstore, batch=8, n=32):
    x, y = _data(kind, n)
    shape = (batch,) + x.shape[1:]
    args, aux = _params(_make(kind, tmx), {"data": shape}, 3)
    mods = []
    for mx_, ctx, Mod in ((jmx, J2, JModule), (tmx, T2, TModule)):
        it = mx_.io.NDArrayIter(x, y, batch_size=batch, shuffle=False)
        mod = Mod(_make(kind, mx_), context=ctx)
        mod.fit(it, num_epoch=2, kvstore=kvstore, optimizer="sgd",
                optimizer_params=OPT,
                arg_params={k: mx_.nd.array(v, ctx=ctx[0])
                            for k, v in args.items()},
                aux_params={k: mx_.nd.array(v, ctx=ctx[0])
                            for k, v in aux.items()})
        mods.append(mod)
    return mods


@pytest.mark.parametrize("kind", ["mlp", "resnet"])
@pytest.mark.parametrize("kvstore", ["device", "local"])
def test_fit_over_two_contexts(kind, kvstore):
    jm, tm = _fit(kind, kvstore)
    tol = dict(rtol=1e-5, atol=1e-6) if kind == "mlp" \
        else dict(rtol=1e-4, atol=1e-5)
    assert len(tm._exec_group.execs) == len(jm._exec_group.execs) == 2
    ja, jx = jm.get_params()
    ta, tx = tm.get_params()
    assert sorted(ta) == sorted(ja) and sorted(tx) == sorted(jx)
    for k in ja:
        _close(ta[k], ja[k], what=k, **tol)
    for k in jx:
        _close(tx[k], jx[k], what=k, **tol)
    js, ts = jm._updater.states, tm._updater.states
    assert sorted(ts) == sorted(js)
    for i in js:
        _close(ts[i], js[i], what=f"state {i}", **tol)
    # the executors' parameters stay equal
    for name in ta:
        a = [ex.arg_dict[name].asnumpy() for ex in tm._exec_group.execs]
        np.testing.assert_array_equal(a[0], a[1])


@pytest.mark.parametrize("batch,n", [(8, 2), (10, 3), (7, 2), (3, 4)])
def test_split_slice(batch, n):
    assert tsplit(batch, n) == jsplit(batch, n)


def test_outputs_input_grads_and_metric():
    x, y = _data("resnet", 6)
    args, aux = _params(_make("resnet", tmx), {"data": (6, 3, 8, 8)}, 5)
    got = {}
    for mx_, ctx, Mod in ((jmx, [jmx.cpu(i) for i in range(3)], JModule),
                          (tmx, [tmx.cpu(i) for i in range(3)], TModule)):
        mod = Mod(_make("resnet", mx_), context=ctx)
        mod.bind(data_shapes=[("data", (6, 3, 8, 8))],
                 label_shapes=[("softmax_label", (6,))],
                 inputs_need_grad=True)
        mod.init_params(arg_params={k: mx_.nd.array(v, ctx=ctx[0])
                                    for k, v in args.items()},
                        aux_params={k: mx_.nd.array(v, ctx=ctx[0])
                                    for k, v in aux.items()})
        batch = mx_.io.DataBatch([mx_.nd.array(x, ctx=ctx[0])],
                                 [mx_.nd.array(y, ctx=ctx[0])])
        mod.forward(batch, is_train=True)
        mod.backward()
        metric = mx_.metric.create("acc")
        mod.update_metric(metric, batch.label)
        per = mod.get_outputs(merge_multi_context=False)
        stats = [ex.aux_dict[mod._aux_names[0]].asnumpy()
                 for ex in mod._exec_group.execs]
        got[mx_.__name__] = (mod.get_outputs()[0].asnumpy(),
                             mod.get_input_grads()[0].asnumpy(),
                             metric.get()[1], [len(p) for p in per],
                             stats, mod._exec_group.slices)
    t, j = got["mxnet_tpu_torch"], got["mxnet_tpu"]
    _close(t[0], j[0], what="outputs")
    _close(t[1], j[1], what="input grads")
    assert t[2] == j[2] and t[3] == j[3] == [3]
    assert t[5] == j[5]
    for a, b in zip(t[4], j[4]):
        _close(a, b, what="an executor's moving mean")
    assert np.abs(t[4][0] - t[4][1]).max() > 0


def test_dist_sync_store_in_one_process():
    """``kvstore='dist_sync'`` with one worker: the store sums and the
    first executor updates, as with 'device'."""
    out = []
    for kv in ("dist_sync", "device"):
        _, tm = _fit("mlp", kv)
        if kv == "dist_sync":
            assert tm._kvstore.type == "dist_sync"
            assert tm._kvstore.num_workers == 1
        out.append(tm.get_params()[0])
    for k in out[1]:
        np.testing.assert_array_equal(out[0][k].asnumpy(),
                                      out[1][k].asnumpy())
