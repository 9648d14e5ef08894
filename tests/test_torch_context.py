"""``mx.Context`` in the port (``mxnet_tpu_torch/context.py``) against
the JAX package's: the attributes and tables, equality and ``repr``, the
thread-local ``with ctx:`` scope, ``resolve`` from a Context, a
``torch.device`` or a string, ``MXNET_DEFAULT_CONTEXT``, and the
Contexts that ``NDArray.ctx``, ``Parameter.list_ctx`` and ``Module``
report.  Without CUDA and outside a scope there is no default context:
every entry point raises rather than fall back to the CPU.
"""
import threading

import numpy as np
import pytest
import torch

import mxnet_tpu as mx

import mxnet_tpu_torch as mt
from mxnet_tpu_torch import context as tctx
from mxnet_tpu_torch.base import MXNetError

NO_CUDA = not torch.cuda.is_available()


def test_tables_match_the_jax_package():
    assert mt.Context.devtype2mask == mx.Context.devtype2mask
    assert mt.Context.devmask2type == mx.Context.devmask2type


@pytest.mark.parametrize("make,jmake", [
    (lambda: mt.gpu(0), lambda: mx.gpu(0)),
    (lambda: mt.gpu(3), lambda: mx.gpu(3)),
    (lambda: mt.cpu(), lambda: mx.cpu()),
    (lambda: mt.cpu_pinned(1), lambda: mx.context.cpu_pinned(1)),
    (lambda: mt.cpu_shared(), lambda: mx.context.cpu_shared())])
def test_context_attributes_match(make, jmake):
    t, j = make(), jmake()
    assert isinstance(t, mt.Context)
    assert (t.device_type, t.device_id, t.device_typeid) == \
        (j.device_type, j.device_id, j.device_typeid)
    assert repr(t) == repr(j) and str(t) == str(j)
    assert t == mt.Context(t) == mt.Context(t.device_type, t.device_id)
    assert hash(t) == hash(mt.Context(t.device_type, t.device_id))
    assert t != torch.device("cpu") and t != str(t)


def test_torch_device_mapping_and_resolve():
    assert mt.gpu(2).torch_device == torch.device("cuda", 2)
    for c in (mt.cpu(), mt.cpu(1), mt.cpu_pinned(), mt.cpu_shared()):
        assert c.torch_device == torch.device("cpu")
    assert tctx.resolve(mt.gpu(1)) == torch.device("cuda", 1)
    assert tctx.resolve(torch.device("cpu")) == torch.device("cpu")
    assert tctx.resolve("cuda") == torch.device("cuda", 0)
    assert tctx.resolve("cpu") == torch.device("cpu")
    assert tctx.resolve([mt.cpu()]) == torch.device("cpu")
    # several contexts name replicas: one device is refused, the list of
    # contexts is what the replica paths take
    with pytest.raises(MXNetError, match="replicas over several contexts"):
        tctx.resolve([mt.cpu(), mt.cpu(1)])
    assert tctx.context_list([mt.cpu(), mt.cpu(1)]) == [mt.cpu(0), mt.cpu(1)]
    assert tctx.context_list(mt.gpu(1)) == [mt.gpu(1)]
    assert tctx.as_context(torch.device("cuda", 1)) == mt.gpu(1)
    assert tctx.as_context("cpu") == mt.cpu(0)
    with pytest.raises(MXNetError, match="unknown device type"):
        mt.Context("npu")
    with pytest.raises(MXNetError, match="tpu"):
        mt.tpu()
    with pytest.raises(MXNetError, match="tpu"):
        mt.Context("tpu").torch_device


def test_with_scope_nests_and_restores():
    if NO_CUDA:
        with pytest.raises(MXNetError, match="no CUDA device"):
            mt.current_context()
    with mt.cpu() as c:
        assert c == mt.cpu()
        assert mt.current_context() == mt.cpu()
        a = mt.nd.zeros((2,))
        assert a.ctx == mt.cpu() and a._data.device.type == "cpu"
        with mt.gpu(1):
            assert mt.current_context() == mt.gpu(1)
            with mt.cpu(2):
                assert mt.current_context() == mt.cpu(2)
            assert mt.current_context() == mt.gpu(1)
        assert mt.current_context() == mt.cpu()
        b = mt.nd.sparse.zeros("row_sparse", (3, 2))
        assert b.ctx == mt.cpu()
        assert mt.nd.array(np.ones(2)).ctx == mt.cpu()
    if NO_CUDA:
        with pytest.raises(MXNetError, match="no CUDA device"):
            mt.nd.zeros((2,))


def test_scope_is_thread_local():
    seen = {}

    def other():
        try:
            seen["ctx"] = mt.current_context()
        except MXNetError as e:
            seen["err"] = str(e)

    with mt.cpu():
        th = threading.Thread(target=other)
        th.start()
        th.join()
    if NO_CUDA:
        assert "no CUDA device" in seen["err"]
    else:
        assert seen["ctx"] == mt.gpu(0)


@pytest.mark.parametrize("value,want", [("cpu", "cpu(0)"), ("gpu", None),
                                        ("npu", "bad")])
def test_default_context_env(monkeypatch, value, want):
    monkeypatch.setenv("MXNET_DEFAULT_CONTEXT", value)
    if want == "bad":
        with pytest.raises(MXNetError, match="'cpu' and 'gpu'"):
            mt.current_context()
    elif want is None and NO_CUDA:
        with pytest.raises(MXNetError, match="no CUDA device"):
            mt.current_context()
    elif want is None:
        assert mt.current_context() == mt.gpu(0)
    else:
        assert str(mt.current_context()) == want
        with mt.gpu(0):  # a scope wins over the variable
            assert mt.current_context() == mt.gpu(0)


def test_ndarray_ctx_is_a_context():
    x = mt.nd.array(np.arange(3, dtype=np.float32), ctx=mt.cpu())
    jx = mx.nd.array(np.arange(3, dtype=np.float32), ctx=mx.cpu())
    assert isinstance(x.ctx, mt.Context) and x.ctx == x.context == mt.cpu()
    assert str(x.ctx) == str(jx.ctx)
    assert repr(x).endswith("@cpu(0)>")
    assert x.as_in_context(mt.cpu()) is x
    assert x.as_in_context(torch.device("cpu")) is x
    y = mt.nd.zeros((2,), ctx=torch.device("cpu"))
    assert y.ctx == mt.cpu()


def test_parameter_module_and_estimator_report_contexts():
    p = mt.gluon.Parameter("w", shape=(2, 3))
    p.initialize(ctx=mt.cpu())
    assert p.list_ctx() == [mt.cpu()]
    sym = mt.sym.FullyConnected(mt.sym.var("data"), num_hidden=2)
    assert mt.mod.Module(sym, label_names=None,
                         context=mt.cpu())._context == [mt.cpu()]
    net = mt.gluon.nn.Dense(2, in_units=3)
    net.initialize(ctx=mt.cpu())
    est = mt.gluon.contrib.estimator.Estimator(
        net, mt.gluon.loss.L2Loss(), context=mt.cpu())
    assert est.context == [mt.cpu()]


def test_num_gpus_and_empty_cache():
    assert mt.num_gpus() == torch.cuda.device_count()
    mt.cpu().empty_cache()  # a no-op on the host
