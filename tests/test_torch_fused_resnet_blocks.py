"""The fused ResNet V1 blocks of the port against the JAX package's, block
by block, on the CPU: the per-block cases of ``tests/test_fused_resnet.py``
(bottleneck and basic, stride 1 and stride 2 with a downsample, and eval
mode), port against ``mxnet_tpu``.

Each case builds the JAX block, initializes it (Xavier) and carries its
weights across by structural name.  One hybridized training forward and
backward of sum(out²) under ``autograd.record()`` runs in the JAX
package op-granular and fused (``MXNET_FUSED_CONVBN=1``), and in the port
fused, with the fused backward's plain version
(``MXNET_FUSED_CONVBN_BWD=1``, stride-1 units) and without it.  The
port's output, every parameter gradient and the running statistics are
held against both JAX runs with the JAX test's tolerances (output and
running statistics rtol = atol = 2e-4, gradients 2e-3).  Eval mode: the
running statistics warmed by one training forward, then the eval
forward of the fused port block against the JAX op-granular one.
"""
import numpy as np
import pytest

import mxnet_tpu as mx
from mxnet_tpu import autograd as jag
from mxnet_tpu.gluon.model_zoo.vision import resnet as jres

import mxnet_tpu_torch as mt
from mxnet_tpu_torch.gluon import load_numpy_params
from mxnet_tpu_torch.gluon.model_zoo.vision import resnet as tres

CASES = {
    "bottleneck": ("BottleneckV1", 16, 1, False),
    "bottleneck_stride2_downsample": ("BottleneckV1", 32, 2, True),
    "basic": ("BasicBlockV1", 16, 1, False),
    "basic_stride2_downsample": ("BasicBlockV1", 32, 2, True),
}
PORT_MODES = {"fused": ("1", "0"), "fused_bwd": ("1", "1")}
OUT_TOL, GRAD_TOL = 2e-4, 2e-3


def _x(seed=3):
    return np.random.RandomState(seed).randn(2, 8, 8, 16).astype(np.float32)


def _jax_block(case):
    cls, channels, stride, down = CASES[case]
    np.random.seed(0)
    mx.random.seed(0)
    b = getattr(jres, cls)(channels, stride, downsample=down, in_channels=16,
                           layout="NHWC")
    b.initialize(mx.initializer.Xavier(), ctx=mx.cpu())
    b(mx.nd.array(_x()))  # resolve deferred shapes eagerly
    return b


def _jax_step(case, fused, monkeypatch):
    if fused:
        monkeypatch.setenv("MXNET_FUSED_CONVBN", "1")
    else:
        monkeypatch.delenv("MXNET_FUSED_CONVBN", raising=False)
    b = _jax_block(case)
    params = b._collect_params_with_prefix()
    vals = {n: p.data().asnumpy().copy() for n, p in params.items()}
    b.hybridize()
    with jag.record():
        out = b(mx.nd.array(_x()))
        loss = (out * out).sum()
    loss.backward()
    grads = {n: p.grad().asnumpy().copy() for n, p in params.items()
             if p.grad_req != "null"}
    aux = {n: p.data().asnumpy().copy() for n, p in params.items()
           if "running" in n}
    monkeypatch.delenv("MXNET_FUSED_CONVBN", raising=False)
    return vals, out.asnumpy(), grads, aux


def _port_block(case, vals):
    cls, channels, stride, down = CASES[case]
    b = getattr(tres, cls)(channels, stride, downsample=down,
                           in_channels=16, layout="NHWC")
    b.initialize(ctx=mt.cpu())
    load_numpy_params(b, vals)
    b.hybridize()
    return b


def _close(got, want, tol, what):
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol, err_msg=what)


@pytest.mark.parametrize("mode", sorted(PORT_MODES))
@pytest.mark.parametrize("case", sorted(CASES))
def test_fused_block_train_step_matches_jax(case, mode, monkeypatch):
    vals, j_out, j_grads, j_aux = _jax_step(case, False, monkeypatch)
    _, jf_out, jf_grads, jf_aux = _jax_step(case, True, monkeypatch)
    fused, bwd = PORT_MODES[mode]
    monkeypatch.setenv("MXNET_FUSED_CONVBN", fused)
    monkeypatch.setenv("MXNET_FUSED_CONVBN_BWD", bwd)
    b = _port_block(case, vals)
    x = mt.nd.array(_x(), ctx=mt.cpu())
    with mt.autograd.record():
        out = b(x)
        loss = (out * out).sum()
    loss.backward()
    params = b.collect_params()
    grads = {n: params[n].grad().asnumpy() for n in j_grads}
    aux = {n: params[n].data().asnumpy() for n in j_aux}
    trained = {n for n, p in params.items() if p.grad_req != "null"}
    assert trained == set(j_grads) == set(jf_grads)
    for tag, w_out, w_grads, w_aux in (("op-granular", j_out, j_grads,
                                        j_aux),
                                       ("fused", jf_out, jf_grads, jf_aux)):
        _close(out.asnumpy(), w_out, OUT_TOL, f"out vs JAX {tag}")
        for n in w_grads:
            _close(grads[n], w_grads[n], GRAD_TOL, f"grad {n} vs JAX {tag}")
        for n in w_aux:
            _close(aux[n], w_aux[n], OUT_TOL, f"aux {n} vs JAX {tag}")


def test_fused_block_eval_mode_matches_jax(monkeypatch):
    monkeypatch.delenv("MXNET_FUSED_CONVBN", raising=False)
    xnp = _x(seed=5)
    jb = _jax_block("bottleneck")
    vals = {n: p.data().asnumpy().copy()
            for n, p in jb._collect_params_with_prefix().items()}
    jb.hybridize()
    with jag.record():
        jb(mx.nd.array(xnp))  # warm the running statistics
    j_eval = jb(mx.nd.array(xnp)).asnumpy()

    tb = _port_block("bottleneck", vals)
    x = mt.nd.array(xnp, ctx=mt.cpu())
    with mt.autograd.record():
        tb(x)
    monkeypatch.setenv("MXNET_FUSED_CONVBN", "1")
    tb.hybridize()
    _close(tb(x).asnumpy(), j_eval, OUT_TOL, "eval out")
