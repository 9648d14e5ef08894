"""mxnet_tpu_torch's fused Conv+BN unit and ops against the JAX package.

The port's ``fused_conv_unit`` on CPU tensors runs its plain PyTorch
version; it is held against the JAX package's XLA unit (``_xla_unit``)
and its Pallas kernel in interpret mode (``_pallas_unit`` under
MXNET_PALLAS_INTERPRET=1), on the same numpy inputs, fp32.  The CUDA
kernel itself runs only on a card: ``chip_smoke.py`` holds it against
the plain version there.

Tolerances: y atol/rtol 1e-5 (fp32, the same arithmetic in another
summation order); s1/s2 1e-4 relative to sum|.| (sums over N*H*W).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mxnet_tpu.ops import nn as jnn
from mxnet_tpu.ops import pallas_convbn as pcb

from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.ops import fused_convbn as tfc
from mxnet_tpu_torch.ops import nn as tnn


def _inputs(seed, shape, co, kernel, bias_shift=0.0):
    rs = np.random.RandomState(seed)
    ci = shape[-1]
    x = rs.randn(*shape).astype(np.float32)
    w = (rs.randn(co, ci, *kernel) * 0.2).astype(np.float32)
    sc = (rs.rand(ci) + 0.5).astype(np.float32)
    bi = (rs.randn(ci) + bias_shift).astype(np.float32)
    sh = rs.randn(co).astype(np.float32)
    return x, w, sc, bi, sh


# (shape NHWC, Co, kernel, stride, pad, act_in, want_stats, in_bias shift)
CASES = [
    ((2, 8, 8, 16), 24, (1, 1), (1, 1), (0, 0), False, True, 0.0),
    ((2, 8, 8, 16), 24, (1, 1), (1, 1), (0, 0), True, False, 0.0),
    ((2, 9, 9, 8), 16, (1, 1), (2, 2), (0, 0), False, True, 0.0),
    ((2, 8, 8, 8), 16, (1, 1), (2, 2), (0, 0), True, True, 0.0),
    ((2, 7, 7, 16), 8, (3, 3), (1, 1), (1, 1), True, True, 0.0),
    ((2, 7, 7, 16), 8, (3, 3), (1, 1), (1, 1), False, False, 0.0),
    ((2, 8, 8, 8), 16, (3, 3), (2, 2), (1, 1), True, True, 0.0),
    # in_bias shifted negative and positive: border taps must read exact
    # zeros after the affine, never relu(in_bias) (PERF.md Round 5)
    ((2, 6, 6, 8), 8, (3, 3), (1, 1), (1, 1), True, True, -1.5),
    ((2, 6, 6, 8), 8, (3, 3), (1, 1), (1, 1), True, True, 2.0),
]


def _ids(c):
    return (f"{c[2][0]}x{c[2][1]}s{c[3][0]}p{c[4][0]}"
            f"{'-act' if c[5] else ''}{'-stats' if c[6] else ''}"
            f"{'-bias%+g' % c[7] if c[7] else ''}")


def _port(x, w, sc, bi, sh, kernel, stride, pad, act_in, want_stats):
    y, s1, s2 = tfc.fused_conv_unit(
        torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(sc),
        torch.from_numpy(bi), torch.from_numpy(sh), kernel=kernel,
        stride=stride, pad=pad, act_in=act_in, want_stats=want_stats)
    return y.numpy(), s1.numpy(), s2.numpy()


def _check(port, ref, want_stats, y_abs):
    y, s1, s2 = port
    yr, s1r, s2r = (np.asarray(v) for v in ref)
    assert y.shape == yr.shape
    np.testing.assert_allclose(y, yr, rtol=1e-5, atol=1e-5)
    if want_stats:
        scale1 = np.abs(y_abs).sum(axis=(0, 1, 2))
        assert np.all(np.abs(s1 - s1r) <= 1e-4 * scale1 + 1e-6)
        assert np.all(np.abs(s2 - s2r) <= 1e-4 * np.abs(s2r) + 1e-6)
    else:
        assert not s1.any() and not s2.any()
        assert not s1r.any() and not s2r.any()


@pytest.mark.parametrize("case", CASES, ids=[_ids(c) for c in CASES])
def test_port_unit_matches_jax_xla_unit(case):
    shape, co, kernel, stride, pad, act_in, want_stats, bshift = case
    x, w, sc, bi, sh = _inputs(11, shape, co, kernel, bshift)
    port = _port(x, w, sc, bi, sh, kernel, stride, pad, act_in, want_stats)
    ref = pcb._xla_unit(jnp.asarray(x), jnp.asarray(w), jnp.asarray(sc),
                        jnp.asarray(bi), jnp.asarray(sh), kernel=kernel,
                        stride=stride, pad=pad, act_in=act_in,
                        want_stats=want_stats)
    _check(port, ref, want_stats, np.asarray(ref[0]))


@pytest.mark.parametrize("case", CASES, ids=[_ids(c) for c in CASES])
def test_port_unit_matches_pallas_interpret(case, monkeypatch):
    shape, co, kernel, stride, pad, act_in, want_stats, bshift = case
    monkeypatch.setenv("MXNET_PALLAS_INTERPRET", "1")
    x, w, sc, bi, sh = _inputs(12, shape, co, kernel, bshift)
    port = _port(x, w, sc, bi, sh, kernel, stride, pad, act_in, want_stats)
    ref = pcb._pallas_unit(jnp.asarray(x), jnp.asarray(w), jnp.asarray(sc),
                           jnp.asarray(bi), jnp.asarray(sh), kernel=kernel,
                           stride=stride, pad=pad, act_in=act_in,
                           want_stats=want_stats)
    _check(port, ref, want_stats, np.asarray(ref[0]))


def test_padding_follows_affine():
    """A 3x3 unit over a constant zero input with a positive in_bias: the
    interior sees relu(bias) on every tap, the border sees exact zeros
    where the window leaves the image."""
    x = torch.zeros(1, 3, 3, 1)
    w = torch.ones(1, 1, 3, 3)
    y, _, _ = tfc.fused_conv_unit(x, w, torch.ones(1), torch.full((1,), 2.0),
                                  None, kernel=(3, 3), pad=(1, 1),
                                  act_in=True, want_stats=False)
    want = 2.0 * np.array([[4, 6, 4], [6, 9, 6], [4, 6, 4]], np.float32)
    np.testing.assert_array_equal(y[0, :, :, 0].numpy(), want)


def test_cpu_tensors_never_launch_the_kernel():
    x, w, sc, bi, sh = _inputs(3, (1, 4, 4, 8), 8, (1, 1))
    before = tfc.launch_count()
    _port(x, w, sc, bi, sh, (1, 1), (1, 1), (0, 0), True, True)
    assert tfc.launch_count() == before


def test_defaults_are_identity_affine_and_zero_shift():
    x, w, sc, bi, sh = _inputs(4, (2, 5, 5, 8), 4, (3, 3))
    tx, tw = torch.from_numpy(x), torch.from_numpy(w)
    y, s1, s2 = tfc.fused_conv_unit(tx, tw, kernel=(3, 3), pad=(1, 1))
    yr, s1r, s2r = tfc.fused_conv_unit(tx, tw, torch.ones(8), torch.zeros(8),
                                       torch.zeros(4), kernel=(3, 3),
                                       pad=(1, 1))
    assert torch.equal(y, yr) and torch.equal(s1, s1r) \
        and torch.equal(s2, s2r)


@pytest.mark.parametrize("bad", ["float16", "weight_dtype", "weight_shape",
                                 "kernel", "devices", "in_scale"])
def test_unit_rejects_what_the_kernel_does_not_take(bad):
    x = torch.zeros(1, 4, 4, 8)
    w = torch.zeros(8, 8, 1, 1)
    kw = {}
    sc = None
    if bad == "float16":
        x, w = x.half(), w.half()
    elif bad == "weight_dtype":
        w = w.bfloat16()
    elif bad == "weight_shape":
        w = torch.zeros(8, 4, 1, 1)
    elif bad == "kernel":
        kw["kernel"] = (3, 3)
    elif bad == "devices":
        w = torch.zeros(8, 8, 1, 1, device="meta")
    elif bad == "in_scale":
        sc = torch.ones(4)
    with pytest.raises(MXNetError):
        tfc.fused_conv_unit(x, w, sc, **kw)


def test_kernel_backward_names_the_training_slice():
    """The unit's backward exists since the training slice: gradients for
    x, w, in_scale and in_bias, none for shift."""
    x, w, sc, bi, sh = (torch.from_numpy(a).requires_grad_()
                        for a in _inputs(9, (1, 4, 4, 8), 8, (3, 3)))
    y, s1, s2 = tfc.fused_conv_unit(x, w, sc, bi, sh, kernel=(3, 3),
                                    pad=(1, 1), act_in=True)
    (y.sum() + s2.sum()).backward()
    assert all(t.grad is not None and t.grad.abs().sum() > 0
               for t in (x, w, sc, bi))
    assert sh.grad is None


def test_kernel_library_is_built_inside_the_checkout():
    from mxnet_tpu_torch import _kernels

    path = _kernels._lib_path()
    repo = _kernels._PKG.parent
    assert path.parent == repo / "build" / "torch_kernels"
    assert _kernels._tag() in path.name
    assert "arch=compute_90a,code=sm_90a" in _kernels._FLAGS


# ---------------------------------------------------------------------------
# the op-granular ops of the unfused path against ops/nn.py
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("layout", ["NCHW", "NHWC"])
@pytest.mark.parametrize("stride,pad", [((1, 1), (1, 1)), ((2, 2), (0, 0))])
def test_convolution_matches_jax(layout, stride, pad):
    rs = np.random.RandomState(5)
    shape = (2, 6, 7, 7) if layout == "NCHW" else (2, 7, 7, 6)
    x = rs.randn(*shape).astype(np.float32)
    w = rs.randn(4, 6, 3, 3).astype(np.float32)
    b = rs.randn(4).astype(np.float32)
    kw = dict(kernel=(3, 3), stride=stride, pad=pad, num_filter=4,
              layout=layout)
    ref = jnn._convolution(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                           **kw)
    got = tnn.convolution(torch.from_numpy(x), torch.from_numpy(w),
                          torch.from_numpy(b), **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("kernel,stride,pad", [
    ((3, 3), (2, 2), (1, 1)),   # the ResNet stem's MaxPool2D(3, 2, 1)
    ((2, 2), (2, 2), (0, 0)),
])
@pytest.mark.parametrize("layout", ["NCHW", "NHWC"])
def test_pooling_matches_jax(kernel, stride, pad, layout):
    rs = np.random.RandomState(6)
    shape = (2, 3, 9, 9) if layout == "NCHW" else (2, 9, 9, 3)
    x = rs.randn(*shape).astype(np.float32) - 2.0  # -inf padding shows
    kw = dict(kernel=kernel, pool_type="max", stride=stride, pad=pad,
              layout=layout)
    ref = jnn._pooling(jnp.asarray(x), **kw)
    got = tnn.pooling(torch.from_numpy(x), **kw)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    g = tnn.pooling(torch.from_numpy(x), pool_type="avg", global_pool=True,
                    layout=layout)
    r = jnn._pooling(jnp.asarray(x), pool_type="avg", global_pool=True,
                     layout=layout)
    np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-6,
                               atol=1e-6)


@pytest.mark.parametrize("kw", [
    dict(pool_type="bogus", kernel=(2, 2)),
    dict(pool_type="max", kernel=(3,)),
    dict(pool_type="max", kernel=(3, 3), pooling_convention="same"),
    dict(pool_type="avg", kernel=(2, 2, 2)),
])
def test_pooling_rejects_what_is_not_ported(kw):
    with pytest.raises(MXNetError):
        tnn.pooling(torch.zeros(1, 2, 6, 6), **kw)


@pytest.mark.parametrize("train", [False, True])
@pytest.mark.parametrize("exact", [False, True])
def test_batch_norm_matches_jax(train, exact):
    rs = np.random.RandomState(7)
    x = (rs.randn(4, 5, 5, 6) * 3 + 2).astype(np.float32)
    g, b = rs.rand(6).astype(np.float32) + .5, rs.randn(6).astype(np.float32)
    rm, rv = rs.randn(6).astype(np.float32), rs.rand(6).astype(np.float32) + .5
    ref = jnn._batch_norm(*(jnp.asarray(a) for a in (x, g, b, rm, rv)),
                          axis=3, _train=train, exact_var=exact)
    got = tnn.batch_norm(*(torch.from_numpy(a) for a in (x, g, b, rm, rv)),
                         axis=3, train=train, exact_var=exact)
    ref = ref if train else (ref,)
    got = got if train else (got,)
    for r, t in zip(ref, got):
        np.testing.assert_allclose(t.numpy(), np.asarray(r), rtol=1e-5,
                                   atol=1e-5)


def test_fully_connected_and_activation_match_jax():
    rs = np.random.RandomState(8)
    x = rs.randn(3, 2, 2, 4).astype(np.float32)
    w, b = rs.randn(5, 16).astype(np.float32), rs.randn(5).astype(np.float32)
    ref = jnn._fully_connected(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))
    got = tnn.fully_connected(torch.from_numpy(x), torch.from_numpy(w),
                              torch.from_numpy(b))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)
    r = jnn._activation(jnp.asarray(x), act_type="relu")
    t = tnn.activation(torch.from_numpy(x), act_type="relu")
    np.testing.assert_array_equal(t.numpy(), np.asarray(r))
    with pytest.raises(MXNetError):
        tnn.activation(torch.from_numpy(x), act_type="bogus")
