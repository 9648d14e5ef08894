"""The rest of the JAX package's nn ops against ``mxnet_tpu`` on the CPU.

Every op name added from ``mxnet_tpu/ops/nn.py`` (24: RMSNorm,
UpSampling, BilinearSampler, GridGenerator, SpatialTransformer,
hard_sigmoid, hard_swish, mish, SoftmaxActivation, SVMOutput,
im2col/col2im, Correlation, DeformableConvolution, with their aliases)
on its case's seeded inputs through both registries, forward and
gradient, held by the case's class (``torch_parity``); then the options
each case does not reach: nearest and several-input UpSampling, the warp
grid, SVMOutput's L1 hinge and its ignoring of the upstream gradient,
im2col over one and three spatial axes with dilation, col2im as
im2col's adjoint, Correlation's absolute difference, SoftmaxActivation
over channels, DeformableConvolution with stride, dilation and bias,
and the refusals both packages share.
"""
import numpy as np
import pytest
import torch

import mxnet_tpu_torch as mt
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.ops import nn as tnn

import torch_parity as tp

NN = ("RMSNorm rms_norm UpSampling upsampling BilinearSampler "
      "bilinear_sampler GridGenerator grid_generator SpatialTransformer "
      "spatial_transformer hard_sigmoid hard_swish mish SoftmaxActivation "
      "softmax_activation SVMOutput svm_output im2col col2im Correlation "
      "correlation _contrib_DeformableConvolution DeformableConvolution "
      "deformable_convolution").split()


def test_the_slice_count():
    assert len(NN) == 24


@pytest.mark.parametrize("name", NN)
def test_op_matches_jax(name):
    tp.hold_case(name)


RS = np.random.RandomState(21)


def _f(*shape, lo=-2.0, hi=2.0):
    return RS.uniform(lo, hi, shape).astype(np.float32)


def _hold(name, arrays, attrs, kind="sum", n=16, grad=True):
    t_outs, _ = tp.port_run(name, arrays, attrs)
    cts = tp.cotangents(t_outs) if grad else None
    j_outs, j_grads = tp.jax_run(name, arrays, attrs, cts)
    t_outs, t_grads = tp.port_run(name, arrays, attrs, cts)
    for t, j in zip(t_outs, j_outs):
        tp.hold_array(kind, t, j, n=n, what=f"{name} {attrs}")
    assert len(t_grads) == len(j_grads)
    for t, j in zip(t_grads, j_grads):
        tp.hold_array("sum", t, j, n=n, what=f"{name} {attrs} gradient")
    return t_outs


@pytest.mark.parametrize("attrs,shapes", [
    ({"scale": 2}, [(1, 2, 3, 3)]),
    ({"scale": 3, "num_args": 2}, [(1, 2, 2, 2), (1, 1, 6, 6)]),
    ({"scale": 2, "num_args": 2, "multi_input_mode": "sum"},
     [(1, 2, 3, 3), (1, 2, 6, 6)]),
    ({"scale": 3, "sample_type": "bilinear"}, [(2, 2, 4, 3)]),
])
def test_upsampling_modes(attrs, shapes):
    out = _hold("UpSampling", [_f(*s) for s in shapes], attrs, n=4)
    assert out[0].shape[2] == shapes[0][2] * attrs["scale"]


def test_grid_generator_warp_and_bilinear_sampler_outside():
    flow = _f(2, 2, 4, 5, lo=-1.5, hi=1.5)
    _hold("GridGenerator", [flow], {"transform_type": "warp"}, n=3)
    grid = _f(2, 2, 3, 4, lo=-1.6, hi=1.6)   # some taps fall outside
    _hold("BilinearSampler", [_f(2, 3, 4, 5), grid], {}, n=4)


@pytest.mark.parametrize("attrs", [
    {}, {"use_linear": True, "margin": 0.5},
    {"regularization_coefficient": 0.3}])
def test_svm_output_backward_is_the_hinge_gradient(attrs):
    """The backward ignores the upstream gradient, as the JAX op's."""
    data = _f(6, 4)
    label = np.array([0, 3, 1, 1, 2, 7], np.float32)  # 7: a zero row
    _hold("SVMOutput", [data, label], attrs, n=4)
    x = mt.nd.array(data, ctx=tp.CPU)
    x.attach_grad()
    with mt.autograd.record():
        y = mt.nd.SVMOutput(x, mt.nd.array(label, ctx=tp.CPU), **attrs)
    y.backward(mt.nd.array(np.full(data.shape, 5.0, np.float32),
                           ctx=tp.CPU))
    g1 = x.grad.asnumpy()
    with mt.autograd.record():
        y = mt.nd.SVMOutput(x, mt.nd.array(label, ctx=tp.CPU), **attrs)
    y.backward()
    np.testing.assert_array_equal(x.grad.asnumpy(), g1)


@pytest.mark.parametrize("shape,attrs", [
    ((2, 3, 9), {"kernel": (3,), "stride": (2,), "dilate": (2,),
                 "pad": (1,)}),
    ((1, 2, 6, 7), {"kernel": (2, 3), "dilate": (2, 1), "pad": (1, 1)}),
    ((1, 2, 4, 5, 4), {"kernel": (2, 2, 3), "stride": (1, 2, 1),
                       "pad": (0, 1, 1)}),
])
def test_im2col_and_col2im_over_any_rank(shape, attrs):
    x = _f(*shape)
    (cols,) = _hold("im2col", [x], attrs, kind="exact")
    y = _f(*cols.shape)
    _hold("col2im", [y], dict(attrs, output_size=shape[2:]), n=12)
    # col2im is im2col's adjoint: <im2col(x), y> = <x, col2im(y)>
    t_img = tnn.col2im(torch.from_numpy(y), output_size=shape[2:],
                       **attrs).double()
    lhs = float((torch.from_numpy(cols).double()
                 * torch.from_numpy(y).double()).sum())
    rhs = float((torch.from_numpy(x).double() * t_img).sum())
    assert abs(lhs - rhs) <= 1e-5 * (abs(lhs) + 1)


def test_correlation_absolute_difference_and_softmax_over_channels():
    a, b = _f(2, 3, 5, 6), _f(2, 3, 5, 6)
    _hold("Correlation", [a, b], {"max_displacement": 2, "pad_size": 2,
                                  "is_multiply": False}, n=3)
    _hold("SoftmaxActivation", [_f(2, 4, 3)], {"mode": "channel"}, n=4)


def test_deformable_convolution_with_stride_dilation_and_bias():
    data = _f(2, 3, 7, 6)
    attrs = {"kernel": (3, 2), "stride": (2, 1), "dilate": (1, 2),
             "pad": (1, 1), "num_filter": 4}
    ho = (7 + 2 - 3) // 2 + 1
    wo = (6 + 2 - (2 * 1 + 1)) // 1 + 1
    offset = _f(2, 12, ho, wo, lo=-1.2, hi=1.2)
    _hold("DeformableConvolution",
          [data, offset, _f(4, 3, 3, 2), _f(4)], attrs, n=18)
    _hold("DeformableConvolution",
          [data, offset, _f(4, 3, 3, 2)], dict(attrs, no_bias=True), n=18)


def test_the_refusals_the_packages_share():
    x = mt.nd.array(_f(1, 2, 4, 4), ctx=tp.CPU)
    with pytest.raises(MXNetError, match="kernel_size=1"):
        mt.nd.Correlation(x, x, kernel_size=3)
    with pytest.raises(MXNetError, match="offset must be"):
        mt.nd.DeformableConvolution(
            x, mt.nd.array(_f(1, 18, 4, 4), ctx=tp.CPU),
            mt.nd.array(_f(2, 2, 3, 3), ctx=tp.CPU), kernel=(3, 3),
            num_filter=2)
    with pytest.raises(MXNetError, match="affine"):
        mt.nd.SpatialTransformer(x, mt.nd.array(_f(1, 6), ctx=tp.CPU),
                                 target_shape=(2, 2), transform_type="warp")
    with pytest.raises(MXNetError, match="sample_type"):
        mt.nd.UpSampling(x, scale=2, sample_type="cubic")
