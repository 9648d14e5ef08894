"""The port's R-CNN family and vision contrib ops against the JAX package
on the CPU, on the same numpy inputs (from a seed).

* ROIPooling, ROIAlign (plain, ``aligned``, ``position_sensitive``,
  sample ratios 1-3), PSROIPooling, BilinearResize2D (size, scale and
  like modes), AdaptiveAvgPooling2D (the exact and the integral-image
  paths): float32 forward and the gradient of every float input under a
  seeded cotangent within 1e-5 of the output's (the gradient's) largest
  magnitude; ROIPooling's values equal, and its gradient on ties (ReLU
  zeros: an even split over the bin's maxima) within 2^-22 relative;
  roi corners rounded half to even, as ``jnp.round``.
* fft/ifft (interleaved re/im, ``ifft`` unnormalised) within 1e-5·d.
* ``boolean_mask`` equal; it has no shape without data (meta tensors).
* Proposal / MultiProposal: both NMS branches (K <= 1024 and > 1024),
  tied scores, ``output_score``, batch 2 with two image sizes and
  scales: the kept rows, their order and scores equal, the boxes within
  1e-5 relative (XLA's CPU backend may contract ``d·w + x`` into one
  FMA).  The NMS loop with the +1 offset against JAX's
  ``_greedy_nms_keep`` bit for bit, and ``_corner_iou`` with it.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mxnet_tpu.ops import contrib as jcontrib

import mxnet_tpu_torch as mt
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.ops import contrib as tcontrib

import torch_parity as tp


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread while this file runs (the other workers hold
    the cores), restored after it."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _rois(rs, n, b, w, h):
    x1 = rs.uniform(-2, w, n)
    y1 = rs.uniform(-2, h, n)
    x2 = x1 + rs.uniform(0, w, n)
    y2 = y1 + rs.uniform(0, h, n)
    return np.stack([rs.randint(0, b, n), x1, y1, x2, y2], 1).astype(
        np.float32)


def _hold_grad(name, arrays, attrs, tol=1e-5):
    """Forward and gradient of every float input within tol of the
    largest magnitude of each."""
    j, _ = tp.jax_run(name, arrays, attrs)
    cts = tp.cotangents(j)
    j, jg = tp.jax_run(name, arrays, attrs, cts)
    t, tg = tp.port_run(name, arrays, attrs, cts)
    for a, b in list(zip(j, t)) + list(zip(jg, tg)):
        assert a.shape == b.shape and a.dtype == b.dtype, (name, attrs)
        np.testing.assert_allclose(
            b, a, rtol=0, atol=tol * max(float(np.abs(a).max(initial=0)),
                                         1e-30), err_msg=f"{name} {attrs}")
    return j, t, jg, tg


ROI_CASES = [
    ("ROIPooling", dict(pooled_size=(3, 2), spatial_scale=0.5)),
    ("ROIPooling", dict(pooled_size=(4, 4), spatial_scale=1.0)),
    ("roi_pooling", dict(pooled_size=(2, 3), spatial_scale=0.25)),
    ("ROIAlign", dict(pooled_size=(3, 2), spatial_scale=0.5)),
    ("ROIAlign", dict(pooled_size=(3, 3), spatial_scale=0.5, aligned=True,
                      sample_ratio=3)),
    ("_contrib_ROIAlign", dict(pooled_size=(3, 3), spatial_scale=0.5,
                               position_sensitive=True, sample_ratio=1)),
    ("_contrib_ROIAlign", dict(pooled_size=(2, 3), spatial_scale=0.5,
                               position_sensitive=True, aligned=True)),
    ("PSROIPooling", dict(pooled_size=3, output_dim=2, spatial_scale=0.5)),
    ("_contrib_PSROIPooling", dict(pooled_size=3, output_dim=2,
                                   group_size=3, spatial_scale=1.0)),
]


@pytest.mark.parametrize("name,attrs", ROI_CASES,
                         ids=[f"{n}-{i}" for i, (n, _) in
                              enumerate(ROI_CASES)])
def test_roi_ops(name, attrs):
    rs = np.random.RandomState(0)
    data = rs.randn(2, 18, 9, 11).astype(np.float32)
    rois = _rois(rs, 7, 2, 22, 18)
    j, t, _, _ = _hold_grad(name, [data, rois], attrs)
    if "Pooling" in name or name == "roi_pooling":
        if "PS" not in name:
            np.testing.assert_array_equal(t[0], j[0])


def test_roi_pooling_ties_and_half_rounding():
    """ReLU zeros tie within bins: the gradient splits evenly over a
    bin's maxima, as the JAX op's; corners at .5 round to even."""
    rs = np.random.RandomState(1)
    data = np.maximum(rs.randn(1, 3, 8, 8), 0).astype(np.float32)
    data[0, 1] = 0.0
    rois = np.array([[0, 0.5, 1.5, 6.5, 5.5], [0, 2.5, 0.5, 7.5, 7.5],
                     [0, 1.0, 1.0, 1.0, 1.0]], np.float32)
    j, t, jg, tg = _hold_grad("ROIPooling", [data, rois],
                              dict(pooled_size=(2, 2), spatial_scale=1.0),
                              tol=2.0 ** -22)
    np.testing.assert_array_equal(t[0], j[0])
    assert 0 < np.abs(tg[0][0, 1]).sum()


def test_roi_align_refuses_position_sensitive_channels():
    x = mt.nd.zeros((1, 10, 4, 4), ctx=tp.CPU)
    r = mt.nd.array(np.array([[0, 0, 0, 2, 2]], np.float32), ctx=tp.CPU)
    with pytest.raises(MXNetError, match="divisible"):
        mt.nd.ROIAlign(x, r, pooled_size=(2, 2), position_sensitive=True)
    with pytest.raises(MXNetError, match="output_dim"):
        mt.nd.PSROIPooling(x, r, pooled_size=2, output_dim=3)
    with pytest.raises(MXNetError, match="group_size"):
        mt.nd.PSROIPooling(x, r, pooled_size=2, output_dim=3, group_size=1)


@pytest.mark.parametrize("attrs", [
    dict(height=9, width=4), dict(height=5, width=7),
    dict(scale_height=2.0, scale_width=0.5), dict(height=1, width=1)])
def test_bilinear_resize(attrs):
    x = np.random.RandomState(2).randn(2, 3, 5, 7).astype(np.float32)
    _hold_grad("BilinearResize2D", [x], attrs)


def test_bilinear_resize_like_and_refusals():
    rs = np.random.RandomState(3)
    x = rs.randn(1, 2, 4, 6).astype(np.float32)
    like = rs.randn(1, 1, 7, 3).astype(np.float32)
    _hold_grad("_contrib_BilinearResize2D", [x, like], dict(mode="like"))
    xt = mt.nd.array(x, ctx=tp.CPU)
    with pytest.raises(MXNetError, match="not implemented"):
        mt.nd.BilinearResize2D(xt, height=3, width=3, mode="odd_scale")
    with pytest.raises(MXNetError, match="positive"):
        mt.nd.BilinearResize2D(xt, height=0, width=3)


@pytest.mark.parametrize("size", [(), 1, (2,), (3, 4), (5, 7), (2, 3)])
def test_adaptive_avg_pooling(size):
    x = np.random.RandomState(4).randn(2, 3, 5, 7).astype(np.float32)
    _hold_grad("AdaptiveAvgPooling2D", [x], dict(output_size=size))


def test_fft_ifft():
    rs = np.random.RandomState(5)
    d = rs.randn(3, 16).astype(np.float32)
    _hold_grad("fft", [d], {}, tol=1e-5 * 16)
    e = rs.randn(2, 3, 32).astype(np.float32)
    _hold_grad("_contrib_ifft", [e], {}, tol=1e-5 * 16)
    spec = mt.nd.contrib.fft(mt.nd.array(d, ctx=tp.CPU))
    back = mt.nd.contrib.ifft(spec).asnumpy() / 16
    np.testing.assert_allclose(back, d, atol=1e-5)


@pytest.mark.parametrize("axis,index", [
    (0, [1, 0, 2, 0, 0.5]), (1, [0, 1, 1]), (0, [0, 0, 0, 0, 0])])
def test_boolean_mask(axis, index):
    rs = np.random.RandomState(6)
    data = rs.randn(5, 3).astype(np.float32)
    idx = np.asarray(index, np.float32)
    (j,), _ = tp.jax_run("boolean_mask", [data, idx], {"axis": axis})
    (t,), _ = tp.port_run("_contrib_boolean_mask", [data, idx],
                          {"axis": axis})
    assert t.shape == j.shape
    np.testing.assert_array_equal(t, j)


def test_boolean_mask_has_no_static_shape():
    x = torch.zeros(4, 2, device="meta")
    with pytest.raises(NotImplementedError):
        tcontrib.boolean_mask(x, torch.ones(4, device="meta"))


PROPOSAL_CASES = [
    # (batch, H, W, pre, post, extra attrs): K = H·W·12
    (1, 4, 5, 6000, 50, {}),                                  # K = 240
    (1, 10, 10, 6000, 300, {}),                               # K = 1200
    (2, 6, 7, 100, 30, dict(output_score=True)),
    (2, 10, 9, 2000, 300, dict(output_score=True, threshold=0.5)),
]


@pytest.mark.parametrize("b,h,w,pre,post,extra", PROPOSAL_CASES)
def test_proposal(b, h, w, pre, post, extra):
    rs = np.random.RandomState(7)
    a = 12
    attrs = dict(extra, scales=(2, 4, 8, 16), ratios=(0.5, 1, 2),
                 rpn_pre_nms_top_n=pre, rpn_post_nms_top_n=post,
                 rpn_min_size=4)
    cls = np.round(rs.rand(b, 2 * a, h, w) * 8).astype(np.float32) / 8
    bbox = (rs.randn(b, 4 * a, h, w) * 0.2).astype(np.float32)
    info = np.array([[h * 16, w * 16, 1.0],
                     [h * 16 - 7, w * 16 - 3, 0.8]][:b], np.float32)
    name = "Proposal" if b == 1 else "MultiProposal"
    j, _ = tp.jax_run(name, [cls, bbox, info], attrs)
    t, _ = tp.port_run("_contrib_" + name, [cls, bbox, info], attrs)
    assert len(j) == len(t) == (2 if extra.get("output_score") else 1)
    np.testing.assert_array_equal(t[0][:, 0], j[0][:, 0])
    kept_j, kept_t = j[0][:, 1:].any(1), t[0][:, 1:].any(1)
    np.testing.assert_array_equal(kept_t, kept_j)
    assert kept_j.sum() > post // 4
    np.testing.assert_allclose(t[0], j[0], rtol=1e-5, atol=1e-5)
    if len(j) == 2:
        np.testing.assert_array_equal(t[1], j[1])


def test_proposal_refusals():
    z = mt.nd.zeros((1, 6, 2, 2), ctx=tp.CPU)
    info = mt.nd.array(np.array([[32, 32, 1]], np.float32), ctx=tp.CPU)
    with pytest.raises(MXNetError, match="anchors per cell"):
        mt.nd.contrib.Proposal(z, mt.nd.zeros((1, 12, 2, 2), ctx=tp.CPU),
                               info)
    with pytest.raises(MXNetError, match="iou_loss"):
        mt.nd.contrib.Proposal(z, mt.nd.zeros((1, 12, 2, 2), ctx=tp.CPU),
                               info, iou_loss=True)


@pytest.mark.parametrize("k,force", [(60, True), (60, False),
                                     (1100, True)])
def test_nms_loop_with_the_offset_is_jax_bit_for_bit(k, force):
    rs = np.random.RandomState(8)
    xy = rs.uniform(0, 60, (k, 2))
    boxes = np.concatenate([xy, xy + rs.uniform(0, 20, (k, 2))],
                           1).astype(np.float32)
    scores = np.sort(np.round(rs.rand(k) * 6) / 6)[::-1].astype(np.float32)
    ids = rs.randint(0, 3, k).astype(np.float32)
    j = np.asarray(jcontrib._greedy_nms_keep(
        jnp.asarray(boxes), jnp.asarray(scores), jnp.asarray(ids), 0.4,
        force, iou_off=1.0))
    t = tcontrib.greedy_nms_keep(torch.from_numpy(boxes)[None],
                                 torch.from_numpy(scores)[None],
                                 torch.from_numpy(ids)[None],
                                 tcontrib._f32(0.4), force, off=1.0)
    np.testing.assert_array_equal(t[0].numpy(), j)
    assert 0 < j.sum() < (scores > 0).sum()
    jiou = np.asarray(jcontrib._corner_iou(jnp.asarray(boxes[:50]),
                                           jnp.asarray(boxes[:40]), 1.0))
    tiou = tcontrib._corner_iou(torch.from_numpy(boxes[:50]),
                                torch.from_numpy(boxes[:40]), 1.0).numpy()
    np.testing.assert_array_equal(tiou, jiou)


def test_nms_loop_counts_its_runs_by_device():
    tcontrib.reset_nms_loop_runs()
    b = torch.rand(1, 5, 4)
    tcontrib.greedy_nms_keep(b, torch.rand(1, 5), torch.zeros(1, 5), 0.5,
                             True)
    assert tcontrib.nms_loop_runs() == {"cpu": 1}
    tcontrib.reset_nms_loop_runs()
    assert tcontrib.nms_loop_runs() == {}
