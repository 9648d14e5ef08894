"""mxnet_tpu_torch's detection ops and the tensor ops SSD needs, against
the JAX package, op by op on the CPU.

The same numpy inputs (from a seed) go through ``mxnet_tpu.nd`` and
``mxnet_tpu_torch.nd``.  Discrete outputs must be identical: the
indices of ``argsort``/``sort``/``topk`` on inputs with ties (``-0.0``
and ``+0.0`` among them), ``MultiBoxTarget``'s class targets and masks,
the rows NMS keeps with their class ids and order, the matches of
``bipartite_matching``.  ``MultiBoxPrior``'s anchors must be bit for bit
the JAX op's.  Floating outputs that pass through a division, ``exp`` or
``log`` (IoU, box targets, decoded boxes, softmax) must lie within 1e-6
(relative and absolute): the last bit of a transcendental depends on
the library.  The cases of ``tests/test_contrib_ops.py`` (overlap
matching, the force match with two ground truths sharing a best anchor,
padded -1 label rows, hard-negative mining with its IoU gate) run here
through both packages, and both NMS branches (K <= 1024 and K > 1024)
with tied scores, ``force_suppress``, ``background_id``, ``nms_topk`` and
the box formats.
"""
import numpy as np
import pytest

import jax.numpy as jnp

import mxnet_tpu as mx
from mxnet_tpu.ops import nn as jnn

import mxnet_tpu_torch as mt

CPU = mt.cpu()


def _run(name, *arrays, **kw):
    """One op through both packages' ``nd`` namespaces: numpy outputs
    (a list for several), JAX first."""
    j = getattr(mx.nd, name)(*[mx.nd.array(a) for a in arrays], **kw)
    t = getattr(mt.nd, name)(*[mt.nd.array(a, ctx=CPU) for a in arrays],
                             **kw)
    if isinstance(j, (list, tuple)):
        return [o.asnumpy() for o in j], [o.asnumpy() for o in t]
    return j.asnumpy(), t.asnumpy()


def _exact(j, t, what=""):
    assert t.dtype == j.dtype and t.shape == j.shape, (what, t.dtype, j.dtype,
                                                       t.shape, j.shape)
    np.testing.assert_array_equal(t, j, err_msg=what)


def _close(j, t, what="", tol=1e-6):
    assert t.dtype == j.dtype and t.shape == j.shape, (what, t.dtype, j.dtype)
    np.testing.assert_allclose(t, j, rtol=tol, atol=tol, err_msg=what)


def _boxes(rs, n, lo=0.0, span=0.6, size=0.4):
    xy = rs.uniform(lo, lo + span, (n, 2))
    wh = rs.uniform(0.05, size, (n, 2))
    return np.concatenate([xy, xy + wh], -1).astype(np.float32)


# ---------------------------------------------------------------------------
# box_iou, MultiBoxPrior
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fmt", ["corner", "center"])
def test_box_iou(fmt):
    rs = np.random.RandomState(0)
    a, b = _boxes(rs, 7), _boxes(rs, 5)
    a[3] = b[1]          # an IoU of exactly 1
    a[4] = [2, 2, 3, 3]  # and one of exactly 0
    j, t = _run("box_iou", a, b, format=fmt)
    _close(j, t, fmt)
    j, t = _run("_contrib_box_iou", a.reshape(7, 1, 4), b[None], format=fmt)
    assert t.shape == (7, 1, 1, 5)
    _close(j, t, fmt)


@pytest.mark.parametrize("h,w,sizes,ratios", [
    (4, 4, (0.5, 0.25), (1, 2)),
    (5, 3, (0.2, 0.3), (1, 2, 0.5, 3, 1.0 / 3)),
    (19, 19, (0.1, 0.141), (1, 2, 0.5)),
    (3, 3, (0.71, 0.79), (1, 2, 0.5, 3, 1.0 / 3)),
    (7, 10, (0.37, 0.2), (1, 3)), (1, 1, (0.88, 0.961), (1, 2))])
@pytest.mark.parametrize("clip", [False, True])
def test_multibox_prior_bit_for_bit(h, w, sizes, ratios, clip):
    data = np.zeros((1, 3, h, w), np.float32)
    j, t = _run("MultiBoxPrior", data, sizes=sizes, ratios=ratios, clip=clip)
    assert t.shape == (1, h * w * (len(sizes) + len(ratios) - 1), 4)
    _exact(j, t)


def test_multibox_prior_one_anchor_a_pixel():
    """One anchor a pixel (one size, one ratio): XLA's CPU backend then
    contracts the y centre's product and the half-height into one FMA, so
    the JAX op's y coordinates skip the rounding of the centre at some
    rows (40 of 280 coordinates on a 7x10 map); the x coordinates, and
    every coordinate with two or more anchors a pixel (SSD's four or
    six), are not contracted.  The port computes the written arithmetic:
    x bit for bit, y within 2^-23, one float32 ulp at 1.0 (the centre's
    rounding plus the result's)."""
    data = np.zeros((1, 3, 7, 10), np.float32)
    j, t = _run("MultiBoxPrior", data, sizes=(0.37,), ratios=(1,))
    _exact(j[..., 0::2], t[..., 0::2], "x")
    np.testing.assert_allclose(t[..., 1::2], j[..., 1::2], rtol=0,
                               atol=2.0 ** -23)


def test_multibox_prior_steps_and_offsets():
    data = np.zeros((2, 8, 6, 9), np.float32)
    j, t = _run("_contrib_MultiBoxPrior", data, sizes=(0.3, 0.6),
                ratios=(1, 2), steps=(0.15, 0.1), offsets=(0.25, 0.75))
    _exact(j, t)


# ---------------------------------------------------------------------------
# MultiBoxTarget
# ---------------------------------------------------------------------------

def _target(anchors, label, cls_pred, **kw):
    (jb, jm, jc), (tb, tm, tc) = _run("MultiBoxTarget", anchors, label,
                                      cls_pred, **kw)
    _exact(jc, tc, "cls_target")
    _exact(jm, tm, "box_mask")
    _close(jb, tb, "box_target")
    return tc, tm, tb


def test_multibox_target_overlap_matching_and_padded_rows():
    anchors = np.array([[[0.0, 0.0, 0.5, 0.5], [0.5, 0.5, 1.0, 1.0],
                         [0.0, 0.5, 0.5, 1.0], [0.4, 0.4, 0.6, 0.6]]],
                       np.float32)
    label = np.array([[[1, 0.05, 0.05, 0.45, 0.45],
                       [-1, -1, -1, -1, -1]]], np.float32)
    ct, bm, _ = _target(anchors, label, np.zeros((1, 3, 4), np.float32))
    assert ct[0].tolist() == [2.0, 0.0, 0.0, 0.0]
    assert bm[0].reshape(4, 4).sum(1).tolist() == [4.0, 0.0, 0.0, 0.0]


def test_multibox_target_force_match_of_gts_sharing_a_best_anchor():
    anchors = np.array([[[0.0, 0.0, 1.0, 1.0], [0.0, 0.0, 0.4, 1.0]]],
                       np.float32)
    label = np.array([[[1, 0.0, 0.0, 0.9, 1.0], [0, 0.0, 0.0, 0.8, 1.0]]],
                     np.float32)
    ct, bm, _ = _target(anchors, label, np.zeros((1, 3, 2), np.float32),
                        overlap_threshold=0.95)
    assert ct[0].tolist() == [2.0, 1.0]
    assert bm.sum() == 8.0


def test_multibox_target_negative_mining_iou_gate():
    anchors = np.array([[[0.0, 0.1, 0.5, 0.6], [0.0, 0.0, 0.5, 0.5],
                         [0.8, 0.8, 1.0, 1.0]]], np.float32)
    label = np.array([[[0, 0.0, 0.1, 0.5, 0.6]]], np.float32)
    cls_pred = np.zeros((1, 2, 3), np.float32)
    cls_pred[0, 1, 1] = 20.0
    ct, _, _ = _target(anchors, label, cls_pred, overlap_threshold=0.7,
                       negative_mining_ratio=1.0,
                       negative_mining_thresh=0.5)
    assert ct[0].tolist() == [1.0, -1.0, 0.0]


@pytest.mark.parametrize("mining", [-1.0, 1.0, 3.0])
def test_multibox_target_batch_with_padding_and_mining(mining):
    """Three images over 5x5 and 3x3 maps (136 anchors), up to four
    ground truths padded with -1 rows (one image has a single gt, two
    gts share a best anchor in another), random class scores with ties
    in the background log-loss."""
    rs = np.random.RandomState(5)
    anchors = np.concatenate([
        _run("MultiBoxPrior", np.zeros((1, 1, h, h), np.float32),
             sizes=(0.3, 0.5), ratios=(1, 2, 0.5), clip=True)[0]
        for h in (5, 3)], 1)
    n = anchors.shape[1]
    label = np.full((3, 4, 5), -1.0, np.float32)
    for b, m in enumerate((4, 1, 3)):
        label[b, :m, 0] = rs.randint(0, 3, m)
        label[b, :m, 1:] = _boxes(rs, m, span=0.5, size=0.5)
    label[2, 1, 1:] = label[2, 0, 1:] + 0.01  # two gts, one best anchor
    cls_pred = np.round(rs.randn(3, 4, n), 1).astype(np.float32)
    ct, bm, _ = _target(anchors, label, cls_pred, overlap_threshold=0.5,
                        negative_mining_ratio=mining,
                        negative_mining_thresh=0.5,
                        minimum_negative_samples=2)
    assert (ct > 0).any() and ((ct == -1).any() == (mining > 0))


# ---------------------------------------------------------------------------
# MultiBoxDetection and box_nms: both NMS branches
# ---------------------------------------------------------------------------

def _detection_inputs(seed, h, b=2, classes=3, quant=8):
    """Anchors of an h x h map (4 a pixel, overlapping), box offsets,
    and class probabilities rounded to 1/quant so that scores tie."""
    rs = np.random.RandomState(seed)
    anchors = _run("MultiBoxPrior", np.zeros((1, 1, h, h), np.float32),
                   sizes=(0.2, 0.35), ratios=(1, 2, 0.5), clip=True)[0]
    n = anchors.shape[1]
    p = rs.dirichlet(np.ones(classes + 1), (b, n)).transpose(0, 2, 1)
    p = (np.round(p * quant) / quant).astype(np.float32)
    loc = (rs.randn(b, n * 4) * 0.5).astype(np.float32)
    return p, loc, anchors


@pytest.mark.parametrize("h", [6, 17])  # 144 and 1156 candidates
@pytest.mark.parametrize("kw", [
    {}, {"force_suppress": True}, {"background_id": 2},
    {"nms_topk": 50, "nms_threshold": 0.3}, {"threshold": 0.2, "clip": False},
    {"variances": (0.2, 0.2, 0.1, 0.1), "nms_threshold": 0.7}])
def test_multibox_detection(h, kw):
    p, loc, anchors = _detection_inputs(h, h)
    j, t = _run("MultiBoxDetection", p, loc, anchors, **kw)
    assert t.shape == (2, anchors.shape[1], 6)
    kept_j, kept_t = j[..., 0] >= 0, t[..., 0] >= 0
    np.testing.assert_array_equal(kept_t, kept_j)
    assert kept_t.sum() > 0 and (~kept_t).sum() > 0
    _exact(j[..., :2], t[..., :2], "class ids and scores")
    _close(j, t, "boxes")


@pytest.mark.parametrize("n", [40, 1030])
@pytest.mark.parametrize("kw", [
    {"force_suppress": True}, {"id_index": 0},
    {"id_index": 0, "topk": 25, "valid_thresh": 0.25},
    {"in_format": "center", "out_format": "corner", "overlap_thresh": 0.3},
    {"in_format": "corner", "out_format": "center", "id_index": 0},
    {"in_format": "center", "out_format": "center", "force_suppress": True}])
def test_box_nms(n, kw):
    rs = np.random.RandomState(n)
    data = np.zeros((2, n, 6), np.float32)
    data[..., 0] = rs.randint(0, 3, (2, n))
    data[..., 1] = np.round(rs.rand(2, n) * 8) / 8  # tied scores
    data[..., 2:] = _boxes(rs, 2 * n, span=0.7, size=0.3).reshape(2, n, 4)
    j, t = _run("box_nms", data, **kw)
    np.testing.assert_array_equal(t[..., 0] >= 0, j[..., 0] >= 0)
    kept = t[..., 0] >= 0
    assert kept.sum() > 0 and (~kept).sum() > 0
    _exact(j[..., :2], t[..., :2], "ids and scores")
    _close(j, t, "boxes")


# ---------------------------------------------------------------------------
# bipartite matching, box codecs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kw", [
    {"threshold": 0.05}, {"is_ascend": True, "threshold": 0.5},
    {"topk": 2, "threshold": 0.0}])
def test_bipartite_matching(kw):
    rs = np.random.RandomState(1)
    dist = (np.round(rs.rand(2, 6, 4) * 6) / 6).astype(np.float32)  # ties
    (jr, jc), (tr, tc) = _run("bipartite_matching", dist, **kw)
    _exact(jr, tr, "rows")
    _exact(jc, tc, "cols")
    (jr, jc), (tr, tc) = _run("_contrib_bipartite_matching",
                              np.array([[0.9, 0.1], [0.8, 0.7], [0.2, 0.6]],
                                       np.float32), threshold=0.05)
    assert tr.tolist() == [0.0, 1.0, -1.0] and tc.tolist() == [0.0, 1.0]


def test_box_encode_decode():
    rs = np.random.RandomState(2)
    anchors = _boxes(rs, 2 * 6).reshape(2, 6, 4)
    refs = _boxes(rs, 2 * 3).reshape(2, 3, 4)
    samples = rs.randint(-1, 2, (2, 6)).astype(np.float32)
    matches = rs.randint(0, 3, (2, 6)).astype(np.float32)
    (jt, jm), (tt, tm) = _run("box_encode", samples, matches, anchors, refs)
    _exact(jm, tm, "mask")
    _close(jt, tt, "targets")
    (jt, jm), (tt, tm) = _run("_contrib_box_encode", samples, matches,
                              anchors, refs, means=(0.1, 0.0, 0.0, -0.1),
                              stds=(0.2, 0.2, 0.3, 0.3))
    _close(jt, tt, "targets, means and stds")
    deltas = (rs.randn(2, 6, 4) * 0.3).astype(np.float32)
    for kw in ({}, {"std0": 0.1, "std1": 0.1, "std2": 0.2, "std3": 0.2,
                    "clip": 0.8}):
        j, t = _run("box_decode", deltas, anchors, **kw)
        _close(j, t, str(kw))
    j, t = _run("_contrib_box_decode", deltas, anchors[:1], format="center")
    _close(j, t, "center, broadcast anchors")


# ---------------------------------------------------------------------------
# the tensor ops of SSD's loss and decoder
# ---------------------------------------------------------------------------

TIES = np.array([[0.0, -0.0, 1.5, 0.0, 1.5, -2.0, -0.0, 1.5],
                 [3.0, 3.0, -1.0, 3.0, 0.5, -1.0, 0.5, 0.0]], np.float32)


@pytest.mark.parametrize("axis", [-1, 0])
@pytest.mark.parametrize("is_ascend", [True, False])
def test_ordering_ops_keep_the_jax_order_of_ties(axis, is_ascend):
    rs = np.random.RandomState(4)
    quant = (np.round(rs.randn(5, 9) * 2) / 2).astype(np.float32)
    for x in (TIES, quant):
        j, t = _run("argsort", x, axis=axis, is_ascend=is_ascend)
        _exact(j, t, "argsort")
        j, t = _run("sort", x, axis=axis, is_ascend=is_ascend)
        _exact(j.view(np.uint32), t.view(np.uint32), "sort (bits)")
        for k in (1, min(3, x.shape[axis])):
            j, t = _run("topk", x, axis=axis, k=k, is_ascend=is_ascend)
            _exact(j, t, f"topk k={k}")
            (jv, ji), (tv, ti) = _run("topk", x, axis=axis, k=k,
                                      is_ascend=is_ascend, ret_typ="both")
            _exact(ji, ti, f"topk both k={k}")
            _exact(jv.view(np.uint32), tv.view(np.uint32), "topk values")
    j, t = _run("argsort", TIES, dtype="int32")
    _exact(j, t, "int32 indices")


def test_argsort_of_argsort_ranks_bf16_ties_as_jax():
    """The loss's rank: argsort(argsort(s, is_ascend=False)) on scores
    rounded to bf16 and promoted, with many exact ties."""
    rs = np.random.RandomState(7)
    s = rs.randn(3, 300).astype(np.float32)
    jb = mx.nd.array(s).astype("bfloat16").astype("float32")
    tb = mt.nd.array(s, ctx=CPU).astype("bfloat16").astype("float32")
    np.testing.assert_array_equal(tb.asnumpy(), jb.asnumpy())
    jr = mx.nd.argsort(mx.nd.argsort(jb, axis=1, is_ascend=False), axis=1)
    tr = mt.nd.argsort(mt.nd.argsort(tb, axis=1, is_ascend=False), axis=1)
    _exact(jr.asnumpy(), tr.asnumpy())


@pytest.mark.parametrize("name,arrays,kw", [
    ("smooth_l1", ("x",), {}), ("smooth_l1", ("x",), {"scalar": 2.0}),
    ("clip", ("x",), {"a_min": -0.5, "a_max": 1.0}),
    ("clip", ("x",), {"a_min": 0, "a_max": 6}),
    ("softmax", ("x",), {}), ("softmax", ("x",), {"axis": 0}),
    ("softmax", ("x",), {"temperature": 2.0}),
    ("softmax", ("x", "length"), {}),
    ("zeros_like", ("x",), {}), ("ones_like", ("x",), {}),
    ("broadcast_maximum", ("x", "y"), {}),
    ("broadcast_minimum", ("x", "row"), {}),
    ("exp", ("x",), {}), ("log", ("p",), {}), ("sqrt", ("p",), {})])
def test_loss_and_decoder_tensor_ops(name, arrays, kw):
    rs = np.random.RandomState(6)
    vals = {"x": (rs.randn(4, 7) * 3).astype(np.float32),
            "y": rs.randn(4, 7).astype(np.float32),
            "row": rs.randn(1, 7).astype(np.float32),
            "p": rs.uniform(0.01, 5, (4, 7)).astype(np.float32),
            "length": np.array([7, 3, 1, 5], np.float32)}
    args = [vals[a] for a in arrays]
    if "length" in arrays:
        # the JAX package's nd wrapper binds a keyword array to the first
        # attribute (axis), so its op is called directly
        j = np.asarray(jnn._softmax(jnp.asarray(args[0]),
                                    length=jnp.asarray(args[1])))
        t = mt.nd.softmax(mt.nd.array(args[0], ctx=CPU),
                          length=mt.nd.array(args[1], ctx=CPU)).asnumpy()
        assert (t[1, 3:] == 0).all()
    else:
        j, t = _run(name, *args, **kw)
    _close(j, t, name)
