"""mxnet_tpu_torch's SSD slice (BASELINE config 4's model, loss, training
and decoding) against the JAX package, on the CPU at small sizes:
batch 2 (4 for the training steps), 128x128 inputs.

Weights go across by structural name (the JAX net's
``_collect_params_with_prefix()`` values, and ``.params`` files both
ways).

* ``ssd_300_mobilenet1.0(classes=3)``, the JAX detection tests' fixture
  (170 anchors at 128²): the inference forward within rtol 1e-4 and
  atol 1e-5 of the JAX package's, the anchors bit for bit, the
  hybridized forward (the port's CachedOp) bit for bit the eager one,
  and ``MultiBoxDetection`` on the JAX outputs identical in both
  packages (kept rows, class ids, scores; boxes within 1e-6).
* An SSD over ``resnet18_v1``'s feature stages (config 4's architecture
  at a smaller depth, 362 anchors) at batch 4: one ``SPMDTrainer`` SGD
  step (momentum 0.9, wd 5e-4, lr 1e-3) with ``SSDMultiBoxLoss`` on
  ``bench_all.py``-style random targets, from warm running means, in
  float64 in both packages (the JAX package under ``jax.enable_x64``),
  held as ``tests/test_torch_compiled_step.py``'s ``_check_against_jax``
  holds a step: the loss within 1e-6 relative, parameters, running
  statistics and momenta within 1e-5 relative + 1e-6 of the tensor's
  largest magnitude (+1e-8); then the port's fp32 step against that
  float64 step (the loss within 1e-6, updates within 5e-2 of a leaf's
  largest magnitude: the step's own fp32 conditioning, see the test).
  Batch 4, not 2: over the two samples of a 1x1 map BatchNorm's backward
  is a cancellation to rounding noise in either package.
* One imperative step as ``examples/ssd_train.py`` takes it
  (``autograd.record()``, ``SSDTargetGenerator``, ``SSDMultiBoxLoss``,
  ``backward``, ``gluon.Trainer.step``) on the same network, float64 in
  both packages and fp32 on the port: class targets and masks
  identical, the loss and every updated weight within the same bounds.
* ``ssd_300_resnet50_v1(classes=20)`` constructed in both packages: the
  same 369 structural names, the shapes the JAX package knows before a
  forward, 30,391,648 values in parameters and statistics, and (port
  only) 2078 anchors at 300².
* The loss in bf16 on quantized predictions whose log-softmax values tie
  across anchors (4 images): the same per-image loss (1e-6) and the same
  kept anchors (positives and hard negatives, read as the anchors whose
  class scores get a gradient) as the JAX package's loss.
* The port's ``examples/ssd_train.py --cpu --small --steps 2`` in a
  subprocess: rc 0, finite losses, no JAX module loaded; and with
  ``--rec`` on a ``.rec`` packed by ``im2rec --pack-label``: it trains,
  and its batches hold the records' boxes.
"""
import os
import subprocess
import sys

import jax
import ml_dtypes
import numpy as np
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu import parallel as jpar
from mxnet_tpu.gluon.block import HybridBlock as JHybridBlock
from mxnet_tpu.gluon.model_zoo import detection as jdet
from mxnet_tpu.gluon.model_zoo.vision import resnet as jres

import mxnet_tpu_torch as mt
from mxnet_tpu_torch import parallel as tpar
from mxnet_tpu_torch.examples import bench_steps as bs
from mxnet_tpu_torch.gluon import ActiveTrace, load_numpy_params
from mxnet_tpu_torch.gluon.model_zoo import detection as tdet
from mxnet_tpu_torch.gluon.model_zoo.vision import resnet as tres

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = mt.cpu()
BATCH, TRAIN_BATCH, SIZE, CLASSES = 2, 4, 128, 3
OPT = {"learning_rate": 1e-3, "momentum": 0.9, "wd": 5e-4}


def _x(seed=0, n=BATCH):
    """Images that differ from each other in brightness and colour: the
    deep features of i.i.d. noise images are nearly equal across a batch,
    and BatchNorm over the few samples of a 1x1 map then divides rounding
    noise by a near-zero spread."""
    rs = np.random.RandomState(seed)
    return (rs.rand(n, 3, SIZE, SIZE) * rs.uniform(0.2, 2, (n, 1, 1, 1))
            + rs.uniform(-1, 1, (n, 3, 1, 1))).astype(np.float32)


def _values(net):
    return {k: p.data().asnumpy().copy()
            for k, p in net._collect_params_with_prefix().items()}


def _close(got, want, what):
    """rtol 1e-5, atol 1e-6 of the tensor's largest magnitude plus 1e-8:
    the floor covers the conv biases behind BatchNorm, whose gradient is
    analytically zero and whose updates are rounding noise (~1e-11) in
    both packages."""
    want = np.asarray(want, np.float64)
    np.testing.assert_allclose(np.asarray(got, np.float64), want, rtol=1e-5,
                               atol=1e-6 * np.abs(want).max() + 1e-8,
                               err_msg=what)


# ---------------------------------------------------------------------------
# (i) ssd_300_mobilenet1.0: forward, anchors, CachedOp, detection
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def mobilenet():
    """The JAX fixture network and its outputs on one batch, and the port
    network with its weights."""
    np.random.seed(0)
    mx.random.seed(0)
    jnet = jdet.get_detection_model("ssd_300_mobilenet1.0", classes=CLASSES)
    jnet.initialize(mx.initializer.Xavier(), ctx=mx.cpu())
    x = _x()
    jnet(mx.nd.array(x))
    jnet.hybridize()
    jout = [o.asnumpy() for o in jnet(mx.nd.array(x))]
    vals = _values(jnet)
    tnet = tdet.get_detection_model("ssd_300_mobilenet1.0", classes=CLASSES)
    tnet.initialize(ctx=CPU)
    load_numpy_params(tnet, vals)
    return jnet, vals, x, jout, tnet


def test_mobilenet_ssd_forward_matches_jax(mobilenet):
    _, vals, x, jout, tnet = mobilenet
    assert list(tnet.state_dict()) == list(vals)
    tout = [o.asnumpy() for o in tnet(mt.nd.array(x, ctx=CPU))]
    assert [o.shape for o in tout] == [(BATCH, 170, CLASSES + 1),
                                       (BATCH, 170, 4), (1, 170, 4)]
    for name, t, j in zip(("cls_preds", "box_preds"), tout, jout):
        np.testing.assert_allclose(t, j, rtol=1e-4, atol=1e-5, err_msg=name)
    np.testing.assert_array_equal(tout[2], jout[2])  # anchors, bit for bit


def test_mobilenet_ssd_hybridized_forward_is_the_eager_one(mobilenet):
    _, _, x, _, tnet = mobilenet
    xs = mt.nd.array(x, ctx=CPU)
    eager = [o._data for o in tnet(xs)]
    tnet.hybridize()
    try:
        for _ in range(2):  # the build, then the cached entry
            hyb = [o._data for o in tnet(xs)]
            assert all(torch.equal(a, b) for a, b in zip(hyb, eager))
    finally:
        tnet.hybridize(False)


@pytest.mark.parametrize("nms_topk", [50, -1])
def test_detection_on_the_jax_outputs(mobilenet, nms_topk):
    _, _, _, jout, _ = mobilenet
    prob = np.exp(jout[0] - jout[0].max(-1, keepdims=True))
    prob = (prob / prob.sum(-1, keepdims=True)).transpose(0, 2, 1)
    loc = jout[1].reshape(BATCH, -1)
    j = mx.nd.MultiBoxDetection(mx.nd.array(prob), mx.nd.array(loc),
                                mx.nd.array(jout[2]),
                                nms_topk=nms_topk).asnumpy()
    t = mt.nd.MultiBoxDetection(*[mt.nd.array(a, ctx=CPU)
                                  for a in (prob, loc, jout[2])],
                                nms_topk=nms_topk).asnumpy()
    kept = t[..., 0] >= 0
    np.testing.assert_array_equal(kept, j[..., 0] >= 0)
    assert 0 < kept.sum() < kept.size
    np.testing.assert_array_equal(t[..., :2], j[..., :2])
    np.testing.assert_allclose(t, j, rtol=1e-6, atol=1e-6)


def test_params_files_move_both_ways(mobilenet, tmp_path):
    jnet, vals, x, _, tnet = mobilenet
    f = str(tmp_path / "jax.params")
    jnet.save_parameters(f)
    back = tdet.get_detection_model("ssd_300_mobilenet1.0", classes=CLASSES)
    back.initialize(ctx=CPU)
    back.load_parameters(f)
    for k, v in back.state_dict().items():
        np.testing.assert_array_equal(v.numpy(), vals[k], err_msg=k)
    f = str(tmp_path / "port.params")
    tnet.save_parameters(f)
    jback = jdet.get_detection_model("ssd_300_mobilenet1.0",
                                     classes=CLASSES)
    jback.initialize(mx.initializer.Xavier(), ctx=mx.cpu())
    jback.load_parameters(f)
    for k, v in _values(jback).items():
        np.testing.assert_array_equal(v, vals[k], err_msg=k)


# ---------------------------------------------------------------------------
# (ii) config 4's step at a smaller depth: SPMDTrainer in both packages
# ---------------------------------------------------------------------------

class _TStep(mt.gluon.HybridBlock):
    """bench_steps.SSDTrainStep over a given detector."""

    def __init__(self, ssd):
        super().__init__()
        self.ssd = ssd
        self.loss = tdet.SSDMultiBoxLoss()

    hybrid_forward = bs.SSDTrainStep.hybrid_forward


class _JStep(JHybridBlock):
    """bench_all.py's config-4 step over a given detector."""

    def __init__(self, ssd):
        super().__init__()
        with self.name_scope():
            self.ssd = ssd
            self.loss = jdet.SSDMultiBoxLoss()

    def hybrid_forward(self, F, x, cls_t, box_t):
        cls_p, box_p, _anchors = self.ssd(x)
        return self.loss(cls_p, box_p, cls_t, box_t)


def _resnet18_ssd(pkg_det, pkg_res):
    return pkg_det._build_ssd(
        pkg_det._resnet_feature_stages(pkg_res.resnet18_v1), 300, CLASSES)


@pytest.fixture(scope="module")
def resnet18_ssd():
    """Weights of the resnet18 SSD (the JAX net's Xavier draw), each
    running mean set to its layer's mean over the batch (one float64 train
    forward of the port from zero means leaves 0.1 x it)."""
    np.random.seed(1)
    mx.random.seed(1)
    jnet = _resnet18_ssd(jdet, jres)
    jnet.initialize(mx.initializer.Xavier(), ctx=mx.cpu())
    x = _x(1, TRAIN_BATCH)
    jnet(mx.nd.array(x))
    vals = _values(jnet)
    warm = _resnet18_ssd(tdet, tres)
    warm.initialize(ctx=CPU)
    load_numpy_params(warm, vals)
    warm.double()
    with torch.no_grad(), ActiveTrace(train=True):
        warm(torch.from_numpy(x).double())
    for k, v in warm.state_dict().items():
        if k.endswith("running_mean"):
            vals[k] = (v.numpy() / 0.1).astype(np.float32)
    n = 362  # 8² and 4² maps x 4 anchors, then 2², 1², 1², 1² x 6
    rs = np.random.RandomState(2)
    cls_t = rs.randint(-1, CLASSES + 1, (TRAIN_BATCH, n)).astype(np.float32)
    box_t = (rs.randn(TRAIN_BATCH, n, 4) * 0.1).astype(np.float32)
    return vals, x, cls_t, box_t


def _jax_net(vals):
    net = _resnet18_ssd(jdet, jres)
    net.initialize(mx.initializer.Xavier(), ctx=mx.cpu())
    net(mx.nd.array(_x(1)[:1]))
    params = net._collect_params_with_prefix()
    for k, p in params.items():
        p.set_data(mx.nd.array(vals[k]))
    return net


def _port_net(vals):
    net = _resnet18_ssd(tdet, tres)
    net.initialize(ctx=CPU)
    load_numpy_params(net, vals)
    return net


def _jax_step64(vals, batch):
    """One float64 SPMDTrainer step of the JAX package (x64 enabled for
    the call only): (loss, {name: param or statistic}, {name: momentum})."""
    with jax.enable_x64(True):
        step = _JStep(_jax_net(vals))
        step.cast("float64")
        with jpar.make_mesh(dp=1):
            tr = jpar.SPMDTrainer(step, bs.Identity(), "sgd", dict(OPT),
                                  n_labels=0)
            loss = float(tr.step(*(a.astype(np.float64) for a in batch))
                         .asnumpy())
        params = step._collect_params_with_prefix()
        state = {k: np.asarray(tr.params[p.name]) for k, p in params.items()}
        mom = {k: np.asarray(tr.opt_state[p.name][0])
               for k, p in params.items() if p.name in tr.opt_state}
    return loss, state, mom


def _port_step(vals, batch, dtype):
    step = _TStep(_port_net(vals))
    step.cast(dtype)
    tr = bs.spmd_trainer(step, OPT["learning_rate"], optimizer="sgd",
                         momentum=OPT["momentum"], wd=OPT["wd"],
                         mesh=tpar.make_mesh(dp=1, devices=[CPU]))
    dt = getattr(torch, dtype)
    loss = float(tr.step(*(torch.from_numpy(a).to(dt) for a in batch)))
    state = {k: v.detach().double().numpy()
             for k, v in step.state_dict(keep_vars=True).items()}
    mom = {k: s[0].double().numpy() for k, s in tr.opt_state.items()}
    return loss, state, mom


_STEP64 = {}


def _step64(resnet18_ssd):
    if not _STEP64:
        vals, x, cls_t, box_t = resnet18_ssd
        _STEP64["jax"] = _jax_step64(vals, (x, cls_t, box_t))
    return _STEP64["jax"]


def test_spmd_trainer_step_matches_jax_float64(resnet18_ssd):
    """The same step in float64 in both packages: every parameter,
    running statistic and momentum by _check_against_jax's bounds."""
    vals, x, cls_t, box_t = resnet18_ssd
    jl, js, jm = _step64(resnet18_ssd)
    tl, ts, tm = _port_step(vals, (x, cls_t, box_t), "float64")
    np.testing.assert_allclose(tl, jl, rtol=1e-6)
    assert set(ts) == set(js) and set(tm) == set(jm)
    for k in js:
        _close(ts[k], js[k], k)
    for k in jm:
        _close(tm[k], jm[k], f"momentum {k}")


def test_spmd_trainer_fp32_step_lands_on_the_float64_step(resnet18_ssd):
    """The port's fp32 step against the JAX package's float64 step: the
    loss within 1e-6, every momentum (the update) within 5e-2 of the
    leaf's largest magnitude.  The step is ill-conditioned at this size
    (BatchNorm over the few samples of the 2x2 and 1x1 maps): a 2^-24
    relative perturbation of the images moves the JAX package's own fp32
    update of stage 2's second block by 1.7% of its largest magnitude,
    and the port's fp32 update lands 1.7% from float64 there; the JAX
    package's fp32 step lands 22% from its float64 step on stage 3's
    first convolution (its fp32 reductions cancel in BatchNorm's
    backward), where the port's lands within 1e-4.  The float64 test
    above holds the two steps' arithmetic."""
    vals, x, cls_t, box_t = resnet18_ssd
    jl, _, jm = _step64(resnet18_ssd)
    tl, _, tm = _port_step(vals, (x, cls_t, box_t), "float32")
    np.testing.assert_allclose(tl, jl, rtol=1e-6)
    for k in jm:
        np.testing.assert_allclose(tm[k], jm[k], rtol=0,
                                   atol=5e-2 * np.abs(jm[k]).max() + 1e-8,
                                   err_msg=f"momentum {k}")


# ---------------------------------------------------------------------------
# (iii) the imperative step of examples/ssd_train.py
# ---------------------------------------------------------------------------

def _imperative_step(pkg, net, x, labels, dtype="float32"):
    """autograd.record() -> net -> SSDTargetGenerator -> SSDMultiBoxLoss
    -> backward -> gluon.Trainer.step, hybridized, as the example; returns
    the loss, the class targets and masks."""
    det = jdet if pkg is mx else tdet
    ctx = {} if pkg is mx else {"ctx": CPU}
    net.cast(dtype)
    net.hybridize()
    trainer = pkg.gluon.Trainer(net.collect_params(), "sgd", dict(OPT))
    target_gen, loss_fn = det.SSDTargetGenerator(), det.SSDMultiBoxLoss()
    xs = pkg.nd.array(x, dtype=dtype, **ctx)
    ls = pkg.nd.array(labels, **ctx)
    with pkg.autograd.record():
        cls_preds, box_preds, anchors = net(xs)
        box_t, box_m, cls_t = target_gen(anchors, ls, cls_preds)
        loss = loss_fn(cls_preds, box_preds, cls_t, box_t)
    loss.backward()
    trainer.step(TRAIN_BATCH)
    return loss.asnumpy(), cls_t.asnumpy(), box_m.asnumpy()


def test_imperative_step_matches_jax(resnet18_ssd):
    """float64 in both packages (class targets and masks identical, the
    loss within 1e-6, every updated weight by _check_against_jax's
    bounds), then the port's fp32 step (the example's dtype) against
    it: identical targets, the loss within 1e-6, the updates within 5e-2
    of each leaf's largest magnitude (the SPMDTrainer step's bound
    above)."""
    vals, x, _, _ = resnet18_ssd
    rs = np.random.RandomState(0)
    labels = np.stack([[[rs.randint(CLASSES), 0.2, 0.2, 0.7, 0.7]]
                       for _ in range(TRAIN_BATCH)]).astype(np.float32)
    with jax.enable_x64(True):
        jnet = _jax_net(vals)
        jl, jc, jm = _imperative_step(mx, jnet, x, labels, "float64")
        jw = {k: v - vals[k] for k, v in _values(jnet).items()}
    for dtype in ("float64", "float32"):
        tnet = _port_net(vals)
        tl, tc, tm = _imperative_step(mt, tnet, x, labels, dtype)
        np.testing.assert_array_equal(tc, jc)
        np.testing.assert_array_equal(tm, jm)
        assert (tc > 0).any()
        np.testing.assert_allclose(tl, jl, rtol=1e-6)
        tp = {k: v.double().numpy() for k, v in tnet.state_dict().items()}
        for k, want in jw.items():
            got = tp[k] - vals[k]
            if dtype == "float64":
                _close(got, want, f"update {k}")
            elif "running" in k:  # statistics: their values, fp32-rounded
                _close(tp[k], vals[k] + want, f"fp32 {k}")
            else:
                np.testing.assert_allclose(
                    got, want, rtol=0, atol=5e-2 * np.abs(want).max() + 1e-8,
                    err_msg=f"fp32 update {k}")


# ---------------------------------------------------------------------------
# (iv) ssd_300_resnet50_v1 constructed in both packages
# ---------------------------------------------------------------------------

def test_ssd_resnet50_constructs_as_the_jax_package():
    jp = jdet.ssd_300_resnet50_v1(classes=20)._collect_params_with_prefix()
    step = bs.ssd_step("cpu_smoke")
    tp = step.ssd.state_dict()
    assert list(tp) == list(jp) and len(tp) == 369
    for k, p in jp.items():  # 0: a shape the JAX package defers
        assert all(a in (0, b) for a, b in zip(p.shape, tp[k].shape)), k
    assert sum(v.numel() for v in tp.values()) == 30391648


def test_config4_cpu_smoke_step_on_the_port():
    """bench_all.py's --cpu-smoke config 4 on the port alone (the JAX
    step at this size compiles for minutes): batch 1 at 300², 2078
    anchors, one SPMDTrainer SGD step with a finite loss that moves the
    weights."""
    step = bs.init_step(bs.ssd_step("cpu_smoke"), mt.init.Xavier(), ctx=CPU)
    x, cls_t, box_t = bs.ssd_batch("cpu_smoke", ctx=CPU)
    assert cls_t.shape == (1, 2078) and box_t.shape == (1, 2078, 4)
    with torch.no_grad():
        _, _, anchors = step.ssd(mt.nd.array(x.numpy(), ctx=CPU))
    assert anchors.shape == (1, bs.SSD_SIZES["full"]["anchors"], 4)
    w0 = step.ssd.class_predictors[0].predictor.weight.data().asnumpy()
    tr = bs.spmd_trainer(step, mesh=tpar.make_mesh(dp=1, devices=[CPU]),
                         **bs.SSD_OPT)
    loss = float(tr.step(x, cls_t, box_t))
    assert np.isfinite(loss) and loss > 0
    assert not np.array_equal(
        w0, step.ssd.class_predictors[0].predictor.weight.data().asnumpy())


# ---------------------------------------------------------------------------
# (v) bf16 loss on tied predictions: the same hard negatives
# ---------------------------------------------------------------------------

def _kept_anchors(pkg, cls_pred, box_pred, cls_t, box_t):
    """The per-image loss and the anchors whose class scores get a
    gradient (the positives and the kept hard negatives)."""
    det = jdet if pkg is mx else tdet
    ctx = {} if pkg is mx else {"ctx": CPU}
    cp = pkg.nd.array(cls_pred, **ctx)
    cp.attach_grad()
    args = [pkg.nd.array(a, **ctx) for a in (box_pred, cls_t, box_t)]
    with pkg.autograd.record():
        loss = det.SSDMultiBoxLoss()(cp, *args)
    loss.backward()
    g = cp.grad.asnumpy().astype(np.float32)
    return loss.asnumpy(), (g != 0).any(-1)


def test_bf16_loss_keeps_the_jax_hard_negatives():
    """Four images of 2078 anchors: the bf16 log-probabilities must be
    the JAX package's bit for bit (XLA sums the exponentials in fp32
    unrounded; rounding each op in bf16 instead keeps 6 other anchors
    and moves the loss by 3e-4)."""
    rs = np.random.RandomState(3)
    b, n = TRAIN_BATCH, 2078
    # logits on a coarse grid: the bf16 log-softmax values tie by the
    # hundreds among the negatives
    cls_pred = (rs.randint(-4, 5, (b, n, CLASSES + 1)) / 2.0).astype(
        ml_dtypes.bfloat16)
    box_pred = (rs.randn(b, n, 4) * 0.1).astype(ml_dtypes.bfloat16)
    cls_t = np.where(rs.rand(b, n) < 0.05,
                     rs.randint(1, CLASSES + 1, (b, n)),
                     rs.randint(-1, 1, (b, n))).astype(np.float32)
    box_t = (rs.randn(b, n, 4) * 0.1).astype(np.float32)
    jl, jk = _kept_anchors(mx, cls_pred, box_pred, cls_t, box_t)
    tl, tk = _kept_anchors(mt, cls_pred, box_pred, cls_t, box_t)
    pos = (cls_t > 0).sum(1)
    assert (tk.sum(1) == 4 * pos).all()  # positives + 3x hard negatives
    np.testing.assert_array_equal(tk, jk)
    np.testing.assert_allclose(tl, jl, rtol=1e-6)


# ---------------------------------------------------------------------------
# (vi) the example, in a process of its own
# ---------------------------------------------------------------------------

def test_ssd_example_runs_on_the_cpu_without_jax():
    code = ("import runpy, sys; sys.argv = ['ssd_train', '--cpu', "
            "'--small', '--steps', '2', '--batch-size', '2']; "
            "runpy.run_module('mxnet_tpu_torch.examples.ssd_train', "
            "run_name='__main__'); "
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith(('jax.', 'mxnet_tpu.')) or m == 'mxnet_tpu']; "
            "print('jax modules:', bad); sys.exit(1 if bad else 0)")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=REPO, timeout=300)
    assert res.returncode == 0, (res.returncode, res.stdout[-2000:],
                                 res.stderr[-2000:])
    losses = [float(line.split("loss=")[1].split()[0])
              for line in res.stdout.splitlines() if "loss=" in line]
    assert len(losses) == 2 and np.isfinite(losses).all(), res.stdout
    assert "decoded (2, 170, 6) detections" in res.stdout


def test_ssd_example_trains_on_a_packed_detection_rec(tmp_path):
    """``--rec`` over a .rec packed by ``im2rec --pack-label`` from a
    .lst of object labels: two steps with finite losses, and the boxes of
    the first batch are the records' (or their mirror images)."""
    import cv2

    from mxnet_tpu_torch import recordio as trio
    from mxnet_tpu_torch.examples import ssd_train
    from mxnet_tpu_torch.tools import im2rec

    def _photo(h, w, seed):
        img = np.random.RandomState(seed).randint(0, 255, (h, w, 3),
                                                  np.uint8)
        return cv2.GaussianBlur(img, (5, 5), 2)

    rs = np.random.RandomState(5)
    rows = []
    for i in range(6):
        cv2.imwrite(str(tmp_path / f"{i}.jpg"), _photo(48, 40, 60 + i))
        k = 1 + i % 2
        xy = rs.uniform(0.05, 0.5, (k, 2))
        objs = np.concatenate([rs.randint(0, 3, (k, 1)), xy,
                               xy + rs.uniform(0.1, 0.4, (k, 2))], 1)
        label = "\t".join(f"{v:.4f}" for v in [2, 5] + list(objs.ravel()))
        rows.append(f"{i}\t{label}\t{i}.jpg\n")
    (tmp_path / "det.lst").write_text("".join(rows))
    prefix = str(tmp_path / "det")
    assert im2rec.main([prefix, str(tmp_path), "--pack-label",
                        "--num-thread", "2"]) == 0
    keep = {}
    losses = ssd_train.main(["--cpu", "--small", "--rec", prefix + ".rec",
                             "--batch-size", "3", "--classes", "3"],
                            keep=keep)
    assert len(losses) == 2 and np.isfinite(losses).all()
    got = keep["rec_labels"][0]
    assert got.shape == (3, 2, 5)
    r = trio.MXIndexedRecordIO(prefix + ".idx", prefix + ".rec", "r")
    for row in range(3):
        h, _ = trio.unpack(r.read_idx(row))
        objs = np.asarray(h.label[2:], np.float32).reshape(-1, 5)
        mirrored = objs.copy()
        mirrored[:, 1], mirrored[:, 3] = 1 - objs[:, 3], 1 - objs[:, 1]
        k = objs.shape[0]
        assert (np.array_equal(got[row, :k], objs)
                or np.allclose(got[row, :k], mirrored, atol=1e-6))
        assert (got[row, k:] == -1).all()
