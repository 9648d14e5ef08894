"""SSD training on synthetic data through MXNet's imperative loop on the
port (counterpart of examples/ssd_train.py, BASELINE config 4): SSD
model -> SSDTargetGenerator (MultiBoxTarget) -> SSDMultiBoxLoss ->
loss.backward() -> gluon.Trainer.step, then MultiBoxDetection with greedy
NMS on the last batch.

Usage:  python -m mxnet_tpu_torch.examples.ssd_train [--cpu] [--small]
            [--batch-size B] [--steps N] [--classes C] [--no-hybridize]

It trains on gpu(0) and raises without a CUDA device unless --cpu is
given.  --small takes the MobileNet backbone at 128 pixels, the
ResNet-50 one at 300 otherwise.  --rec (RecordIO shards decoded by
ImageDetIter) raises: the detection data pipeline is not ported.
"""
from __future__ import annotations

import argparse
import time


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--small", action="store_true",
                    help="mobilenet backbone, 128px, for smoke tests")
    ap.add_argument("--batch-size", type=int, default=8)
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--classes", type=int, default=20)
    ap.add_argument("--no-hybridize", action="store_true")
    ap.add_argument("--rec", default=None,
                    help=".rec file with im2rec --pack-label object labels "
                         "(not ported)")
    return ap.parse_args(argv)


def main(argv=None, keep=None):
    """Train ``--steps`` steps and decode the last batch; returns the
    losses (one mean a step).  ``keep``, a dict, receives the net, the
    trainer, the outputs of the last step and the decoded detections."""
    args = parse_args(argv)
    import numpy as np

    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import autograd, nd
    from mxnet_tpu_torch.base import MXNetError
    from mxnet_tpu_torch.gluon import Trainer
    from mxnet_tpu_torch.gluon.model_zoo.detection import (
        SSDMultiBoxLoss, SSDTargetGenerator, get_detection_model)

    if args.rec:
        raise MXNetError("--rec: ImageDetIter and the RecordIO detection "
                         "pipeline are not ported (ROADMAP queue A item 8)")
    ctx = mx.cpu() if args.cpu else mx.gpu(0)
    size = 128 if args.small else 300
    name = "ssd_300_mobilenet1.0" if args.small else "ssd_300_resnet50_v1"
    net = get_detection_model(name, classes=args.classes)
    net.initialize(mx.initializer.Xavier(), ctx=ctx)
    if not args.no_hybridize:
        net.hybridize(static_alloc=True)

    target_gen = SSDTargetGenerator()
    loss_fn = SSDMultiBoxLoss()
    trainer = Trainer(net.collect_params(), "sgd",
                      {"learning_rate": 1e-3, "momentum": 0.9, "wd": 5e-4})
    losses, step_s = [], []

    def train_step(x, labels, step):
        tic = time.time()
        with autograd.record():
            cls_preds, box_preds, anchors = net(x)
            box_t, _box_m, cls_t = target_gen(anchors, labels, cls_preds)
            loss = loss_fn(cls_preds, box_preds, cls_t, box_t)
        loss.backward()
        trainer.step(args.batch_size)
        lval = float(loss.asnumpy().mean())
        losses.append(lval)
        step_s.append(time.time() - tic)
        print(f"step {step}: loss={lval:.4f} ({time.time() - tic:.2f}s)")
        return cls_preds, box_preds, anchors

    rng = np.random.RandomState(0)
    x = nd.array(
        rng.randn(args.batch_size, 3, size, size).astype("float32"),
        ctx=ctx)
    labels = nd.array(
        np.stack([[[rng.randint(args.classes), 0.2, 0.2, 0.7, 0.7]]
                  for _ in range(args.batch_size)]).astype("float32"),
        ctx=ctx)
    for step in range(args.steps):
        cls_preds, box_preds, anchors = train_step(x, labels, step)

    # decode detections for the final batch
    out = nd.MultiBoxDetection(
        nd.transpose(nd.softmax(cls_preds, axis=-1), axes=(0, 2, 1)),
        nd.reshape(box_preds, shape=(0, -1)), anchors, nms_topk=100)
    kept = (out.asnumpy()[:, :, 0] >= 0).sum()
    print(f"decoded {out.shape} detections, {kept} kept after NMS")
    if keep is not None:
        keep.update(net=net, trainer=trainer, outputs=(cls_preds, box_preds,
                                                       anchors),
                    detections=out, step_s=step_s)
    return losses


if __name__ == "__main__":
    main()
