"""SSD training through MXNet's imperative loop on the port (counterpart
of examples/ssd_train.py, BASELINE config 4): SSD model ->
SSDTargetGenerator (MultiBoxTarget) -> SSDMultiBoxLoss ->
loss.backward() -> gluon.Trainer.step, then MultiBoxDetection with greedy
NMS on the last batch.

Usage:  python -m mxnet_tpu_torch.examples.ssd_train [--cpu] [--small]
            [--batch-size B] [--steps N] [--classes C] [--no-hybridize]
            [--rec FILE.rec [--epochs E]]

It trains on gpu(0) and raises without a CUDA device unless --cpu is
given.  --small takes the MobileNet backbone at 128 pixels, the
ResNet-50 one at 300 otherwise.  Without --rec it trains --steps steps
on one synthetic batch; with --rec it trains --epochs epochs over a
RecordIO file of object labels (``tools/im2rec.py --pack-label``: each
record's label ``[2, 5, cls, xmin, ymin, xmax, ymax, ...]`` in relative
corner coordinates), decoded by ``image.ImageDetIter`` with
``CreateDetAugmenter`` (resize, random mirror, ImageNet
normalization).
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
                    help=".rec file with im2rec --pack-label object "
                         "labels (the real-data path via ImageDetIter)")
    ap.add_argument("--epochs", type=int, default=1)
    return ap.parse_args(argv)


def main(argv=None, keep=None):
    """Train (``--steps`` steps, or ``--epochs`` over ``--rec``) and
    decode the last batch; returns the losses (one mean a step).
    ``keep``, a dict, receives the net, the trainer, the outputs of the
    last step, the decoded detections and, under ``--rec``, each batch's
    labels."""
    args = parse_args(argv)
    import numpy as np

    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import autograd, nd
    from mxnet_tpu_torch.gluon import Trainer
    from mxnet_tpu_torch.gluon.model_zoo.detection import (
        SSDMultiBoxLoss, SSDTargetGenerator, get_detection_model)

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

    rec_labels = []
    if args.rec:
        from mxnet_tpu_torch.image import CreateDetAugmenter, ImageDetIter

        it = ImageDetIter(
            batch_size=args.batch_size, data_shape=(3, size, size),
            path_imgrec=args.rec,
            aug_list=CreateDetAugmenter((3, size, size), rand_mirror=True,
                                        mean=True, std=True))
        step = 0
        for _ in range(args.epochs):
            it.reset()
            for batch in it:
                # the packed labels are [cls, x1, y1, x2, y2] in relative
                # corner coordinates: the target generator's format
                rec_labels.append(batch.label[0].asnumpy())
                x = batch.data[0].as_in_context(ctx)
                labels = batch.label[0].as_in_context(ctx)
                cls_preds, box_preds, anchors = train_step(x, labels, step)
                step += 1
    else:
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
                    detections=out, step_s=step_s, rec_labels=rec_labels)
    return losses


if __name__ == "__main__":
    main()
