"""ImageNet-format training on the port: im2rec shards -> the native
decode pipeline (``io.ImageRecordIter``) -> ResNet-50 v1 through
``parallel.SPMDTrainer`` (counterpart of examples/imagenet_train.py, the
reference's example/image-classification/train_imagenet.py).

Usage:  python -m mxnet_tpu_torch.examples.imagenet_train [--cpu]
            [--rec-prefix PREFIX | --synthetic-data] [--classes C]
            [--per-class M] [--image-size S] [--batch-size B]
            [--epochs E] [--lr LR] [--dtype bfloat16]
            [--preprocess-threads T]

Without --rec-prefix it builds a fake ImageNet tree first (C classes x
M JPEGs of (S + 32)², quality 90, from a seed) and packs it with the
port's im2rec (a shuffled list, the short edge resized to S + 16), so
the whole flow runs anywhere; point --rec-prefix at real shards for the
full run:

    python -m mxnet_tpu_torch.tools.im2rec imagenet /data/train --list \\
        --recursive
    python -m mxnet_tpu_torch.tools.im2rec imagenet /data/train \\
        --resize 256 --num-thread 16
    python -m mxnet_tpu_torch.examples.imagenet_train \\
        --rec-prefix imagenet --batch-size 256 --image-size 224

The iterator shuffles through the .idx, crops S² at random from the
short edge resized to S + 8, mirrors at random and normalizes by the
ImageNet statistics, and hands out float32 NCHW batches on the CPU.
The batch is copied to the card as it is, and permuted to NHWC and cast
to --dtype there (:func:`device_batch`).  It trains on gpu(0) and raises
without a CUDA device unless --cpu is given.
"""
from __future__ import annotations

import argparse
import os
import tempfile
import time

import numpy as np
import torch

MEAN = (123.68, 116.78, 103.94)
STD = (58.4, 57.12, 57.38)


def make_synthetic_imagenet(root: str, classes: int, per_class: int,
                            size: int, seed: int = 0) -> None:
    """``classes`` folders of ``per_class`` random smoothed JPEGs each
    (quality 90), the JAX example's tree for the same arguments."""
    import cv2

    rng = np.random.RandomState(seed)
    for c in range(classes):
        d = os.path.join(root, f"class_{c:03d}")
        os.makedirs(d, exist_ok=True)
        for i in range(per_class):
            img = rng.randint(0, 255, (size, size, 3), np.uint8)
            img = cv2.GaussianBlur(img, (5, 5), 2)
            cv2.imwrite(os.path.join(d, f"{i}.jpg"), img,
                        [cv2.IMWRITE_JPEG_QUALITY, 90])


def pack_with_im2rec(prefix: str, root: str, resize: int,
                     threads: int) -> None:
    """``prefix.lst`` (shuffled, labelled by folder), then ``prefix.rec``
    and ``.idx`` with the short edge resized to ``resize``."""
    from mxnet_tpu_torch.tools import im2rec

    for extra in (["--list", "--recursive", "--shuffle"],
                  ["--resize", str(resize), "--num-thread", str(threads)]):
        if im2rec.main([prefix, root] + extra) != 0:
            raise RuntimeError(f"im2rec {' '.join(extra)} failed")


def train_iter(prefix: str, hw: int, batch_size: int, threads: int,
               seed: int = 0):
    from mxnet_tpu_torch.io import ImageRecordIter

    return ImageRecordIter(
        path_imgrec=prefix + ".rec", path_imgidx=prefix + ".idx",
        data_shape=(3, hw, hw), batch_size=batch_size, shuffle=True,
        rand_crop=True, rand_mirror=True, resize=hw + 8,
        mean_r=MEAN[0], mean_g=MEAN[1], mean_b=MEAN[2],
        std_r=STD[0], std_g=STD[1], std_b=STD[2],
        preprocess_threads=threads, seed=seed)


def device_batch(batch, device, dtype):
    """A float32 NCHW batch on the CPU -> (NHWC ``dtype`` images, int32
    labels) on ``device``.  The copy moves the host's bits; the permute
    is exact and the cast rounds to nearest even, so the values equal a
    host-side transpose and cast."""
    x = batch.data[0]._data.to(device)
    y = batch.label[0]._data.to(device)
    return (x.permute(0, 2, 3, 1).to(dtype).contiguous(),
            y.to(torch.int32))


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--rec-prefix", default=None,
                    help="prefix of .rec/.idx shards (from im2rec)")
    ap.add_argument("--synthetic-data", action="store_true",
                    help="build and pack a fake ImageNet tree first")
    ap.add_argument("--classes", type=int, default=10)
    ap.add_argument("--per-class", type=int, default=32)
    ap.add_argument("--image-size", type=int, default=64)
    ap.add_argument("--batch-size", type=int, default=32)
    ap.add_argument("--epochs", type=int, default=1)
    ap.add_argument("--lr", type=float, default=0.05)
    ap.add_argument("--dtype", default="bfloat16")
    ap.add_argument("--preprocess-threads", type=int,
                    default=os.cpu_count() or 1)
    ap.add_argument("--workdir", default=None,
                    help="where the synthetic tree and shards go "
                         "(default: a new temporary directory)")
    return ap.parse_args(argv)


def main(argv=None, keep=None):
    """Train; returns one record an epoch: images, seconds, data-wait
    seconds (the host clock inside ``next()``), the host-to-device copy's
    ms a batch, the losses and the labels in the order they came.
    ``keep``, a dict, receives the net, the trainer, the iterator and the
    shard prefix."""
    args = parse_args(argv)
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import parallel
    from mxnet_tpu_torch.base import dtype_of
    from mxnet_tpu_torch.gluon import loss as gloss
    from mxnet_tpu_torch.gluon.model_zoo import vision

    ctx = mx.cpu() if args.cpu else mx.gpu(0)
    dev = ctx.torch_device
    hw = args.image_size
    prefix = args.rec_prefix
    if args.synthetic_data or prefix is None:
        work = args.workdir or tempfile.mkdtemp(prefix="imagenet_synth_")
        root = os.path.join(work, "train")
        os.makedirs(root, exist_ok=True)
        print(f"building synthetic ImageNet tree under {root} ...")
        make_synthetic_imagenet(root, args.classes, args.per_class, hw + 32)
        prefix = os.path.join(work, "synth")
        pack_with_im2rec(prefix, root, hw + 16, args.preprocess_threads)
    it = train_iter(prefix, hw, args.batch_size, args.preprocess_threads)
    print(f"data pipeline: {it.route}"
          + (f" ({it.route_reason})" if it.route_reason else ""))

    net = vision.resnet50_v1(classes=args.classes, layout="NHWC")
    net.initialize(mx.initializer.Xavier(magnitude=2.0), ctx=ctx)
    dtype = dtype_of(args.dtype)
    if dtype != torch.float32:
        net.cast(args.dtype)
    net.hybridize()
    trainer = parallel.SPMDTrainer(
        net, gloss.SoftmaxCrossEntropyLoss(), "sgd",
        {"learning_rate": args.lr, "momentum": 0.9, "wd": 1e-4},
        mesh=parallel.make_mesh(dp=1, devices=[ctx]))
    cuda = dev.type == "cuda"
    epochs = []
    for epoch in range(args.epochs):
        it.reset()
        losses, labels, copies = [], [], []
        n, wait = 0, 0.0
        if cuda:
            torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        while True:
            tw = time.perf_counter()
            try:
                batch = it.next()
            except StopIteration:
                break
            wait += time.perf_counter() - tw
            labels.append(batch.label[0].asnumpy())
            if cuda:
                ev = (torch.cuda.Event(enable_timing=True),
                      torch.cuda.Event(enable_timing=True))
                ev[0].record()
                x, y = device_batch(batch, dev, dtype)
                ev[1].record()
                copies.append(ev)
            else:
                tc = time.perf_counter()
                x, y = device_batch(batch, dev, dtype)
                copies.append((time.perf_counter() - tc) * 1e3)
            losses.append(trainer.step(x, y))
            n += args.batch_size - batch.pad
        if cuda:
            torch.cuda.synchronize(dev)
            copies = [a.elapsed_time(b) for a, b in copies]
        dt = time.perf_counter() - t0
        rec = dict(images=n, seconds=dt, wait_s=wait, steps=len(losses),
                   copy_ms=copies, losses=[float(v) for v in losses],
                   labels=np.concatenate(labels))
        epochs.append(rec)
        print(f"epoch {epoch}: {n} images, {n / dt:.1f} img/s end to end, "
              f"data wait {wait / dt:.1%}, copy "
              f"{np.mean(copies):.2f} ms a batch, loss "
              f"{np.mean(rec['losses']):.4f}")
        if not np.isfinite(rec["losses"]).all():
            raise FloatingPointError(f"epoch {epoch}: a loss is not finite")
    if keep is not None:
        keep.update(net=net, trainer=trainer, iter=it, prefix=prefix)
    print("done")
    return epochs


if __name__ == "__main__":
    main()
