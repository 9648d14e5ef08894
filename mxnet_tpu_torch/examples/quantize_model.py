"""int8 post-training quantization end to end on the port (counterpart
of examples/quantize_model.py; ref: example/quantization/
imagenet_gen_qsym.py + imagenet_inference.py).

Trains a small convnet on synthetic data through the symbolic Module
path, then calibrates and quantizes it with
``contrib.quantization.quantize_model`` and compares float32 and int8
accuracy and time.  The int8 convolutions run the hand-written kernel of
``csrc/int8_conv.cu`` on the card.

Usage:  python -m mxnet_tpu_torch.examples.quantize_model [--cpu]
            [--small] [--calib-mode naive|entropy|none]

It runs on gpu(0) and raises without a CUDA device unless --cpu is
given.  It exits with an error when int8 accuracy drops more than 5%
below float32's.
"""
from __future__ import annotations

import argparse
import time


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--small", action="store_true")
    ap.add_argument("--calib-mode", default="entropy",
                    choices=["none", "naive", "entropy"])
    ap.add_argument("--epochs", type=int, default=3)
    ap.add_argument("--batch-size", type=int, default=64)
    return ap.parse_args(argv)


def main(argv=None):
    """Train, quantize and score; returns a dict of the accuracies, the
    drop, the seconds of each scoring pass and of the quantization."""
    args = parse_args(argv)
    import numpy as np

    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.contrib.quantization import quantize_model

    np.random.seed(0)
    mx.random.seed(0)
    ctx = mx.cpu() if args.cpu else mx.gpu(0)
    size = 16 if args.small else 32
    nclass = 4 if args.small else 10
    if args.small:
        args.epochs, args.batch_size = 2, 32

    # ---- a learnable synthetic image task -------------------------------
    rng = np.random.RandomState(0)
    n = 512 if args.small else 4096

    def make_split(n):
        y = rng.randint(nclass, size=n)
        x = rng.randn(n, 3, size, size).astype("f4") * 0.3
        for i, cls in enumerate(y):  # class-dependent quadrant brightness
            qi, qj = divmod(cls % 4, 2)
            x[i, :, qi * size // 2:(qi + 1) * size // 2,
              qj * size // 2:(qj + 1) * size // 2] += 1.5 + 0.2 * cls
        return x, y.astype("f4")

    xtr, ytr = make_split(n)
    xte, yte = make_split(n // 4)

    # ---- symbolic model + Module.fit ------------------------------------
    data = mx.sym.var("data")
    net = mx.sym.Convolution(data, kernel=(3, 3), num_filter=16,
                             pad=(1, 1), name="conv1")
    net = mx.sym.Activation(net, act_type="relu", name="relu1")
    net = mx.sym.Pooling(net, kernel=(2, 2), stride=(2, 2),
                         pool_type="max", name="pool1")
    net = mx.sym.Convolution(net, kernel=(3, 3), num_filter=32,
                             pad=(1, 1), name="conv2")
    net = mx.sym.Activation(net, act_type="relu", name="relu2")
    net = mx.sym.Pooling(net, global_pool=True, kernel=(1, 1),
                         pool_type="avg", name="gap")
    net = mx.sym.FullyConnected(net, num_hidden=nclass, name="fc")
    net = mx.sym.SoftmaxOutput(net, mx.sym.var("softmax_label"),
                               name="softmax")

    train_iter = mx.io.NDArrayIter(xtr, ytr, args.batch_size,
                                   shuffle=True, label_name="softmax_label")
    val_iter = mx.io.NDArrayIter(xte, yte, args.batch_size,
                                 label_name="softmax_label")
    mod = mx.module.Module(net, context=ctx)
    mod.fit(train_iter, eval_data=val_iter, optimizer="adam",
            optimizer_params={"learning_rate": 3e-3},
            initializer=mx.initializer.Xavier(), num_epoch=args.epochs)
    arg_params, aux_params = mod.get_params()

    def accuracy(sym, params, aux):
        exe = None
        correct = total = 0
        t0 = None  # started after the first batch, which binds
        val_iter.reset()
        for batch in val_iter:
            feed = dict(params, data=batch.data[0].as_in_context(ctx),
                        softmax_label=mx.nd.zeros(
                            (batch.data[0].shape[0],), ctx=ctx))
            if exe is None:
                exe = sym.bind(ctx, feed, grad_req="null",
                               aux_states=dict(aux))
            else:
                exe.copy_params_from({"data": batch.data[0]},
                                     allow_extra_params=True)
            out = exe.forward()[0].asnumpy()
            if t0 is None:
                t0 = time.time()
            pred = out.reshape(out.shape[0], -1).argmax(axis=1)
            lab = batch.label[0].asnumpy().astype(int)
            keep = out.shape[0] - batch.pad
            correct += (pred[:keep] == lab[:keep]).sum()
            total += keep
        return correct / total, time.time() - (t0 or time.time())

    fp32_acc, fp32_t = accuracy(net, arg_params, aux_params)
    print(f"fp32:  accuracy={fp32_acc:.4f}  ({fp32_t:.2f}s)")

    # ---- calibrate + quantize -------------------------------------------
    calib = [mx.nd.array(xtr[i:i + args.batch_size], ctx=ctx)
             for i in range(0, 4 * args.batch_size, args.batch_size)]
    t0 = time.time()
    qsym, qargs, qaux = quantize_model(
        net, arg_params, aux_params, calib_mode=args.calib_mode,
        calib_data=None if args.calib_mode == "none" else calib,
        excluded_sym_names=("fc",))  # keep the tiny head fp32
    quant_s = time.time() - t0
    int8_acc, int8_t = accuracy(qsym, qargs, qaux)
    print(f"int8 ({args.calib_mode}): accuracy={int8_acc:.4f}  "
          f"({int8_t:.2f}s)")
    drop = fp32_acc - int8_acc
    print(f"accuracy drop: {drop:.4f}")
    if drop > 0.05:
        raise SystemExit("int8 accuracy dropped more than 5%")
    return dict(fp32_acc=float(fp32_acc), int8_acc=float(int8_acc),
                drop=float(drop), fp32_s=fp32_t, int8_s=int8_t,
                quantize_s=quant_s, calib_mode=args.calib_mode)


if __name__ == "__main__":
    main()
