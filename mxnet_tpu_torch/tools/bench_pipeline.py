"""The image data pipeline alone: decode + augment images/s on a
synthetic RecordIO shard (the port's copy of the JAX package's
``tools/bench_pipeline.py``).

    python -m mxnet_tpu_torch.tools.bench_pipeline [--images 512]
        [--size 256] [--crop 224] [--resize 256] [--batch 64]
        [--threads 1 2 4 8] [--python-baseline]

It packs ``--images`` random smoothed JPEGs (``--size``² at
``--quality``) into a shard, then reads one epoch through the native
pipeline (``lib.NativeImagePipeline``: resize the short edge to
``--resize``, random crop, random mirror, uint8 NHWC) at each thread
count, and, with ``--python-baseline``, through
``io.ImageRecordIter``'s Python route (``MXNET_USE_NATIVE=0`` for that
run, the same threads decoding) at the same augmentation and float32
NCHW.  Decoding is host work: the rates are the host's, and
scale with its cores.  The last line is one JSON object.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time
from contextlib import contextmanager

import numpy as np


def make_shard(path_prefix: str, n: int, size: int, quality: int,
               seed: int = 0) -> str:
    """``n`` random images smoothed like photographs, JPEG-encoded at
    ``quality``, labels i % 1000; returns the ``.rec`` path (the ``.idx``
    beside it)."""
    import cv2

    from mxnet_tpu_torch import recordio

    rng = np.random.RandomState(seed)
    rec = recordio.MXIndexedRecordIO(
        path_prefix + ".idx", path_prefix + ".rec", "w")
    try:
        for i in range(n):
            img = rng.randint(0, 255, (size, size, 3), np.uint8)
            img = cv2.GaussianBlur(img, (7, 7), 3)
            ok, buf = cv2.imencode(".jpg", img,
                                   [cv2.IMWRITE_JPEG_QUALITY, quality])
            if not ok:
                raise IOError("cv2.imencode failed")
            rec.write_idx(i, recordio.pack(
                recordio.IRHeader(0, float(i % 1000), i, 0), buf.tobytes()))
    finally:
        rec.close()
    return path_prefix + ".rec"


def native_rate(rec: str, idx: str, batch: int, hw: int, threads: int,
                resize: int) -> float:
    """Images/s of one epoch through the native pipeline."""
    from mxnet_tpu_torch import lib

    pipe = lib.NativeImagePipeline(
        rec, idx, batch=batch, channels=3, height=hw, width=hw,
        label_width=1, threads=threads, rand_crop=True, rand_mirror=True,
        resize_short=resize)
    try:
        n = 0
        t0 = time.perf_counter()
        while True:
            res = pipe.next()
            if res is None:
                break
            n += batch - res[2]
        return n / (time.perf_counter() - t0)
    finally:
        pipe.close()


@contextmanager
def _no_native():
    old = os.environ.get("MXNET_USE_NATIVE")
    os.environ["MXNET_USE_NATIVE"] = "0"
    try:
        yield
    finally:
        if old is None:
            del os.environ["MXNET_USE_NATIVE"]
        else:
            os.environ["MXNET_USE_NATIVE"] = old


def python_rate(rec: str, batch: int, hw: int, resize: int,
                threads: int) -> float:
    """Images/s of one epoch through ImageRecordIter's Python route."""
    from mxnet_tpu_torch.io import ImageRecordIter

    with _no_native():
        it = ImageRecordIter(path_imgrec=rec, data_shape=(3, hw, hw),
                             batch_size=batch, resize=resize,
                             rand_crop=True, rand_mirror=True,
                             preprocess_threads=threads)
        if it.route != "python":
            raise RuntimeError(f"expected the Python route, got {it.route}")
        n = 0
        t0 = time.perf_counter()
        for b in it:
            n += batch - b.pad
        return n / (time.perf_counter() - t0)


def measure(rec: str, idx: str, batch: int, hw: int, threads,
            python: bool, native: bool = True, resize: int = 0) -> dict:
    """{"native_t<k>": images/s, "python_t<k>": images/s} for each k in
    ``threads``, the short edge resized to ``resize`` (default hw + 32)."""
    resize = resize or hw + 32
    results = {}
    for t in sorted(set(threads)):
        if native:
            results[f"native_t{t}"] = native_rate(rec, idx, batch, hw, t,
                                                  resize)
        if python:
            results[f"python_t{t}"] = python_rate(rec, batch, hw, resize, t)
    return results


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--images", type=int, default=512)
    ap.add_argument("--size", type=int, default=256)
    ap.add_argument("--crop", type=int, default=224)
    ap.add_argument("--resize", type=int, default=0,
                    help="short edge before the crop (default crop + 32)")
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--quality", type=int, default=90)
    ap.add_argument("--threads", type=int, nargs="+",
                    default=[1, 2, 4, os.cpu_count() or 1])
    ap.add_argument("--python-baseline", action="store_true")
    args = ap.parse_args(argv)

    with tempfile.TemporaryDirectory() as tmp:
        prefix = os.path.join(tmp, "bench")
        print(f"generating {args.images} synthetic JPEGs ({args.size}px "
              f"q{args.quality})...")
        rec = make_shard(prefix, args.images, args.size, args.quality)
        results = measure(rec, prefix + ".idx", args.batch, args.crop,
                          args.threads, args.python_baseline,
                          resize=args.resize)
    for k, v in results.items():
        print(f"{k:>12}: {v:8.1f} img/s")
    print(json.dumps({"metric": "image_pipeline_decode_throughput",
                      "unit": "img/s", "nproc": os.cpu_count(),
                      "results": results}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
