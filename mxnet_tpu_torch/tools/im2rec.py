"""im2rec: pack an image folder or a ``.lst`` into RecordIO shards (the
port's copy of the JAX package's ``tools/im2rec.py``, the reference's
``tools/im2rec.py``; its ``.lst``, ``.rec`` and ``.idx`` are that tool's,
byte for byte, for the same tree and flags).

  1. The list:
       python -m mxnet_tpu_torch.tools.im2rec PREFIX ROOT --list
           [--recursive] [--train-ratio R] [--test-ratio R] [--shuffle]
     writes PREFIX.lst (PREFIX_train/_val/_test.lst under ratios), one
     line an image, ``index\\tlabel\\trelative/path``; the label is the
     index of the image's top folder among the sorted top folders.

  2. The records:
       python -m mxnet_tpu_torch.tools.im2rec PREFIX ROOT [--resize N]
           [--quality Q] [--num-thread T] [--center-crop]
           [--color {-1,0,1}] [--encoding {.jpg,.png}] [--pack-label]
           [--pass-through]
     packs each PREFIX*.lst into a .rec and .idx: each image decoded,
     cropped to its centre square (``--center-crop``), its shorter edge
     resized (``INTER_AREA`` shrinking, bilinear enlarging) and encoded
     again on T threads, in the list's order.  ``--pack-label`` keeps
     every label value of a row (the detection object format).

``io.ImageRecordIter`` and ``image.ImageIter``/``ImageDetIter`` read the
shards.
"""
from __future__ import annotations

import argparse
import os
import random
import sys
import time
from concurrent.futures import ThreadPoolExecutor

_EXTS = {".jpg", ".jpeg", ".png", ".bmp"}


def list_images(root: str, recursive: bool):
    """(relative path, label) pairs, labels the sorted top folders'
    indices (0 for every file directly under ``root`` otherwise)."""
    if recursive:
        cats = sorted(d for d in os.listdir(root)
                      if os.path.isdir(os.path.join(root, d)))
        label_of = {c: i for i, c in enumerate(cats)}
        for cat in cats:
            for dirpath, _, files in os.walk(os.path.join(root, cat)):
                for f in sorted(files):
                    if os.path.splitext(f)[1].lower() in _EXTS:
                        yield (os.path.relpath(os.path.join(dirpath, f),
                                               root), label_of[cat])
    else:
        for f in sorted(os.listdir(root)):
            if os.path.splitext(f)[1].lower() in _EXTS:
                yield (f, 0)


def write_list(args):
    items = list(list_images(args.root, args.recursive))
    if args.shuffle:
        random.seed(args.seed)
        random.shuffle(items)
    n = len(items)
    n_train = int(n * args.train_ratio)
    n_test = int(n * args.test_ratio)
    chunks = {"": items}
    if args.train_ratio < 1.0 or args.test_ratio > 0.0:
        chunks = {"_train": items[:n_train],
                  "_test": items[n_train:n_train + n_test],
                  "_val": items[n_train + n_test:]}
        chunks = {k: v for k, v in chunks.items() if v}
    for suffix, chunk in chunks.items():
        path = f"{args.prefix}{suffix}.lst"
        with open(path, "w") as f:
            for i, (rel, label) in enumerate(chunk):
                f.write(f"{i}\t{label}\t{rel}\n")
        print(f"wrote {path} ({len(chunk)} images)")


def read_list(path: str):
    """(index, [label, ...], relative path) for each row of a ``.lst``."""
    with open(path) as f:
        for line in f:
            parts = line.strip().split("\t")
            if len(parts) < 3:
                continue
            yield int(parts[0]), [float(x) for x in parts[1:-1]], parts[-1]


def _encode_one(args, rel: str) -> bytes:
    """Read, crop, resize and encode one image."""
    import cv2

    path = os.path.join(args.root, rel)
    if args.pass_through:
        with open(path, "rb") as f:
            return f.read()
    flag = (cv2.IMREAD_COLOR if args.color == 1 else
            cv2.IMREAD_GRAYSCALE if args.color == 0 else
            cv2.IMREAD_UNCHANGED)
    img = cv2.imread(path, flag)
    if img is None:
        raise IOError(f"cannot decode {path}")
    if args.center_crop:
        s = min(img.shape[:2])
        y = (img.shape[0] - s) // 2
        x = (img.shape[1] - s) // 2
        img = img[y:y + s, x:x + s]
    if args.resize > 0:
        h, w = img.shape[:2]
        scale = args.resize / min(h, w)
        if scale != 1.0:
            img = cv2.resize(
                img, (max(1, round(w * scale)), max(1, round(h * scale))),
                interpolation=cv2.INTER_AREA if scale < 1
                else cv2.INTER_LINEAR)
    ext = ".png" if args.encoding == ".png" else ".jpg"
    params = [] if ext == ".png" else [cv2.IMWRITE_JPEG_QUALITY, args.quality]
    ok, buf = cv2.imencode(ext, img, params)
    if not ok:
        raise IOError(f"cannot encode {path}")
    return buf.tobytes()


def pack_list(args, lst_path: str):
    from mxnet_tpu_torch import recordio

    prefix = lst_path[:-4]
    items = list(read_list(lst_path))
    rec = recordio.MXIndexedRecordIO(prefix + ".idx", prefix + ".rec", "w")
    t0 = time.time()
    n_done = 0
    try:
        with ThreadPoolExecutor(max_workers=args.num_thread) as pool:
            # encode in parallel (cv2 releases the GIL), write in order
            encoded = pool.map(lambda it: _encode_one(args, it[2]), items,
                               chunksize=8)
            for (idx, labels, _rel), payload in zip(items, encoded):
                label = labels[0] if len(labels) == 1 and \
                    not args.pack_label else labels
                rec.write_idx(idx, recordio.pack(
                    recordio.IRHeader(0, label, idx, 0), payload))
                n_done += 1
                if n_done % 1000 == 0:
                    print(f"{lst_path}: {n_done}/{len(items)} "
                          f"({n_done / (time.time() - t0):.0f} img/s)")
    finally:
        rec.close()
    print(f"wrote {prefix}.rec + .idx ({n_done} records, "
          f"{time.time() - t0:.1f}s)")


def parse_args(argv=None):
    ap = argparse.ArgumentParser(
        description="pack images into RecordIO shards")
    ap.add_argument("prefix", help="output prefix (and .lst prefix)")
    ap.add_argument("root", help="image root directory")
    ap.add_argument("--list", action="store_true",
                    help="generate .lst instead of packing")
    ap.add_argument("--recursive", action="store_true",
                    help="label by top-level subdirectory")
    ap.add_argument("--train-ratio", type=float, default=1.0)
    ap.add_argument("--test-ratio", type=float, default=0.0)
    ap.add_argument("--shuffle", action="store_true")
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--resize", type=int, default=0,
                    help="resize shorter edge before packing")
    ap.add_argument("--center-crop", action="store_true")
    ap.add_argument("--quality", type=int, default=95)
    ap.add_argument("--num-thread", type=int, default=os.cpu_count() or 1)
    ap.add_argument("--color", type=int, default=1, choices=[-1, 0, 1])
    ap.add_argument("--encoding", default=".jpg", choices=[".jpg", ".png"])
    ap.add_argument("--pack-label", action="store_true",
                    help="store the full (multi-)label vector")
    ap.add_argument("--pass-through", action="store_true",
                    help="pack original file bytes without re-encoding")
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    if args.list:
        write_list(args)
        return 0
    lsts = sorted(p for p in (f"{args.prefix}{s}" for s in
                              ("", "_train", "_val", "_test"))
                  if os.path.isfile(p + ".lst"))
    if not lsts:
        print(f"no .lst found for prefix {args.prefix}; "
              f"run with --list first", file=sys.stderr)
        return 1
    for p in lsts:
        pack_list(args, p + ".lst")
    return 0


if __name__ == "__main__":
    sys.exit(main())
