"""Data iterators (counterpart of ``mxnet_tpu/io/io.py``).

Batches are assembled in numpy on the host and handed out as NDArrays on
the CPU, as in the JAX package; the consumer (``Module``'s executor)
copies them to its device.  ``NDArrayIter`` keeps the JAX package's
order exactly: the same cursor arithmetic for ``pad``, ``discard`` and
``roll_over``, and its shuffle is ``np.random.shuffle`` of the index,
drawn from numpy's global generator at construction and at each
``reset``, so ``np.random.seed(s)`` gives both packages the same
batches.
"""
from __future__ import annotations

import gzip
import queue
import struct
import threading
from collections import namedtuple
from concurrent.futures import ThreadPoolExecutor
from typing import List, Optional

import numpy as np

from ..base import MXNetError
from ..context import cpu
from ..ndarray.ndarray import NDArray, array

__all__ = ["DataDesc", "DataBatch", "DataIter", "NDArrayIter", "CSVIter",
           "MNISTIter", "ResizeIter", "PrefetchingIter", "ImageRecordIter",
           "LibSVMIter"]


class DataDesc(namedtuple("DataDesc", ["name", "shape", "dtype", "layout"])):
    """The name, shape, dtype and layout of one input."""

    def __new__(cls, name, shape, dtype=np.float32, layout="NCHW"):
        return super().__new__(cls, name, tuple(shape), dtype, layout)

    @staticmethod
    def get_batch_axis(layout: Optional[str]) -> int:
        return 0 if layout is None else layout.find("N")


class DataBatch:
    """One mini-batch: lists of data and label NDArrays, and ``pad``, the
    count of rows at its end that repeat earlier ones."""

    def __init__(self, data: List[NDArray],
                 label: Optional[List[NDArray]] = None, pad: int = 0,
                 index=None, bucket_key=None, provide_data=None,
                 provide_label=None):
        self.data = data
        self.label = label if label is not None else []
        self.pad = pad
        self.index = index
        self.bucket_key = bucket_key
        self.provide_data = provide_data
        self.provide_label = provide_label

    def __str__(self):
        return (f"DataBatch: data shapes: {[d.shape for d in self.data]} "
                f"label shapes: {[x.shape for x in self.label]}")


class DataIter:
    """Base iterator; subclasses implement ``next`` (or the piecewise
    ``iter_next``/``getdata``/``getlabel``/``getpad``)."""

    _next_batch: Optional[DataBatch] = None

    def __init__(self, batch_size: int = 0):
        self.batch_size = batch_size

    def __iter__(self):
        return self

    def reset(self):
        pass

    def next(self) -> DataBatch:
        raise NotImplementedError

    def __next__(self) -> DataBatch:
        return self.next()

    def iter_next(self) -> bool:
        try:
            self._next_batch = self.next()
            return True
        except StopIteration:
            self._next_batch = None
            return False

    def getdata(self):
        return self._next_batch.data

    def getlabel(self):
        return self._next_batch.label

    def getindex(self):
        return self._next_batch.index

    def getpad(self):
        return self._next_batch.pad

    @property
    def provide_data(self) -> List[DataDesc]:
        raise NotImplementedError

    @property
    def provide_label(self) -> List[DataDesc]:
        return []


def _init_data(data, allow_empty, default_name):
    """``data`` as [(name, numpy array)]: one array is named
    ``default_name``, a list ``_i_<default_name>``; float64 becomes
    float32."""
    if data is None:
        if not allow_empty:
            raise MXNetError("data must be provided")
        return []
    if isinstance(data, (np.ndarray, NDArray)):
        data = [data]
    if isinstance(data, (list, tuple)):
        if len(data) == 1:
            data = {default_name: data[0]}
        else:
            data = {f"_{i}_{default_name}": d for i, d in enumerate(data)}
    out = []
    for k, v in data.items():
        v = np.asarray(v.asnumpy() if isinstance(v, NDArray) else v)
        if v.dtype == np.float64:
            v = v.astype(np.float32)
        out.append((k, v))
    return out


class NDArrayIter(DataIter):
    """Batches of in-memory arrays, with ``shuffle`` and the last batch
    padded by wrapping around (``pad``), dropped (``discard``) or carried
    into the next epoch (``roll_over``)."""

    def __init__(self, data, label=None, batch_size=1, shuffle=False,
                 last_batch_handle="pad", data_name="data",
                 label_name="softmax_label"):
        super().__init__(batch_size)
        self.data = _init_data(data, False, data_name)
        self.label = _init_data(label, True, label_name)
        self.num_data = self.data[0][1].shape[0]
        if self.num_data < batch_size:
            raise MXNetError("batch_size larger than dataset size")
        self.shuffle = shuffle
        self.last_batch_handle = last_batch_handle
        self.idx = np.arange(self.num_data)
        self.cursor = -batch_size
        self._shuffle_if_needed()

    def _shuffle_if_needed(self):
        if self.shuffle:
            np.random.shuffle(self.idx)

    def _descs(self, src):
        return [DataDesc(k, (self.batch_size,) + v.shape[1:], v.dtype)
                for k, v in src]

    @property
    def provide_data(self):
        return self._descs(self.data)

    @property
    def provide_label(self):
        return self._descs(self.label)

    def reset(self):
        self._shuffle_if_needed()
        if self.last_batch_handle == "roll_over" and \
                self.cursor > self.num_data - self.batch_size:
            self.cursor = -self.batch_size + (self.cursor % self.num_data) \
                % self.batch_size
        else:
            self.cursor = -self.batch_size

    def iter_next(self) -> bool:
        self.cursor += self.batch_size
        if self.last_batch_handle == "discard":
            return self.cursor + self.batch_size <= self.num_data
        return self.cursor < self.num_data

    def getdata(self):
        return self._take(self.data)

    def getlabel(self):
        return self._take(self.label)

    def getindex(self):
        return None

    def getpad(self) -> int:
        if self.last_batch_handle == "pad" and \
                self.cursor + self.batch_size > self.num_data:
            return self.cursor + self.batch_size - self.num_data
        return 0

    def next(self) -> DataBatch:
        if not self.iter_next():
            raise StopIteration
        return DataBatch(data=self.getdata(), label=self.getlabel(),
                         pad=self.getpad(), index=None,
                         provide_data=self.provide_data,
                         provide_label=self.provide_label)

    def _take(self, src):
        out = []
        sel = self.idx[self.cursor:self.cursor + self.batch_size]
        for _, v in src:
            arr = v[sel]
            if len(sel) < self.batch_size:  # pad by wrapping around
                extra = v[self.idx[:self.batch_size - len(sel)]]
                arr = np.concatenate([arr, extra], axis=0)
            out.append(array(arr, ctx=cpu()))
        return out


class _Wrapped(DataIter):
    """An iterator that hands out the batches of an ``NDArrayIter``."""

    _iter: NDArrayIter

    @property
    def provide_data(self):
        return self._iter.provide_data

    @property
    def provide_label(self):
        return self._iter.provide_label

    def reset(self):
        self._iter.reset()

    def next(self):
        return self._iter.next()


class CSVIter(_Wrapped):
    """Rows of a CSV file (and labels from another), reshaped to
    ``data_shape``; ``round_batch`` pads the last batch, else drops it."""

    def __init__(self, data_csv, data_shape, label_csv=None,
                 label_shape=(1,), batch_size=1, round_batch=True,
                 **kwargs):
        super().__init__(batch_size)
        data = np.loadtxt(data_csv, delimiter=",", dtype=np.float32,
                          ndmin=2).reshape((-1,) + tuple(data_shape))
        label = None
        if label_csv is not None:
            label = np.loadtxt(label_csv, delimiter=",", dtype=np.float32,
                               ndmin=2).reshape((-1,) + tuple(label_shape))
            if label.shape[-1] == 1:
                label = label.reshape(label.shape[:-1] or (-1,))
        self._iter = NDArrayIter(
            data, label, batch_size,
            last_batch_handle="pad" if round_batch else "discard",
            label_name="label")


def _open(path):
    return gzip.open(path, "rb") if path.endswith(".gz") else \
        open(path, "rb")


def _read_mnist_images(path):
    with _open(path) as f:
        magic, n, rows, cols = struct.unpack(">IIII", f.read(16))
        if magic != 2051:
            raise MXNetError(f"{path}: bad MNIST image magic {magic}")
        return np.frombuffer(f.read(), dtype=np.uint8).reshape(n, rows, cols)


def _read_mnist_labels(path):
    with _open(path) as f:
        magic, _ = struct.unpack(">II", f.read(8))
        if magic != 2049:
            raise MXNetError(f"{path}: bad MNIST label magic {magic}")
        return np.frombuffer(f.read(), dtype=np.uint8)


class MNISTIter(_Wrapped):
    """MNIST from its idx files (gzipped or not): images scaled to [0,
    1], (N, 1, 28, 28) or flat (N, 784)."""

    def __init__(self, image, label, batch_size=128, shuffle=True,
                 flat=False, silent=True, seed=None, **kwargs):
        super().__init__(batch_size)
        imgs = _read_mnist_images(image).astype(np.float32) / 255.0
        lbls = _read_mnist_labels(label).astype(np.float32)
        imgs = imgs.reshape(len(imgs), -1) if flat else imgs[:, None]
        self._iter = NDArrayIter(imgs, lbls, batch_size, shuffle=shuffle)


class ResizeIter(DataIter):
    """Exactly ``size`` batches an epoch from ``data_iter``, restarting it
    when it runs out."""

    def __init__(self, data_iter, size, reset_internal=True):
        super().__init__(data_iter.batch_size)
        self.data_iter = data_iter
        self.size = size
        self.reset_internal = reset_internal
        self.cur = 0

    @property
    def provide_data(self):
        return self.data_iter.provide_data

    @property
    def provide_label(self):
        return self.data_iter.provide_label

    def reset(self):
        self.cur = 0
        if self.reset_internal:
            self.data_iter.reset()

    def next(self):
        if self.cur >= self.size:
            raise StopIteration
        try:
            batch = self.data_iter.next()
        except StopIteration:
            self.data_iter.reset()
            batch = self.data_iter.next()
        self.cur += 1
        return batch


class PrefetchingIter(DataIter):
    """One iterator read ahead by a worker thread into a queue of two
    batches."""

    def __init__(self, iters, rename_data=None, rename_label=None):
        if not isinstance(iters, (list, tuple)):
            iters = [iters]
        if len(iters) != 1:
            raise MXNetError("PrefetchingIter wraps a single iterator")
        super().__init__(iters[0].batch_size)
        self._it = iters[0]
        self._thread: Optional[threading.Thread] = None
        self._exhausted = False
        self._start()

    def _start(self):
        self._stop = threading.Event()
        self._queue: "queue.Queue" = queue.Queue(maxsize=2)
        stop, q, it = self._stop, self._queue, self._it

        def worker():
            while not stop.is_set():
                try:
                    batch = it.next()
                except StopIteration:
                    batch = None
                while not stop.is_set():
                    try:
                        q.put(batch, timeout=0.05)
                        break
                    except queue.Full:
                        continue
                if batch is None:
                    return

        self._thread = threading.Thread(target=worker, daemon=True)
        self._thread.start()

    def _shutdown(self):
        if self._thread is not None and self._thread.is_alive():
            self._stop.set()
            try:  # unblock a worker waiting to put
                while True:
                    self._queue.get_nowait()
            except queue.Empty:
                pass
            self._thread.join(timeout=5.0)
        self._thread = None

    @property
    def provide_data(self):
        return self._it.provide_data

    @property
    def provide_label(self):
        return self._it.provide_label

    def reset(self):
        self._shutdown()
        self._it.reset()
        self._exhausted = False
        self._start()

    def next(self):
        if self._exhausted:
            raise StopIteration
        batch = self._queue.get()
        if batch is None:
            self._exhausted = True
            raise StopIteration
        return batch

    def __del__(self):
        try:
            self._shutdown()
        except Exception:  # interpreter shutdown
            pass


class ImageRecordIter(DataIter):
    """RecordIO image iterator (the reference's
    ``src/io/iter_image_recordio_2.cc``; the JAX package's class).

    Reads ``.rec`` shards of IRHeader + encoded image (``tools/im2rec.py``)
    and yields float32 NCHW batches, ``(x - mean) / std``, on the CPU.
    ``route`` says how, and ``route_reason`` why:

    * ``"native_pipeline"``: the C++ pipeline (``lib.NativeImagePipeline``)
      decodes, resizes the short edge (``INTER_AREA`` shrinking, else
      bilinear), crops, mirrors and normalizes on ``preprocess_threads``
      threads; it shuffles through the ``.idx`` (``path_imgidx``) from
      ``seed``.  Taken when the image library builds and either no
      shuffle is asked or the ``.idx`` is given;
    * ``"native_prefetch"``: records from the C++ prefetching reader,
      decoded in Python; when not shuffled and the core library builds;
    * ``"python"``: records read into memory, decoded in Python.

    On the two Python-decoding routes the shuffle, crops and mirrors draw
    from numpy's global generator in the JAX package's order (resize by
    nearest neighbour), so its batches are the JAX class's bit for bit.
    ``preprocess_threads`` threads decode and resize a batch's records
    and normalize its crops (cv2 and numpy release the GIL); the draws
    stay in the calling thread, in record order.

    The last batch of an epoch repeats its first records (``pad``).
    """

    def __init__(self, path_imgrec, data_shape, batch_size=1, label_width=1,
                 shuffle=False, mean_r=0.0, mean_g=0.0, mean_b=0.0,
                 std_r=1.0, std_g=1.0, std_b=1.0, rand_crop=False,
                 rand_mirror=False, resize=-1, path_imgidx=None,
                 round_batch=True, preprocess_threads=4, seed=0, **kwargs):
        super().__init__(batch_size)
        from .. import lib

        self.data_shape = tuple(data_shape)
        self.label_width = label_width
        self.shuffle = shuffle
        self.rand_crop = rand_crop
        self.rand_mirror = rand_mirror
        self.resize = resize
        self.mean = np.array([mean_r, mean_g, mean_b], np.float32)
        self.std = np.array([std_r, std_g, std_b], np.float32)
        self._pipe = None
        self._stream = None
        self._pool = None
        self._records: List[bytes] = []
        self._order = None
        self.cursor = 0
        self._epoch_count = None  # records an epoch, learnt on the stream
        if shuffle and not path_imgidx:
            why = "shuffle without path_imgidx"
        else:
            why = lib.image_error()
        if why is None:
            c, h, w = self.data_shape
            self._pipe = lib.NativeImagePipeline(
                path_imgrec, path_imgidx,
                batch=batch_size, channels=c, height=h, width=w,
                label_width=label_width, resize_short=resize,
                rand_crop=rand_crop, rand_mirror=rand_mirror,
                shuffle=shuffle, normalize=True,
                mean_r=mean_r, mean_g=mean_g, mean_b=mean_b,
                std_r=std_r, std_g=std_g, std_b=std_b,
                threads=preprocess_threads, seed=seed)
            self.route, self.route_reason = "native_pipeline", None
            return
        self.route_reason = f"no native pipeline: {why.splitlines()[0]}"
        threads = max(1, int(preprocess_threads))
        self._pool = ThreadPoolExecutor(threads) if threads > 1 else None
        if not shuffle and lib.available():
            self._stream = lib.NativePrefetchReader(path_imgrec)
            self.route = "native_prefetch"
        else:
            from ..recordio import MXRecordIO

            rec = MXRecordIO(path_imgrec, "r")
            try:
                while True:
                    buf = rec.read()
                    if buf is None:
                        break
                    self._records.append(buf)
            finally:
                rec.close()
            self._order = np.arange(len(self._records))
            self.route = "python"
        self.reset()

    @property
    def provide_data(self):
        return [DataDesc("data", (self.batch_size,) + self.data_shape)]

    @property
    def provide_label(self):
        shape = (self.batch_size,) if self.label_width == 1 \
            else (self.batch_size, self.label_width)
        return [DataDesc("softmax_label", shape)]

    def reset(self):
        if self._pipe is not None:
            self._pipe.reset()
            self.cursor = 0
            return
        if self._stream is not None:
            self._stream.reset()
        if self.shuffle:
            np.random.shuffle(self._order)
        self.cursor = 0

    def _decoded(self, raw: bytes):
        """A record's image decoded and its short edge resized (no draw),
        and its label vector."""
        from ..image import imdecode_np
        from ..recordio import unpack

        header, img_bytes = unpack(raw)
        img = imdecode_np(img_bytes)
        if self.resize > 0:
            img = _resize_short(img, self.resize)
        label = np.atleast_1d(np.asarray(header.label, np.float32))
        return img, label[:self.label_width]

    def _crop_mirror(self, img):
        """The crop and the mirror, drawing from numpy's global
        generator."""
        _, h, w = self.data_shape
        img = _center_or_rand_crop(img, (h, w), self.rand_crop)
        if self.rand_mirror and np.random.rand() < 0.5:
            img = img[:, ::-1]
        return img

    def _normalized(self, img):
        return ((img.astype(np.float32) - self.mean) / self.std).transpose(
            2, 0, 1)

    def decode_record(self, raw: bytes):
        """One record through the Python route: (CHW float32 image,
        label vector)."""
        img, label = self._decoded(raw)
        return self._normalized(self._crop_mirror(img)), label

    def _map(self, fn, items):
        return list(self._pool.map(fn, items) if self._pool is not None
                    else map(fn, items))

    def _next_raw(self) -> Optional[bytes]:
        """One record from the native stream or the in-memory list."""
        if self._stream is not None:
            raw = self._stream.read()
            if raw is None:
                # records an epoch = those consumed + this batch's part
                self._epoch_count = self.cursor + self._batch_pos
            return raw
        if self.cursor + self._batch_pos >= len(self._records):
            return None
        return self._records[self._order[self.cursor + self._batch_pos]]

    def _batch(self, data, label, pad):
        lab = label[:, 0] if self.label_width == 1 else label
        return DataBatch([array(data, ctx=cpu())], [array(lab, ctx=cpu())],
                         pad=pad, provide_data=self.provide_data,
                         provide_label=self.provide_label)

    def next(self) -> DataBatch:
        if self._pipe is not None:
            res = self._pipe.next()
            if res is None:
                raise StopIteration
            data, label, pad = res
            self.cursor += self.batch_size - pad
            return self._batch(data, label, pad)
        if self._stream is not None and self._epoch_count is not None \
                and self.cursor >= self._epoch_count:
            raise StopIteration
        raws, firsts = [], []
        pad = 0
        self._batch_pos = 0
        for b in range(self.batch_size):
            raw = self._next_raw()
            if raw is None:
                if b == 0:
                    raise StopIteration
                pad += 1
                raw = firsts[b % len(firsts)]
            else:
                firsts.append(raw)
                self._batch_pos += 1
            raws.append(raw)
        self.cursor += self._batch_pos
        decoded = self._map(self._decoded, raws)
        crops = [self._crop_mirror(img) for img, _ in decoded]
        c, h, w = self.data_shape
        data = np.empty((self.batch_size, c, h, w), np.float32)

        def fill(i):
            data[i] = self._normalized(crops[i])

        self._map(fill, range(self.batch_size))
        return self._batch(data, np.stack([lab for _, lab in decoded]), pad)

    def close(self):
        """Stop the decode threads and the native reader or pipeline."""
        if getattr(self, "_pool", None) is not None:
            self._pool.shutdown(wait=True)
            self._pool = None
        for attr in ("_stream", "_pipe"):
            if getattr(self, attr, None) is not None:
                getattr(self, attr).close()
                setattr(self, attr, None)

    def __del__(self):
        try:
            self.close()
        except Exception:  # interpreter shutdown
            pass


def _resize_short(img, size):
    """Nearest-neighbour resize of the shorter edge to ``size``."""
    h, w = img.shape[:2]
    scale = size / min(h, w)
    nh, nw = max(1, int(round(h * scale))), max(1, int(round(w * scale)))
    ys = (np.arange(nh) * (h / nh)).astype(int).clip(0, h - 1)
    xs = (np.arange(nw) * (w / nw)).astype(int).clip(0, w - 1)
    return img[ys][:, xs]


def _center_or_rand_crop(img, hw, rand):
    h, w = img.shape[:2]
    th, tw = hw
    if h < th or w < tw:
        img = _resize_short(img, max(th, tw))
        h, w = img.shape[:2]
    if rand:
        y = np.random.randint(0, h - th + 1)
        x = np.random.randint(0, w - tw + 1)
    else:
        y, x = (h - th) // 2, (w - tw) // 2
    return img[y:y + th, x:x + tw]


class LibSVMIter(DataIter):
    """libsvm text-format iterator producing CSR batches (the JAX
    package's ``LibSVMIter``; the reference's ``src/io/iter_libsvm.cc``).

    Lines are ``label [label...] idx:val idx:val ...`` (0-based feature
    indices).  Each batch's ``data`` is a compact ``CSRNDArray`` of shape
    (batch_size, num_features) on the CPU, its label a dense NDArray;
    with ``round_batch`` the last batch wraps to the first rows (``pad``
    counts them), without it a short last batch ends the epoch."""

    def __init__(self, data_libsvm, data_shape, label_libsvm=None,
                 label_shape=(1,), batch_size=1, round_batch=True,
                 **kwargs):
        super().__init__(batch_size)
        self._nfeat = int(data_shape[0] if isinstance(
            data_shape, (tuple, list)) else data_shape)
        counts, indices, values, labels = self._parse(data_libsvm)
        self._indptr = np.zeros(len(counts) + 1, np.int64)
        np.cumsum(counts, out=self._indptr[1:])
        self._indices = np.asarray(indices, np.int64)
        self._values = np.asarray(values, np.float32)
        if label_libsvm is not None:
            labels = np.loadtxt(label_libsvm, dtype=np.float32, ndmin=2)
            labels = labels.reshape((-1,) + tuple(label_shape))
            if labels.shape[-1] == 1:
                labels = labels.reshape(labels.shape[:-1] or (-1,))
        else:
            labels = np.asarray(labels, np.float32)
        self._labels = labels
        self._n = len(self._indptr) - 1
        self._round = round_batch
        self.reset()

    @staticmethod
    def _parse(path):
        counts, indices, values, labels = [], [], [], []
        with open(path) as f:
            for line in f:
                parts = line.split()
                if not parts:
                    continue
                k = 0
                while k < len(parts) and ":" not in parts[k]:
                    k += 1
                lab = [float(p) for p in parts[:k]]
                for tok in parts[k:]:
                    i, v = tok.split(":")
                    indices.append(int(i))
                    values.append(float(v))
                counts.append(len(parts) - k)
                labels.append(lab[0] if len(lab) == 1 else lab)
        return counts, indices, values, labels

    @property
    def provide_data(self):
        return [DataDesc("data", (self.batch_size, self._nfeat))]

    @property
    def provide_label(self):
        shp = np.asarray(self._labels).shape[1:]
        return [DataDesc("label", (self.batch_size,) + tuple(shp))]

    def reset(self):
        self._cursor = 0

    def next(self):
        from ..ndarray import sparse as _sp

        if self._cursor >= self._n:
            raise StopIteration
        b0, b1 = self._cursor, min(self._cursor + self.batch_size, self._n)
        self._cursor += self.batch_size
        pad = self.batch_size - (b1 - b0)
        if pad and not self._round:
            raise StopIteration
        take = np.concatenate([np.arange(b0, b1), np.arange(pad)])
        spans = [(b0, b1)] + ([(0, pad)] if pad else [])
        ip = self._indptr
        indices = np.concatenate([self._indices[ip[r0]:ip[r1]]
                                  for r0, r1 in spans])
        values = np.concatenate([self._values[ip[r0]:ip[r1]]
                                 for r0, r1 in spans])
        indptr = np.concatenate([[0], np.cumsum(np.diff(ip)[take])])
        data = _sp.csr_matrix((values, indices, indptr),
                              shape=(self.batch_size, self._nfeat),
                              ctx=cpu())
        label = array(np.asarray(self._labels)[take], ctx=cpu())
        return DataBatch(data=[data], label=[label], pad=pad, index=take)
