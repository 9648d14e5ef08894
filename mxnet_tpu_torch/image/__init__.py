"""``mx.image``: image codecs, crops, augmenters and the Python image
iterators (counterpart of ``mxnet_tpu/image/__init__.py``; the
reference's ``python/mxnet/image/image.py`` and ``detection.py``).

Images are decoded and encoded by OpenCV's Python module ``cv2``, as in
the reference; without ``cv2`` these functions raise and name it (the
JAX package's TensorFlow fallback is not ported).  A decoded image is an
HWC uint8 RGB array; the functions return NDArrays on the CPU, as the
data pipeline's arrays are, and the augmenters draw from numpy's global
generator in the JAX package's order, so ``np.random.seed(s)`` gives
both packages the same images.  ``ImageIter`` and ``ImageDetIter``
decode and augment in Python; ``io.ImageRecordIter`` is the native
pipeline.
"""
from __future__ import annotations

import io
import json
import os
from typing import List

import numpy as np

from ..base import MXNetError
from ..ndarray.ndarray import NDArray, _cpu_array

__all__ = ["imread", "imdecode", "imdecode_np", "imencode", "imresize",
           "resize_short", "fixed_crop", "center_crop", "random_crop",
           "color_normalize", "CreateAugmenter", "Augmenter",
           "ResizeAug", "ForceResizeAug", "RandomCropAug", "CenterCropAug",
           "HorizontalFlipAug", "CastAug", "ColorNormalizeAug",
           "BrightnessJitterAug", "ContrastJitterAug", "SaturationJitterAug",
           "RandomOrderAug", "ImageIter", "DetAugmenter",
           "DetForceResizeAug", "DetHorizontalFlipAug",
           "DetColorNormalizeAug", "CreateDetAugmenter", "ImageDetIter"]

_MEAN_RGB = np.array([123.68, 116.28, 103.53])
_STD_RGB = np.array([58.395, 57.12, 57.375])


def _cv2():
    try:
        import cv2
    except ImportError:
        raise MXNetError("mx.image decodes and encodes with OpenCV's Python "
                         "module cv2, which is not installed") from None
    return cv2


def _np(src) -> np.ndarray:
    return src.asnumpy() if isinstance(src, NDArray) else np.asarray(src)


def imdecode_np(buf: bytes, iscolor: int = 1) -> np.ndarray:
    """JPEG/PNG bytes (or a ``.npy`` payload) -> HWC uint8 numpy array,
    RGB when ``iscolor``, one channel otherwise."""
    if len(buf) >= 6 and buf[:6] == b"\x93NUMPY":
        return np.load(io.BytesIO(buf))
    cv2 = _cv2()
    img = cv2.imdecode(np.frombuffer(buf, np.uint8),
                       cv2.IMREAD_COLOR if iscolor else cv2.IMREAD_GRAYSCALE)
    if img is None:
        raise MXNetError(f"cannot decode an image from {len(buf)} bytes")
    return cv2.cvtColor(img, cv2.COLOR_BGR2RGB) if iscolor else img[..., None]


def imdecode(buf, flag: int = 1, to_rgb: int = 1, out=None) -> NDArray:
    """Decode image bytes (flag 1 color, 0 gray) to an NDArray."""
    if isinstance(buf, NDArray):
        buf = buf.asnumpy().tobytes()
    return _cpu_array(imdecode_np(bytes(buf), flag))


def imencode(img, quality: int = 95, fmt: str = ".jpg") -> bytes:
    """Encode an HWC (RGB or one-channel) or HW uint8 image as JPEG or
    PNG bytes."""
    img = np.ascontiguousarray(_np(img)).astype(np.uint8)
    if fmt not in (".jpg", ".jpeg", ".png"):
        raise MXNetError(f"unsupported image format {fmt}")
    if not (img.ndim == 2 or img.shape[-1] in (1, 3)):
        raise MXNetError(f"imencode takes gray or RGB images, not "
                         f"{img.shape[-1]} channels")
    cv2 = _cv2()
    bgr = cv2.cvtColor(img, cv2.COLOR_RGB2BGR) \
        if img.ndim == 3 and img.shape[-1] == 3 else img
    params = [] if fmt == ".png" else [cv2.IMWRITE_JPEG_QUALITY, quality]
    ok, buf = cv2.imencode(".png" if fmt == ".png" else ".jpg", bgr, params)
    if not ok:
        raise MXNetError(f"cannot encode a {img.shape} image as {fmt}")
    return buf.tobytes()


def imread(filename: str, flag: int = 1, to_rgb: int = 1) -> NDArray:
    with open(filename, "rb") as f:
        return imdecode(f.read(), flag, to_rgb)


def imresize(src, w: int, h: int, interp: int = 1) -> NDArray:
    """Bilinear resize to (w, h), float32 (the JAX package's numpy
    resize; ``interp`` is accepted and ignored there too)."""
    from ..gluon.data.vision.transforms import _resize_np

    return _cpu_array(_resize_np(_np(src), (w, h)))


def resize_short(src, size: int, interp: int = 2) -> NDArray:
    a = _np(src)
    h, w = a.shape[:2]
    if h > w:
        new_w, new_h = size, int(h * size / w)
    else:
        new_w, new_h = int(w * size / h), size
    return imresize(a, new_w, new_h, interp)


def fixed_crop(src, x0, y0, w, h, size=None, interp=2) -> NDArray:
    out = _np(src)[y0:y0 + h, x0:x0 + w]
    if size is not None and (w, h) != size:
        return imresize(out, size[0], size[1], interp)
    return _cpu_array(out)


def center_crop(src, size, interp=2):
    a = _np(src)
    h, w = a.shape[:2]
    new_w, new_h = size
    x0 = max((w - new_w) // 2, 0)
    y0 = max((h - new_h) // 2, 0)
    out = fixed_crop(a, x0, y0, min(new_w, w), min(new_h, h), size, interp)
    return out, (x0, y0, new_w, new_h)


def random_crop(src, size, interp=2):
    a = _np(src)
    h, w = a.shape[:2]
    new_w, new_h = min(size[0], w), min(size[1], h)
    x0 = np.random.randint(0, w - new_w + 1)
    y0 = np.random.randint(0, h - new_h + 1)
    out = fixed_crop(a, x0, y0, new_w, new_h, size, interp)
    return out, (x0, y0, new_w, new_h)


def color_normalize(src, mean, std=None) -> NDArray:
    a = _np(src).astype("float32") - np.asarray(mean, dtype="float32")
    if std is not None:
        a = a / np.asarray(std, dtype="float32")
    return _cpu_array(a)


class Augmenter:
    """An image transform (an NDArray in, an NDArray out)."""

    def __init__(self, **kwargs):
        self._kwargs = kwargs

    def dumps(self):
        return json.dumps([type(self).__name__.lower(), self._kwargs])

    def __call__(self, src):
        raise NotImplementedError


class ResizeAug(Augmenter):
    def __init__(self, size, interp=2):
        super().__init__(size=size, interp=interp)
        self.size = size
        self.interp = interp

    def __call__(self, src):
        return resize_short(src, self.size, self.interp)


class ForceResizeAug(Augmenter):
    def __init__(self, size, interp=2):
        super().__init__(size=size, interp=interp)
        self.size = size
        self.interp = interp

    def __call__(self, src):
        return imresize(src, self.size[0], self.size[1], self.interp)


class RandomCropAug(Augmenter):
    def __init__(self, size, interp=2):
        super().__init__(size=size, interp=interp)
        self.size = size
        self.interp = interp

    def __call__(self, src):
        return random_crop(src, self.size, self.interp)[0]


class CenterCropAug(Augmenter):
    def __init__(self, size, interp=2):
        super().__init__(size=size, interp=interp)
        self.size = size
        self.interp = interp

    def __call__(self, src):
        return center_crop(src, self.size, self.interp)[0]


class HorizontalFlipAug(Augmenter):
    def __init__(self, p):
        super().__init__(p=p)
        self.p = p

    def __call__(self, src):
        if np.random.rand() < self.p:
            return _cpu_array(_np(src)[:, ::-1].copy())
        return src


class CastAug(Augmenter):
    def __init__(self, typ="float32"):
        super().__init__(type=typ)
        self.typ = typ

    def __call__(self, src):
        return src.astype(self.typ)


class ColorNormalizeAug(Augmenter):
    def __init__(self, mean, std):
        super().__init__(mean=mean, std=std)
        self.mean = mean
        self.std = std

    def __call__(self, src):
        return color_normalize(src, self.mean, self.std)


class BrightnessJitterAug(Augmenter):
    def __init__(self, brightness):
        super().__init__(brightness=brightness)
        self.brightness = brightness

    def __call__(self, src):
        alpha = 1.0 + np.random.uniform(-self.brightness, self.brightness)
        return _cpu_array(_np(src).astype("float32") * alpha)


class ContrastJitterAug(Augmenter):
    def __init__(self, contrast):
        super().__init__(contrast=contrast)
        self.contrast = contrast

    def __call__(self, src):
        a = _np(src).astype("float32")
        alpha = 1.0 + np.random.uniform(-self.contrast, self.contrast)
        gray = a.mean()
        return _cpu_array(gray + alpha * (a - gray))


class SaturationJitterAug(Augmenter):
    def __init__(self, saturation):
        super().__init__(saturation=saturation)
        self.saturation = saturation

    def __call__(self, src):
        a = _np(src).astype("float32")
        alpha = 1.0 + np.random.uniform(-self.saturation, self.saturation)
        gray = (a * np.array([0.299, 0.587, 0.114])).sum(-1, keepdims=True)
        return _cpu_array(gray + alpha * (a - gray))


class RandomOrderAug(Augmenter):
    def __init__(self, ts):
        super().__init__()
        self.ts = ts

    def __call__(self, src):
        for t in np.random.permutation(self.ts):
            src = t(src)
        return src


def CreateAugmenter(data_shape, resize=0, rand_crop=False, rand_resize=False,
                    rand_mirror=False, mean=None, std=None, brightness=0,
                    contrast=0, saturation=0, hue=0, pca_noise=0,
                    rand_gray=0, inter_method=2):
    """The standard augmenter list: resize the short edge, crop (random
    or center) to ``data_shape``, mirror, cast to float32, the colour
    jitters in random order, normalize (``mean``/``std`` True: the
    ImageNet RGB statistics)."""
    auglist: List[Augmenter] = []
    if resize > 0:
        auglist.append(ResizeAug(resize, inter_method))
    crop_size = (data_shape[2], data_shape[1])
    if rand_crop:
        auglist.append(RandomCropAug(crop_size, inter_method))
    else:
        auglist.append(CenterCropAug(crop_size, inter_method))
    if rand_mirror:
        auglist.append(HorizontalFlipAug(0.5))
    auglist.append(CastAug())
    jitters = []
    if brightness > 0:
        jitters.append(BrightnessJitterAug(brightness))
    if contrast > 0:
        jitters.append(ContrastJitterAug(contrast))
    if saturation > 0:
        jitters.append(SaturationJitterAug(saturation))
    if jitters:
        auglist.append(RandomOrderAug(jitters))
    if mean is True:
        mean = _MEAN_RGB
    if std is True:
        std = _STD_RGB
    if mean is not None and std is not None:
        auglist.append(ColorNormalizeAug(mean, std))
    return auglist


# ---------------------------------------------------------------------------
# ImageIter / ImageDetIter: Python iterators over .rec shards or a .lst
# with image files
# ---------------------------------------------------------------------------

class ImageIter:
    """Image iterator with Python augmenters.

    Sources: ``path_imgrec`` (with ``path_imgidx`` optional), or
    ``path_imglist`` + ``path_root`` (a tab-separated ``.lst``:
    ``idx\\tlabel...\\tpath``), or ``imglist`` [(label, path), ...].
    ``shuffle`` draws from ``RandomState(seed)``; the augmenters from
    numpy's global generator.  Batches are float32 NCHW NDArrays on the
    CPU; the last one repeats the epoch's first images (``pad``).
    """

    def __init__(self, batch_size, data_shape, label_width=1,
                 path_imgrec=None, path_imglist=None, path_root=None,
                 shuffle=False, aug_list=None, imglist=None,
                 data_name="data", label_name="softmax_label",
                 last_batch_handle="pad", seed=0, **kwargs):
        from ..io import DataDesc

        if len(data_shape) != 3 or data_shape[0] not in (1, 3):
            raise MXNetError("data_shape must be (C, H, W) with C in "
                             f"{{1,3}} (got {tuple(data_shape)})")
        self.batch_size = batch_size
        self.data_shape = tuple(data_shape)
        self.label_width = label_width
        self._shuffle = shuffle
        self._rng = np.random.RandomState(seed)
        self.auglist = (aug_list if aug_list is not None
                        else CreateAugmenter(data_shape))
        self._items = []   # (label array, payload bytes or file path)
        if path_imgrec:
            from .. import recordio as rio

            idx_path = kwargs.get("path_imgidx")
            rec = (rio.MXIndexedRecordIO(idx_path, path_imgrec, "r")
                   if idx_path else rio.MXRecordIO(path_imgrec, "r"))
            try:
                while True:
                    s = rec.read()
                    if s is None:
                        break
                    h, img = rio.unpack(s)
                    self._items.append(
                        (np.atleast_1d(np.asarray(h.label, np.float32)),
                         img))
            finally:
                rec.close()
        elif imglist is not None or path_imglist:
            if path_imglist:
                rows = []
                with open(path_imglist) as f:
                    for line in f:
                        parts = line.strip().split("\t")
                        if len(parts) < 3:
                            continue
                        rows.append((np.asarray(
                            [float(x) for x in parts[1:-1]], np.float32),
                            parts[-1]))
            else:
                rows = [(np.atleast_1d(np.asarray(lab, np.float32)), p)
                        for (lab, p) in imglist]
            root = path_root or "."
            for lab, p in rows:
                self._items.append((lab, os.path.join(root, p)))
        else:
            raise MXNetError("ImageIter needs path_imgrec, path_imglist "
                             "or imglist")
        if not self._items:
            raise MXNetError("ImageIter: empty data source")
        self._order = np.arange(len(self._items))
        self.provide_data = [DataDesc(
            data_name, (batch_size,) + self.data_shape)]
        self.provide_label = [DataDesc(
            label_name, (batch_size, label_width) if label_width > 1
            else (batch_size,))]
        self.reset()

    def reset(self):
        if self._shuffle:
            self._rng.shuffle(self._order)
        self._cursor = 0

    def _decode(self, payload) -> np.ndarray:
        if isinstance(payload, (bytes, bytearray)):
            return imdecode_np(bytes(payload))
        with open(payload, "rb") as f:
            return imdecode_np(f.read())

    def _augment(self, img) -> np.ndarray:
        nd_img = _cpu_array(img.astype(np.float32))
        for aug in self.auglist:
            nd_img = aug(nd_img)
        return nd_img.asnumpy()

    def next_sample(self):
        if self._cursor >= len(self._items):
            raise StopIteration
        lab, payload = self._items[self._order[self._cursor]]
        self._cursor += 1
        return lab, payload

    def _fill(self, data, label, sample):
        """Fill rows of data/label from ``sample(i)``; the rows past the
        end of the epoch repeat the batch's first ones."""
        from ..io import DataBatch

        i = 0
        pad = 0
        try:
            while i < self.batch_size:
                sample(i)
                i += 1
        except StopIteration:
            if i == 0:
                raise
            pad = self.batch_size - i
            for j in range(i, self.batch_size):
                data[j] = data[j - i]
                label[j] = label[j - i]
        return DataBatch(data=[_cpu_array(data)], label=None, pad=pad)

    def next(self):
        c, h, w = self.data_shape
        data = np.zeros((self.batch_size, c, h, w), np.float32)
        label = np.zeros((self.batch_size, self.label_width), np.float32)

        def sample(i):
            lab, payload = self.next_sample()
            data[i] = self._augment(self._decode(payload)).transpose(2, 0, 1)
            label[i, :lab.size] = lab[:self.label_width]

        batch = self._fill(data, label, sample)
        batch.label = [_cpu_array(label if self.label_width > 1
                                  else label[:, 0])]
        return batch

    def __iter__(self):
        return self

    def __next__(self):
        return self.next()


class DetAugmenter:
    """A detection augmenter: transforms an image and its boxes together
    so that the labels stay aligned."""

    def __call__(self, img, boxes):
        raise NotImplementedError


class DetForceResizeAug(DetAugmenter):
    """Resize to (w, h); boxes in relative [0, 1] coordinates do not
    change under a resize of the whole frame."""

    def __init__(self, size, interp=2):
        self.size = size
        self.interp = interp

    def __call__(self, img, boxes):
        return imresize(img, self.size[0], self.size[1],
                        self.interp), boxes


class DetHorizontalFlipAug(DetAugmenter):
    """Mirror with probability ``p`` (its own ``RandomState(seed)``): the
    image and the boxes' x coordinates."""

    def __init__(self, p=0.5, seed=0):
        self.p = p
        self._rng = np.random.RandomState(seed)

    def __call__(self, img, boxes):
        if self._rng.rand() < self.p:
            img = _cpu_array(_np(img)[:, ::-1].copy())
            boxes = boxes.copy()
            x1 = boxes[:, 1].copy()
            boxes[:, 1] = 1.0 - boxes[:, 3]
            boxes[:, 3] = 1.0 - x1
        return img, boxes


class DetColorNormalizeAug(DetAugmenter):
    def __init__(self, mean, std):
        self._aug = ColorNormalizeAug(mean, std)

    def __call__(self, img, boxes):
        return self._aug(img), boxes


def CreateDetAugmenter(data_shape, resize=0, rand_mirror=False, mean=None,
                       std=None, inter_method=2):
    """The detection augmenters: a forced resize to ``data_shape`` and
    box-aware mirroring, then normalization; no crop, which could cut
    boxes."""
    auglist: List[DetAugmenter] = [
        DetForceResizeAug((data_shape[2], data_shape[1]), inter_method)]
    if rand_mirror:
        auglist.append(DetHorizontalFlipAug(0.5))
    if mean is True:
        mean = _MEAN_RGB
    if std is True:
        std = _STD_RGB
    if mean is not None and std is not None:
        auglist.append(DetColorNormalizeAug(mean, std))
    return auglist


class ImageDetIter(ImageIter):
    """Detection iterator: a variable number of objects an image.

    Labels are in im2rec's ``--pack-label`` object format,
    ``[header_width, obj_width, (header...), obj0..., obj1...]``, each
    object ``[cls, xmin, ymin, xmax, ymax]`` in relative coordinates.  A
    batch's label is (batch, max_objects, obj_width), rows past an
    image's objects -1 (the detection losses' ignore marker).  Only
    DetAugmenters are accepted: a plain Augmenter would move the image
    without its boxes."""

    def __init__(self, batch_size, data_shape, path_imgrec=None,
                 max_objects=None, aug_list=None, **kwargs):
        from ..io import DataDesc

        if aug_list is None:
            aug_list = CreateDetAugmenter(data_shape)
        if any(not isinstance(a, DetAugmenter) for a in aug_list):
            raise MXNetError(
                "ImageDetIter needs DetAugmenters (CreateDetAugmenter): "
                "plain Augmenters transform the image without the boxes")
        super().__init__(batch_size, data_shape, label_width=1,
                         path_imgrec=path_imgrec, aug_list=[], **kwargs)
        self.auglist = list(aug_list)
        self._obj_width = None
        widest = 0
        parsed = []
        for lab, payload in self._items:
            objs = self._parse_det_label(lab)
            widest = max(widest, objs.shape[0])
            parsed.append((objs, payload))
        self._items = parsed
        self.max_objects = max_objects or widest
        self.provide_label = [DataDesc(
            "label", (batch_size, self.max_objects, self._obj_width))]

    def _parse_det_label(self, flat):
        flat = np.asarray(flat, np.float32).ravel()
        if flat.size < 2:
            raise MXNetError("ImageDetIter: label is not in the packed "
                             "object format (use im2rec --pack-label)")
        hw, ow = int(flat[0]), int(flat[1])
        if self._obj_width is None:
            self._obj_width = ow
        elif ow != self._obj_width:
            raise MXNetError("ImageDetIter: inconsistent object widths "
                             f"({ow} vs {self._obj_width})")
        body = flat[hw:]
        n = body.size // ow
        return body[: n * ow].reshape(n, ow)

    def next(self):
        c, h, w = self.data_shape
        data = np.zeros((self.batch_size, c, h, w), np.float32)
        label = np.full((self.batch_size, self.max_objects,
                         self._obj_width), -1.0, np.float32)

        def sample(i):
            objs, payload = self.next_sample()
            img = _cpu_array(self._decode(payload).astype(np.float32))
            objs = np.asarray(objs, np.float32)
            for aug in self.auglist:
                img, objs = aug(img, objs)
            data[i] = _np(img).transpose(2, 0, 1)
            n = min(objs.shape[0], self.max_objects)
            label[i, :n] = objs[:n]

        batch = self._fill(data, label, sample)
        batch.label = [_cpu_array(label)]
        return batch
