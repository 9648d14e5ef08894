"""Vision transforms (counterpart of
``mxnet_tpu/gluon/data/vision/transforms.py``, ref:
python/mxnet/gluon/data/vision/transforms.py): Compose, Cast, ToTensor,
Normalize, Resize, CenterCrop, RandomResizedCrop, RandomFlipLeftRight,
RandomFlipTopBottom, RandomBrightness, RandomContrast,
RandomSaturation, RandomHue, RandomColorJitter and RandomLighting.

They are host-side blocks over CPU images (HWC, as the datasets give
them; ``ToTensor`` makes CHW), computed in numpy as the JAX package
computes them, so each gives its bits.  Called on an NDArray a transform
returns an NDArray, on a tensor a tensor.  A random transform draws from
its ``generator`` when one is given (a ``numpy.random.RandomState`` or
a ``torch.Generator``); else, inside a DataLoader,
from the batch's own generator (``dataloader.batch_rng``, the same in
any worker); else from numpy's global generator, in the JAX package's
order of draws.
"""
from __future__ import annotations

import numpy as np
import torch

from ....base import dtype_of
from ....ndarray.ndarray import NDArray
from ...block import Block
from ...nn import Sequential
from ..dataloader import batch_rng

__all__ = ["Compose", "Cast", "ToTensor", "Normalize", "Resize", "CenterCrop",
           "RandomResizedCrop", "RandomFlipLeftRight", "RandomFlipTopBottom",
           "RandomBrightness", "RandomContrast", "RandomSaturation",
           "RandomHue", "RandomColorJitter", "RandomLighting"]


class _TorchDraws:
    """numpy's RandomState calls used here, drawn from a torch.Generator
    (float64 on the CPU)."""

    def __init__(self, gen):
        self._g = gen

    def rand(self):
        return float(torch.rand((), dtype=torch.float64, generator=self._g))

    def uniform(self, lo, hi):
        return lo + (hi - lo) * self.rand()

    def randint(self, lo, hi):
        return int(torch.randint(lo, hi, (), generator=self._g))

    def normal(self, loc, scale, size):
        return (loc + scale * torch.randn(size, dtype=torch.float64,
                                          generator=self._g)).numpy()

    def permutation(self, n):
        return torch.randperm(n, generator=self._g).numpy()


def _draws(generator):
    if generator is None:
        generator = batch_rng()
        return np.random if generator is None else generator
    if isinstance(generator, torch.Generator):
        return _TorchDraws(generator)
    return generator  # a numpy RandomState


def _np(x):
    if isinstance(x, NDArray):
        return x.asnumpy()
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _out(a):
    """A result as a CPU tensor, float64 narrowed to float32 and int64
    to int32 as ``nd.array`` narrows (the block call wraps it back into
    an NDArray for an NDArray caller)."""
    a = np.asarray(a)
    if a.dtype == np.float64:
        a = a.astype(np.float32)
    elif a.dtype == np.int64:
        a = a.astype(np.int32)
    return torch.from_numpy(np.ascontiguousarray(a))


class _Transform(Block):
    """A transform: ``forward`` on the image's numpy array, its random
    draws from :meth:`_rng`."""

    def __init__(self, generator=None):
        super().__init__()
        self._generator = generator

    def _rng(self):
        return _draws(self._generator)

    def forward(self, x):
        out = self._apply(_np(x))
        return x if out is None else _out(out)

    def _apply(self, a):
        raise NotImplementedError


class Compose(Sequential):
    """ref: transforms.Compose: the transforms applied in order."""

    def __init__(self, transforms):
        super().__init__()
        for t in transforms:
            self.add(t)


class Cast(_Transform):
    def __init__(self, dtype="float32"):
        super().__init__()
        self._dtype = dtype

    def forward(self, x):
        t = x._data if isinstance(x, NDArray) else torch.as_tensor(x)
        return t.to(dtype_of(self._dtype))


class ToTensor(_Transform):
    """HWC uint8 [0, 255] -> CHW float32 [0, 1] (NHWC -> NCHW)."""

    def _apply(self, a):
        a = a.astype("float32") / 255.0
        if a.ndim == 3:
            a = a.transpose(2, 0, 1)
        elif a.ndim == 4:
            a = a.transpose(0, 3, 1, 2)
        return a


class Normalize(_Transform):
    """(x - mean) / std per channel of a CHW image."""

    def __init__(self, mean=0.0, std=1.0):
        super().__init__()
        self._mean = np.asarray(mean, dtype="float32")
        self._std = np.asarray(std, dtype="float32")

    def _apply(self, a):
        mean = self._mean.reshape(-1, 1, 1) if self._mean.ndim else self._mean
        std = self._std.reshape(-1, 1, 1) if self._std.ndim else self._std
        return (a - mean) / std


def _resize_np(a, size):
    """Bilinear resize of an HWC array in numpy (``size``: an int, or
    (width, height))."""
    h, w = a.shape[:2]
    ow, oh = (size, size) if isinstance(size, int) else size
    ys = np.linspace(0, h - 1, oh)
    xs = np.linspace(0, w - 1, ow)
    y0 = np.floor(ys).astype(int)
    x0 = np.floor(xs).astype(int)
    y1 = np.minimum(y0 + 1, h - 1)
    x1 = np.minimum(x0 + 1, w - 1)
    wy = (ys - y0)[:, None, None]
    wx = (xs - x0)[None, :, None]
    a = a.astype("float32")
    return (a[y0][:, x0] * (1 - wy) * (1 - wx) + a[y1][:, x0] * wy * (1 - wx)
            + a[y0][:, x1] * (1 - wy) * wx + a[y1][:, x1] * wy * wx)


class Resize(_Transform):
    def __init__(self, size, keep_ratio=False, interpolation=1):
        super().__init__()
        self._size = size

    def _apply(self, a):
        return _resize_np(a, self._size)


class CenterCrop(_Transform):
    def __init__(self, size, interpolation=1):
        super().__init__()
        self._size = (size, size) if isinstance(size, int) else tuple(size)

    def _apply(self, a):
        h, w = a.shape[:2]
        cw, ch = self._size
        y0 = max((h - ch) // 2, 0)
        x0 = max((w - cw) // 2, 0)
        out = a[y0:y0 + ch, x0:x0 + cw]
        if out.shape[:2] != (ch, cw):
            out = _resize_np(out, (cw, ch))
        return out


class RandomResizedCrop(_Transform):
    def __init__(self, size, scale=(0.08, 1.0), ratio=(3 / 4, 4 / 3),
                 interpolation=1, generator=None):
        super().__init__(generator)
        self._size = (size, size) if isinstance(size, int) else tuple(size)
        self._scale = scale
        self._ratio = ratio

    def _apply(self, a):
        rng = self._rng()
        h, w = a.shape[:2]
        area = h * w
        for _ in range(10):
            target = rng.uniform(*self._scale) * area
            ratio = rng.uniform(*self._ratio)
            cw = int(round(np.sqrt(target * ratio)))
            ch = int(round(np.sqrt(target / ratio)))
            if cw <= w and ch <= h:
                x0 = rng.randint(0, w - cw + 1)
                y0 = rng.randint(0, h - ch + 1)
                return _resize_np(a[y0:y0 + ch, x0:x0 + cw], self._size)
        return _resize_np(a, self._size)


class RandomFlipLeftRight(_Transform):
    def __init__(self, generator=None):
        super().__init__(generator)

    def _apply(self, a):
        return a[:, ::-1].copy() if self._rng().rand() < 0.5 else None


class RandomFlipTopBottom(_Transform):
    def __init__(self, generator=None):
        super().__init__(generator)

    def _apply(self, a):
        return a[::-1].copy() if self._rng().rand() < 0.5 else None


class RandomBrightness(_Transform):
    def __init__(self, brightness, generator=None):
        super().__init__(generator)
        self._b = brightness

    def _apply(self, a):
        alpha = 1.0 + self._rng().uniform(-self._b, self._b)
        return a.astype("float32") * alpha


class RandomContrast(_Transform):
    def __init__(self, contrast, generator=None):
        super().__init__(generator)
        self._c = contrast

    def _apply(self, a):
        a = a.astype("float32")
        alpha = 1.0 + self._rng().uniform(-self._c, self._c)
        gray = a.mean()
        return gray + alpha * (a - gray)


class RandomSaturation(_Transform):
    def __init__(self, saturation, generator=None):
        super().__init__(generator)
        self._s = saturation

    def _apply(self, a):
        a = a.astype("float32")
        alpha = 1.0 + self._rng().uniform(-self._s, self._s)
        if a.ndim == 3 and a.shape[-1] == 3:
            gray = (a * np.array([0.299, 0.587, 0.114])).sum(-1,
                                                              keepdims=True)
            return gray + alpha * (a - gray)
        return None


class RandomHue(_Transform):
    def __init__(self, hue, generator=None):
        super().__init__(generator)
        self._h = hue

    def _apply(self, a):
        a = a.astype("float32")
        if a.ndim != 3 or a.shape[-1] != 3:
            return None
        alpha = self._rng().uniform(-self._h, self._h)
        # hue rotation through YIQ
        u, w = np.cos(alpha * np.pi), np.sin(alpha * np.pi)
        t_yiq = np.array([[0.299, 0.587, 0.114],
                          [0.596, -0.274, -0.321],
                          [0.211, -0.523, 0.311]], dtype="float32")
        t_rgb = np.linalg.inv(t_yiq).astype("float32")
        rot = np.array([[1, 0, 0], [0, u, -w], [0, w, u]], dtype="float32")
        return a @ (t_rgb @ rot @ t_yiq).T


class RandomColorJitter(_Transform):
    """The enabled jitters, each drawn from this transform's generator,
    in an order drawn from it."""

    def __init__(self, brightness=0, contrast=0, saturation=0, hue=0,
                 generator=None):
        super().__init__(generator)
        self._ts = []
        for cls, v in ((RandomBrightness, brightness),
                       (RandomContrast, contrast),
                       (RandomSaturation, saturation), (RandomHue, hue)):
            if v:
                self._ts.append(cls(v, generator=generator))

    def forward(self, x):
        for i in self._rng().permutation(len(self._ts)):
            x = self._ts[i](x)
        return x


class RandomLighting(_Transform):
    """AlexNet-style PCA lighting noise."""

    _eigval = np.array([55.46, 4.794, 1.148], dtype="float32")
    _eigvec = np.array([[-0.5675, 0.7192, 0.4009],
                        [-0.5808, -0.0045, -0.814],
                        [-0.5836, -0.6948, 0.4203]], dtype="float32")

    def __init__(self, alpha, generator=None):
        super().__init__(generator)
        self._alpha = alpha

    def _apply(self, a):
        a = a.astype("float32")
        if a.ndim != 3 or a.shape[-1] != 3:
            return None
        alpha = self._rng().normal(0, self._alpha, 3).astype("float32")
        return a + (self._eigvec * alpha * self._eigval).sum(axis=1)
