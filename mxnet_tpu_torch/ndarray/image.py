"""``nd.image``: the image ops on NDArrays (counterpart of
``mxnet_tpu/ndarray/image.py``).  The random ones draw from the
generator of the input's device (``random.generator``), as the port's
``nd.random`` samplers do."""
from __future__ import annotations

from .. import random as _random
from ..ops.registry import invoke

__all__ = ["to_tensor", "normalize", "resize", "crop", "flip_left_right",
           "flip_up_down", "random_flip_left_right", "random_flip_up_down",
           "random_brightness", "random_contrast", "random_saturation"]


def _gen(data):
    return _random.generator(data.ctx)


def to_tensor(data):
    return invoke("_image_to_tensor", data)


def normalize(data, mean=(0.0,), std=(1.0,)):
    return invoke("_image_normalize", data, mean=tuple(mean),
                  std=tuple(std))


def resize(data, size=None, keep_ratio=False, interp=1):
    return invoke("_image_resize", data, size=size, keep_ratio=keep_ratio,
                  interp=interp)


def crop(data, x, y, width, height):
    return invoke("_image_crop", data, x0=x, y0=y, width=width,
                  height=height)


def flip_left_right(data):
    return invoke("_image_flip_left_right", data)


def flip_up_down(data):
    return invoke("_image_flip_up_down", data)


def random_flip_left_right(data):
    return invoke("_image_random_flip_left_right", data, _gen(data))


def random_flip_up_down(data):
    return invoke("_image_random_flip_up_down", data, _gen(data))


def random_brightness(data, min_factor=0.5, max_factor=1.5):
    return invoke("_image_random_brightness", data, _gen(data),
                  min_factor=min_factor, max_factor=max_factor)


def random_contrast(data, min_factor=0.5, max_factor=1.5):
    return invoke("_image_random_contrast", data, _gen(data),
                  min_factor=min_factor, max_factor=max_factor)


def random_saturation(data, min_factor=0.5, max_factor=1.5):
    return invoke("_image_random_saturation", data, _gen(data),
                  min_factor=min_factor, max_factor=max_factor)
