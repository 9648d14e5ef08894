"""The ``_image_*`` ops (counterpart of ``mxnet_tpu/ops/image_ops.py``;
the reference's ``src/operator/image/``): to_tensor, normalize, resize,
crop, the flips and the random flips, brightness, contrast and
saturation.

They are plain functions on tensors, so they run where their input lies
(on the card for a CUDA NDArray).  Images are HWC, or NHWC batched,
uint8 or float; ``to_tensor`` makes CHW float32 in [0, 1].  A random op
takes a ``torch.Generator`` where the JAX op takes a key, and draws its
coin or factor from it on the generator's device.  An integer result
saturates to its dtype's range, as XLA's float-to-integer conversion
does.
"""
from __future__ import annotations

import torch

from .registry import register_op

__all__ = ["resize_weights", "brightness", "contrast", "saturation"]

_LUMA = (0.299, 0.587, 0.114)


def _is_batched(x):
    return x.dim() == 4


def _cast_to(v, dtype):
    """``v`` as ``dtype``: float-to-integer rounds toward zero and
    saturates, as the JAX ops' ``astype`` does."""
    if dtype.is_floating_point or dtype == torch.bool:
        return v.to(dtype)
    info = torch.iinfo(dtype)
    return v.clamp(info.min, info.max).to(dtype)


@register_op("_image_to_tensor", aliases=("image_to_tensor",))
def _to_tensor(x):
    """HWC [0, 255] -> CHW float32 [0, 1] (NHWC -> NCHW)."""
    perm = (0, 3, 1, 2) if _is_batched(x) else (2, 0, 1)
    return (x.to(torch.float32) / 255.0).permute(perm).contiguous()


@register_op("_image_normalize", aliases=("image_normalize",))
def _normalize(x, mean=(0.0,), std=(1.0,)):
    """Channel-wise (x - mean) / std of CHW/NCHW float input."""
    shape = (1, -1, 1, 1) if _is_batched(x) else (-1, 1, 1)
    mean = torch.as_tensor(mean, dtype=torch.float32, device=x.device)
    std = torch.as_tensor(std, dtype=torch.float32, device=x.device)
    return (x - mean.reshape(shape)) / std.reshape(shape)


def resize_weights(m: int, n: int, device=None) -> torch.Tensor:
    """The (m, n) float32 matrix that resizes an axis of m samples to n
    by a triangle (bilinear) kernel, widened by m/n when it shrinks
    (antialiased), with half-pixel centres: ``jax.image.resize``'s
    weights, computed in the same float32 operations."""
    f32 = torch.float32
    inv = torch.tensor(1.0 / (n / m), dtype=f32, device=device)
    scale = torch.clamp(inv, min=1.0)
    sample = (torch.arange(n, dtype=f32, device=device) + 0.5) * inv - 0.5
    dist = (sample[None, :] - torch.arange(m, dtype=f32, device=device)[
        :, None]).abs() / scale
    w = torch.clamp(1 - dist, min=0)
    total = w.sum(0, keepdim=True)
    eps = torch.finfo(f32).eps
    w = torch.where(total.abs() > 1000.0 * eps,
                    w / torch.where(total != 0, total, torch.ones_like(total)),
                    torch.zeros_like(w))
    inside = (sample >= -0.5) & (sample <= m - 0.5)
    return torch.where(inside[None, :], w, torch.zeros_like(w))


def _nearest_index(m: int, n: int, device) -> torch.Tensor:
    """floor((i + 0.5) * m / n) in float32, as ``jax.image.resize``."""
    pos = (torch.arange(n, dtype=torch.float32, device=device) + 0.5) * m / n
    return torch.floor(pos).to(torch.long)


@register_op("_image_resize", aliases=("image_resize",))
def _resize(x, size=None, keep_ratio=False, interp=1):
    """Resize HWC/NHWC to ``size``: (w, h), or an int (the shorter edge
    under ``keep_ratio``, else a square); bilinear (interp 1,
    antialiased when it shrinks) or nearest (0).  Computed in float32;
    an integer image is rounded and clipped to 0..255."""
    if size is None:
        raise ValueError("_image_resize requires size=")
    h_ax = 1 if _is_batched(x) else 0
    h, w = x.shape[h_ax], x.shape[h_ax + 1]
    if isinstance(size, int):
        if keep_ratio:
            scale = size / min(h, w)
            nh, nw = max(1, round(h * scale)), max(1, round(w * scale))
        else:
            nh = nw = size
    else:
        nw, nh = size  # the reference passes (w, h)
    out = x.to(torch.float32)
    for ax, m, n in ((h_ax, h, nh), (h_ax + 1, w, nw)):
        if m == n:
            continue
        if interp == 0:
            out = out.index_select(ax, _nearest_index(m, n, x.device))
        else:
            # contract the axis with its weights, then put it back
            out = torch.tensordot(out, resize_weights(m, n, x.device),
                                  dims=([ax], [0])).movedim(-1, ax)
    if not x.dtype.is_floating_point:
        out = torch.clamp(torch.round(out), 0, 255)
    return _cast_to(out.contiguous(), x.dtype)


@register_op("_image_crop", aliases=("image_crop",))
def _crop(x, x0=0, y0=0, width=0, height=0):
    """Fixed crop of HWC/NHWC."""
    if _is_batched(x):
        return x[:, y0:y0 + height, x0:x0 + width].clone()
    return x[y0:y0 + height, x0:x0 + width].clone()


@register_op("_image_flip_left_right", aliases=("image_flip_left_right",))
def _flip_lr(x):
    """Mirror HWC/NHWC horizontally (the width axis)."""
    return torch.flip(x, dims=(-2,))


@register_op("_image_flip_up_down", aliases=("image_flip_up_down",))
def _flip_ud(x):
    """Mirror HWC/NHWC vertically (the height axis)."""
    return torch.flip(x, dims=(1 if _is_batched(x) else 0,))


def _coin(generator):
    return torch.rand((), generator=generator,
                      device=generator.device) < 0.5


def _factor(generator, lo, hi):
    u = torch.rand((), generator=generator, device=generator.device)
    return lo + (hi - lo) * u


@register_op("_image_random_flip_left_right",
             aliases=("image_random_flip_left_right",))
def _random_flip_lr(x, generator):
    """Horizontal mirror with probability 0.5 (one coin for the call)."""
    return torch.where(_coin(generator).to(x.device), _flip_lr(x), x)


@register_op("_image_random_flip_up_down",
             aliases=("image_random_flip_up_down",))
def _random_flip_ud(x, generator):
    """Vertical mirror with probability 0.5 (one coin for the call)."""
    return torch.where(_coin(generator).to(x.device), _flip_ud(x), x)


def brightness(x, f):
    """x * f in float32, cast back to x's dtype."""
    return _cast_to(x.to(torch.float32) * f, x.dtype)


def contrast(x, f):
    """Blend toward the luminance mean of the whole input by f (1 is the
    identity, 0 flat gray)."""
    xf = x.to(torch.float32)
    coef = torch.tensor(_LUMA, dtype=torch.float32, device=x.device)
    gray = torch.tensordot(xf, coef, dims=([-1], [0])).mean()
    return _cast_to(gray * (1.0 - f) + xf * f, x.dtype)


def saturation(x, f):
    """Blend toward each pixel's luminance by f (1 is the identity, 0
    fully desaturated)."""
    xf = x.to(torch.float32)
    coef = torch.tensor(_LUMA, dtype=torch.float32, device=x.device)
    gray = torch.tensordot(xf, coef, dims=([-1], [0]))[..., None]
    return _cast_to(gray * (1.0 - f) + xf * f, x.dtype)


@register_op("_image_random_brightness",
             aliases=("image_random_brightness",))
def _random_brightness(x, generator, min_factor=0.5, max_factor=1.5):
    """Scale the pixel values by a factor uniform in [min, max)."""
    f = _factor(generator, min_factor, max_factor).to(x.device)
    return brightness(x, f)


@register_op("_image_random_contrast", aliases=("image_random_contrast",))
def _random_contrast(x, generator, min_factor=0.5, max_factor=1.5):
    """:func:`contrast` by a factor uniform in [min, max)."""
    f = _factor(generator, min_factor, max_factor).to(x.device)
    return contrast(x, f)


@register_op("_image_random_saturation",
             aliases=("image_random_saturation",))
def _random_saturation(x, generator, min_factor=0.5, max_factor=1.5):
    """:func:`saturation` by a factor uniform in [min, max)."""
    f = _factor(generator, min_factor, max_factor).to(x.device)
    return saturation(x, f)
