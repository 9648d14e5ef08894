"""Tap-accumulation fused unit with an explicit batch tile: CUDA kernel +
plain PyTorch version.

Counterpart of ``candidate_tap`` in ``tools/scratch_convbn_probe.py``,
the probe of the fused Conv+BN unit's tap-accumulation form.  It
computes what ``fused_conv_unit`` computes, for NHWC x (N,H,W,Ci) and
weights already in tap layout ``w_taps`` (kh,kw,Ci,Co):

    u  = act_in ? relu(x * in_scale + in_bias) cast to x's dtype : x
         (zero padding AFTER the affine)
    y  = sum over taps (ky,kx) of u[window] @ w_taps[ky, kx], in fp32,
         cast to x's dtype
    s1 = sum y, s2 = sum (y - shift)^2 over N*Ho*Wo in fp32 from the cast
         y; exact zeros without ``want_stats``

and returns ``(y, s1, s2)`` with s1/s2 of shape (1, Co).

On a CUDA tensor the call runs the hand-written sm_90a kernel in
``csrc/convbn_tap.cu`` (built by ``_kernels``) or raises; CPU tensors take
:func:`candidate_tap_ref`.  The kernel is kernel 1's main loop reading
the weights straight from the tap layout, with kernel 1's tiles
(:func:`launch_plan`): its output rows are tiled without regard to
``nb``, which sized the TPU kernel's VMEM batch tile, and its s1/s2 are
per-tile partials summed in a fixed order, bit-identical from launch to
launch.  The plain version sums batch tiles of ``nb`` images in tile
order, as the TPU kernel's sequential grid does (its order inside a tile
is XLA's own); the tolerance on s1/s2 holds the difference of summation
orders.  A batch that ``nb`` does not divide raises on every device: the
TPU kernel's grid of ``N // nb`` tiles leaves the last ``N % nb`` images
of y unwritten and out of s1/s2.  The bf16 kernel takes Ci % 8 == 0 and
Co % 8 == 0 only; other shapes raise on the card and run on CPU tensors.
"""
from __future__ import annotations

import threading

import torch
import torch.nn.functional as F

from .. import _kernels
from ..base import MXNetError
from .fused_convbn import (_DTYPE_CODE, _affine_in, _aligned16, _out_hw,
                           scratch_rows, tile_for)

__all__ = ["candidate_tap", "candidate_tap_ref", "weight_taps",
           "launch_plan", "launch_count", "reset_launch_count"]

# launches of the CUDA kernel: one per wrapper call that launched it
_COUNT_LOCK = threading.Lock()
_LAUNCHES = [0]


def launch_count() -> int:
    with _COUNT_LOCK:
        return _LAUNCHES[0]


def reset_launch_count() -> None:
    with _COUNT_LOCK:
        _LAUNCHES[0] = 0


def weight_taps(w):
    """(Co, Ci, kh, kw) checkpoint layout -> (kh, kw, Ci, Co) tap layout,
    contiguous (counterpart of ``_weight_taps``, pallas_convbn.py:142)."""
    return w.permute(2, 3, 1, 0).contiguous()


def candidate_tap_ref(x, w_taps, in_scale, in_bias, shift, kernel, stride,
                      pad, act_in, want_stats, nb):
    """Plain PyTorch version: u in fp32 cast to x's dtype (padding after
    the affine), the conv in fp32, y cast to x's dtype, statistics in fp32
    from the cast y, summed tile by tile in tile order."""
    u = _affine_in(x, in_scale, in_bias, act_in)
    y = F.conv2d(u.permute(0, 3, 1, 2).float(),
                 w_taps.permute(3, 2, 0, 1).float(), stride=stride,
                 padding=pad)
    y = y.permute(0, 2, 3, 1).to(x.dtype).contiguous()
    n, co = y.shape[0], y.shape[-1]
    s1 = torch.zeros((1, co), dtype=torch.float32, device=y.device)
    s2 = torch.zeros((1, co), dtype=torch.float32, device=y.device)
    if want_stats:
        yf = y.float().reshape(n // nb, -1, co)
        d = yf - shift
        p1, p2 = yf.sum(dim=1), (d * d).sum(dim=1)
        for t in range(n // nb):
            s1, s2 = s1 + p1[t], s2 + p2[t]
    return y, s1, s2


def _check_nb(n, nb):
    if nb < 1 or n % nb:
        raise MXNetError(f"candidate_tap: batch tile nb={nb} must divide "
                         f"N={n} (the TPU kernel leaves the last N % nb "
                         f"images unwritten)")


def launch_plan(x_shape, co, kernel, stride, pad, dtype, nb):
    """(bm, bn, scratch rows) of one launch: kernel 1's tile for the same
    output at every ``nb`` (:func:`~.fused_convbn.tile_for`), or
    MXNetError for what the kernel does not take."""
    n, h, wd, ci = x_shape
    _check_nb(n, nb)
    if dtype == torch.bfloat16 and (ci % 8 or co % 8):
        raise MXNetError(f"candidate_tap: the bf16 kernel loads x in 16-byte "
                         f"runs of channels and the tap-layout weights by "
                         f"TMA rows of Co, so it takes Ci % 8 == 0 and "
                         f"Co % 8 == 0, got Ci={ci}, Co={co}")
    ho, wo = _out_hw(h, wd, kernel, stride, pad)
    m = n * ho * wo
    bm, bn = tile_for(m, co, dtype)
    return bm, bn, scratch_rows(-(-m // bm))


def _launch(x, w_taps, in_scale, in_bias, shift, kernel, stride, pad,
            act_in, want_stats, nb):
    """One launch of the CUDA kernel (plus its statistics reduction with
    ``want_stats``) on contiguous tensors of one CUDA device."""
    n, h, wd, ci = x.shape
    co = w_taps.shape[-1]
    bm, bn, rows = launch_plan(x.shape, co, kernel, stride, pad, x.dtype, nb)
    lib = _kernels.load()
    ho, wo = _out_hw(h, wd, kernel, stride, pad)
    dev = x.device
    x = _aligned16(x)
    w = _aligned16(w_taps)
    f32 = dict(dtype=torch.float32, device=dev)
    y = torch.empty((n, ho, wo, co), dtype=x.dtype, device=dev)
    if want_stats:
        part = torch.empty((2, rows, co), **f32)
        stats = torch.empty((2, 1, co), **f32)
        ptrs = (part[0].data_ptr(), part[1].data_ptr(), stats[0].data_ptr(),
                stats[1].data_ptr())
    else:
        stats = torch.zeros((2, 1, co), **f32)
        ptrs = (None,) * 4
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.mx_convbn_tap(
            _DTYPE_CODE[x.dtype], x.data_ptr(), w.data_ptr(),
            in_scale.data_ptr(), in_bias.data_ptr(), shift.data_ptr(),
            y.data_ptr(), *ptrs, n, h, wd, ci, co, kernel[0], kernel[1],
            stride[0], stride[1], pad[0], pad[1], nb, int(act_in),
            int(want_stats), bm, bn, rows, stream)
    if rc != 0:
        raise MXNetError(f"candidate_tap: CUDA launch failed: "
                         f"{_kernels.error_string(rc)} (code {rc})")
    with _COUNT_LOCK:
        _LAUNCHES[0] += 1
    return y, stats[0], stats[1]


def candidate_tap(x, w_taps, in_scale, in_bias, shift, *, kernel, stride,
                  pad, act_in, want_stats, nb):
    """The tap-accumulation unit with batch tile ``nb`` (see the module
    docstring).  x (N,H,W,Ci) bf16 or fp32, contiguous on the card;
    w_taps (kh,kw,Ci,Co) in x's dtype; in_scale/in_bias (Ci,) and shift
    (Co,), taken in fp32.  Returns (y, s1, s2), s1/s2 (1, Co) fp32."""
    kernel = tuple(int(k) for k in kernel)
    stride = tuple(int(s) for s in stride)
    pad = tuple(int(p) for p in pad)
    nb = int(nb)
    if x.dim() != 4 or w_taps.dim() != 4:
        raise MXNetError(f"candidate_tap: x must be NHWC and w_taps "
                         f"(kh,kw,Ci,Co), got {tuple(x.shape)} and "
                         f"{tuple(w_taps.shape)}")
    n, h, wd, ci = x.shape
    co = w_taps.shape[-1]
    if tuple(w_taps.shape[:3]) != (*kernel, ci):
        raise MXNetError(f"candidate_tap: w_taps {tuple(w_taps.shape)} does "
                         f"not fit kernel={kernel}, Ci={ci}")
    if x.dtype not in _DTYPE_CODE:
        raise MXNetError(f"candidate_tap: dtype {x.dtype} is not supported "
                         f"(bfloat16 or float32)")
    if w_taps.dtype != x.dtype:
        raise MXNetError(f"candidate_tap: w_taps dtype {w_taps.dtype} != x "
                         f"dtype {x.dtype}")
    _check_nb(n, nb)
    in_scale, in_bias, shift = (t.to(torch.float32)
                                for t in (in_scale, in_bias, shift))
    for name, t, n_ in (("in_scale", in_scale, ci), ("in_bias", in_bias, ci),
                        ("shift", shift, co)):
        if t.shape != (n_,):
            raise MXNetError(f"candidate_tap: {name} shape {tuple(t.shape)} "
                             f"!= ({n_},)")
    tensors = (x, w_taps, in_scale, in_bias, shift)
    devs = {t.device for t in tensors}
    if len(devs) != 1:
        raise MXNetError(f"candidate_tap: tensors on different devices "
                         f"{sorted(str(d) for d in devs)}")
    ho, wo = _out_hw(h, wd, kernel, stride, pad) if min(stride) >= 1 \
        else (0, 0)
    if ho <= 0 or wo <= 0 or co == 0 or min(pad) < 0:
        raise MXNetError(f"candidate_tap: empty output for x {tuple(x.shape)},"
                         f" Co={co}, kernel {kernel}, stride {stride}, pad "
                         f"{pad}")
    if x.device.type == "cpu":
        return candidate_tap_ref(*tensors, kernel, stride, pad, bool(act_in),
                                 bool(want_stats), nb)
    if x.device.type != "cuda":
        raise MXNetError(f"candidate_tap: unsupported device {x.device}")
    if not x.is_contiguous():
        raise MXNetError("candidate_tap: x must be contiguous NHWC")
    return _launch(x, w_taps.contiguous(), in_scale.contiguous(),
                   in_bias.contiguous(), shift.contiguous(), kernel, stride,
                   pad, bool(act_in), bool(want_stats), nb)
