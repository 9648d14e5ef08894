"""int8 convolution with int32 accumulation: CUDA kernel + plain version.

``quantized_conv`` and ``quantized_fully_connected`` (``ops/quantization``)
compute here.  The JAX package gives them to ``lax.conv_general_dilated``
and ``lax.dot_general`` at ``preferred_element_type=int32``, which its TPU
runs natively; PyTorch has no int8 convolution on CUDA, so on CUDA tensors
:func:`int8_conv` launches the hand-written ``sm_90a`` kernel in
``csrc/int8_conv.cu`` (an implicit GEMM on ``mma.sync`` s8/s32), or
raises; on CPU tensors it runs :func:`int8_conv_ref`, the plain version:
``F.conv2d`` in float64 cast to int32, exact while every partial sum stays
under 2^53 (ResNet-50's largest K, 3·3·512 products of at most 127², is
far below).  There is no fallback on the card.

The kernel reads x as NHWC int8 (an NCHW input is permuted once by the
wrapper), the weight as (G, Co/G, Kpad) with K ordered (kh, kw, ci) and
zero-padded to a multiple of 64 (the wrapper lays it out from OIHW), and
writes the int32 output in the input's layout through strides.  It takes
any stride, padding, dilation and group count of a 1-d or 2-d
convolution; a 3-d one raises on CUDA before any launch.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .. import _kernels
from ..base import MXNetError

__all__ = ["int8_conv", "int8_conv_ref", "int8_conv_launch_count",
           "reset_int8_conv_launch_count", "weight_layout", "launch"]

# the launch counter of each calling site: "fc" for quantized_fully_
# connected, "conv" for every other call
_NAMES = {"conv": "int8_conv", "fc": "int8_conv_fc"}
_KSTEP = 64  # bytes of K a kernel stage; Kpad is a multiple of it


def int8_conv_launch_count(site=None) -> int:
    """Launches of the kernel from one site ("conv" or "fc"), or from
    both."""
    if site is None:
        return sum(_kernels.launch_count(n) for n in _NAMES.values())
    return _kernels.launch_count(_NAMES[site])


def reset_int8_conv_launch_count() -> None:
    for n in _NAMES.values():
        _kernels.reset_launch_count(n)


def _geometry(weight, stride, pad, dilate):
    nd = weight.dim() - 2
    stride = tuple(stride) if stride else (1,) * nd
    pad = tuple(pad) if pad else (0,) * nd
    dilate = tuple(dilate) if dilate else (1,) * nd
    return nd, stride, pad, dilate


def int8_conv_ref(data, weight, stride=(), pad=(), dilate=(), num_group=1,
                  channels_last=False):
    """The plain version: the convolution in float64 (exact for these
    sums), cast to int32.  ``data`` is (N, C, *spatial) or, with
    ``channels_last``, (N, *spatial, C); ``weight`` is (Co, C/G,
    *kernel); the output is in the data's layout."""
    nd, stride, pad, dilate = _geometry(weight, stride, pad, dilate)
    x = data.double()
    if channels_last:
        x = x.permute(0, x.dim() - 1, *range(1, x.dim() - 1))
    conv = (F.conv1d, F.conv2d, F.conv3d)[nd - 1]
    y = conv(x, weight.double(), stride=stride, padding=pad,
             dilation=dilate, groups=int(num_group)).to(torch.int32)
    if channels_last:
        y = y.permute(0, *range(2, y.dim()), 1)
    return y


def weight_layout(weight, num_group):
    """OIHW int8 -> (G, Co/G, Kpad): K ordered (kh, kw, ci), zero past K,
    Kpad the next multiple of 64."""
    co = weight.shape[0]
    w = weight.permute(0, *range(2, weight.dim()), 1).reshape(
        int(num_group), co // int(num_group), -1)
    k = w.shape[-1]
    kpad = -(-k // _KSTEP) * _KSTEP
    if kpad != k:
        w = F.pad(w, (0, kpad - k))
    return w.contiguous(), kpad


def int8_conv(data, weight, stride=(), pad=(), dilate=(), num_group=1,
              channels_last=False, site="conv"):
    """int8 data and weight -> int32 output in the data's layout; the
    kernel on CUDA tensors, :func:`int8_conv_ref` on CPU tensors.  A
    launch counts to ``site``'s counter (``"conv"`` or ``"fc"``)."""
    if data.dtype != torch.int8 or weight.dtype != torch.int8:
        raise MXNetError("int8_conv expects int8 data and weight "
                         f"(got {data.dtype} and {weight.dtype})")
    if data.device.type != "cuda":
        return int8_conv_ref(data, weight, stride, pad, dilate, num_group,
                             channels_last)
    if weight.device != data.device:
        raise MXNetError(f"int8_conv: weight on {weight.device}, data on "
                         f"{data.device}")
    nd, stride, pad, dilate = _geometry(weight, stride, pad, dilate)
    if nd == 1:  # a 1-d convolution is a 2-d one over a height of 1
        sq = 1 if channels_last else 2
        y = int8_conv(data.unsqueeze(sq), weight.unsqueeze(2), (1,) + stride,
                      (0,) + pad, (1,) + dilate, num_group, channels_last,
                      site)
        return y.squeeze(sq)
    if nd != 2:
        raise MXNetError(f"int8_conv: the CUDA kernel takes 1-d and 2-d "
                         f"convolutions (got {nd}-d)")
    g = int(num_group)
    x = data.contiguous() if channels_last else \
        data.permute(0, 2, 3, 1).contiguous()
    n, h, w_, c = x.shape
    co, cig, kh, kw = weight.shape
    if c != cig * g or co % g:
        raise MXNetError(f"int8_conv: {c} input channels, weight "
                         f"{tuple(weight.shape)}, num_group {g}")
    ho = (h + 2 * pad[0] - dilate[0] * (kh - 1) - 1) // stride[0] + 1
    wo = (w_ + 2 * pad[1] - dilate[1] * (kw - 1) - 1) // stride[1] + 1
    if ho <= 0 or wo <= 0:
        raise MXNetError(f"int8_conv: empty output ({ho}, {wo})")
    wl, kpad = weight_layout(weight, g)
    if channels_last:
        y = torch.empty((n, ho, wo, co), dtype=torch.int32, device=x.device)
    else:
        y = torch.empty((n, co, ho, wo), dtype=torch.int32, device=x.device)
    return launch(x, wl, kpad, y, channels_last, (kh, kw), stride, pad,
                  dilate, g, site)


def launch(x, wl, kpad, y, channels_last, kernel, stride, pad, dilate,
           num_group, site="conv"):
    """One launch of the kernel on the caller's stream: x NHWC int8
    contiguous, ``wl`` from :func:`weight_layout`, y int32 (N, Co, Ho,
    Wo) or, with ``channels_last``, (N, Ho, Wo, Co)."""
    n, h, w_, c = x.shape
    if channels_last:
        _, ho, wo, co = y.shape
        ys = (ho * wo * co, 1, wo * co, co)
    else:
        _, co, ho, wo = y.shape
        ys = (co * ho * wo, ho * wo, wo, 1)
    lib = _kernels.load()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.mx_int8_conv(
            x.data_ptr(), wl.data_ptr(), y.data_ptr(), n, h, w_, c, ho, wo,
            co, int(num_group), kernel[0], kernel[1], stride[0], stride[1],
            pad[0], pad[1], dilate[0], dilate[1], kpad, *ys, stream)
        if rc == 0:
            _kernels.count_launch(_NAMES[site])
    if rc != 0:
        raise MXNetError(f"int8_conv: CUDA launch failed: "
                         f"{_kernels.error_string(rc)} (code {rc})")
    return y
