"""Cross-layer fused Conv+BN+ReLU unit: CUDA kernel + plain PyTorch version.

Counterpart of ``mxnet_tpu/ops/pallas_convbn.py``.  The unit computes,
for one conv layer inside a conv->BN->ReLU chain, in NHWC:

    u  = act(x * in_scale + in_bias)        # the previous BatchNorm+ReLU,
                                            # applied while reading x
    y  = conv(u, w)                         # this layer's raw conv output
    s1 = sum_c(y); s2 = sum_c((y-shift)^2)  # BN statistics of y

On a CUDA tensor the unit runs the hand-written sm_90a kernel in
``csrc/fused_convbn.cu`` (built by ``_kernels``) or raises: there is no
probe, no cache of failed shapes and no fallback to the plain version.
On CPU tensors it runs :func:`fused_conv_unit_ref`, the plain version
the tests hold the JAX package against.  A mix of CPU and CUDA tensors
raises.

The kernel is wrapped in a ``torch.autograd.Function`` whose backward
raises: the backward kernel (``_pallas_unit_bwd``) is ported with the
training slice.
"""
from __future__ import annotations

import threading

import torch
import torch.nn.functional as F

from .. import _kernels
from ..base import MXNetError

__all__ = ["fused_conv_unit", "fused_conv_unit_ref", "launch_count",
           "reset_launch_count"]

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

# launches of the CUDA kernel: one per wrapper call that launched it
_COUNT_LOCK = threading.Lock()
_LAUNCHES = [0]


def launch_count() -> int:
    with _COUNT_LOCK:
        return _LAUNCHES[0]


def reset_launch_count() -> None:
    with _COUNT_LOCK:
        _LAUNCHES[0] = 0


# read-only fp32 zeros per (device, Co): the s1/s2 of a launch without
# stats, so the served path allocates and fills nothing for them
_ZEROS = {}


def _zero_stats(dev, co):
    key = (dev, co)
    z = _ZEROS.get(key)
    if z is None:
        z = _ZEROS.setdefault(key, torch.zeros(co, dtype=torch.float32,
                                               device=dev))
    return z


def _out_hw(h, w, kernel, stride, pad):
    ho = (h + 2 * pad[0] - kernel[0]) // stride[0] + 1
    wo = (w + 2 * pad[1] - kernel[1]) // stride[1] + 1
    return ho, wo


def fused_conv_unit_ref(data, weight, in_scale, in_bias, shift, kernel,
                        stride, pad, act_in, want_stats):
    """Plain PyTorch version: u in fp32, cast to x's dtype (padding after
    the affine), the conv in fp32, y cast to x's dtype, statistics in
    fp32 from the cast y (zeros when ``want_stats`` is off)."""
    if act_in:
        u = (data.float() * in_scale + in_bias).clamp_min(0.0).to(data.dtype)
    else:
        u = data
    y = F.conv2d(u.permute(0, 3, 1, 2).float(), weight.float(),
                 stride=stride, padding=pad)
    y = y.permute(0, 2, 3, 1).to(data.dtype).contiguous()
    co = y.shape[-1]
    if want_stats:
        yf = y.float()
        s1 = yf.sum(dim=(0, 1, 2))
        d = yf - shift
        s2 = (d * d).sum(dim=(0, 1, 2))
    else:
        s1 = torch.zeros(co, dtype=torch.float32, device=y.device)
        s2 = torch.zeros(co, dtype=torch.float32, device=y.device)
    return y, s1, s2


def _launch(x, w, in_scale, in_bias, shift, kernel, stride, pad, act_in,
            want_stats):
    """One launch of the CUDA kernel (plus its stats reduction); s1/s2
    are None without stats."""
    lib = _kernels.load()
    n, h, wd, ci = x.shape
    co = w.shape[0]
    ho, wo = _out_hw(h, wd, kernel, stride, pad)
    dev = x.device
    y = torch.empty((n, ho, wo, co), dtype=x.dtype, device=dev)
    if want_stats:
        m_blocks = -(-(n * ho * wo) // lib.mx_fused_conv_unit_block_m())
        part1 = torch.empty((m_blocks, co), dtype=torch.float32, device=dev)
        part2 = torch.empty((m_blocks, co), dtype=torch.float32, device=dev)
        s1 = torch.empty(co, dtype=torch.float32, device=dev)
        s2 = torch.empty(co, dtype=torch.float32, device=dev)
        ptrs = (part1.data_ptr(), part2.data_ptr(), s1.data_ptr(),
                s2.data_ptr())
    else:
        s1 = s2 = None
        ptrs = (None, None, None, None)
    # 16-byte vector loads of x need Ci % 8 == 0 and an aligned base
    vec = int(ci % 8 == 0 and x.data_ptr() % 16 == 0)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.mx_fused_conv_unit(
            _DTYPE_CODE[x.dtype], x.data_ptr(), w.data_ptr(),
            in_scale.data_ptr(), in_bias.data_ptr(), shift.data_ptr(),
            y.data_ptr(), *ptrs, n, h, wd, ci, co, kernel[0], kernel[1],
            stride[0], stride[1], pad[0], pad[1], int(act_in),
            int(want_stats), vec, stream)
    if rc != 0:
        raise MXNetError(f"fused_conv_unit: CUDA launch failed: "
                         f"{_kernels.error_string(rc)} (code {rc})")
    with _COUNT_LOCK:
        _LAUNCHES[0] += 1
    return y, s1, s2


class _FusedConvUnitFn(torch.autograd.Function):
    """Forward: the CUDA kernel, returning (y, s1, s2) with stats and y
    alone without.  Backward: not in this slice."""

    @staticmethod
    def forward(ctx, x, w, in_scale, in_bias, shift, kernel, stride, pad,
                act_in, want_stats):
        y, s1, s2 = _launch(x, w, in_scale, in_bias, shift, kernel, stride,
                            pad, act_in, want_stats)
        return (y, s1, s2) if want_stats else y

    @staticmethod
    def backward(ctx, *grads):
        raise NotImplementedError(
            "fused_conv_unit has no backward yet: its backward kernel "
            "(the counterpart of _pallas_unit_bwd) is ported with the "
            "training slice")


def fused_conv_unit(data, weight, in_scale=None, in_bias=None, shift=None,
                    kernel=(1, 1), stride=(1, 1), pad=(0, 0), act_in=False,
                    want_stats=True):
    """Fused (input-affine+ReLU) -> conv -> (BN stats) unit, NHWC.

    data (N,H,W,Ci) raw previous-layer conv output, bf16 or fp32,
    contiguous; weight (Co,Ci,kh,kw) in the layout-independent
    checkpoint layout and data's dtype; in_scale/in_bias the per-channel
    affine that normalizes `data` (None = identity); shift the variance
    shift for this layer's stats (the running mean; None = zeros).
    Returns (y_raw, s1, s2) with s1/s2 fp32 per-channel sum / shifted
    sum-of-squares of y_raw.  Without ``want_stats`` a CUDA call returns
    for both one shared, read-only zero tensor per (device, Co).
    """
    kernel = tuple(int(k) for k in kernel)
    stride = tuple(int(s) for s in stride)
    pad = tuple(int(p) for p in pad)
    if data.dim() != 4 or weight.dim() != 4:
        raise MXNetError(f"fused_conv_unit: data must be NHWC and weight "
                         f"(Co,Ci,kh,kw), got {tuple(data.shape)} and "
                         f"{tuple(weight.shape)}")
    ci = data.shape[-1]
    co = weight.shape[0]
    if weight.shape[1] != ci or tuple(weight.shape[2:]) != kernel:
        raise MXNetError(f"fused_conv_unit: weight {tuple(weight.shape)} "
                         f"does not fit Ci={ci}, kernel={kernel}")
    if data.dtype not in _DTYPE_CODE:
        raise MXNetError(f"fused_conv_unit: dtype {data.dtype} is not "
                         f"supported (bfloat16 or float32)")
    if weight.dtype != data.dtype:
        raise MXNetError(f"fused_conv_unit: weight dtype {weight.dtype} != "
                         f"data dtype {data.dtype}")
    dev = data.device
    f32 = dict(dtype=torch.float32, device=dev)
    in_scale = torch.ones(ci, **f32) if in_scale is None \
        else in_scale.to(torch.float32)
    in_bias = torch.zeros(ci, **f32) if in_bias is None \
        else in_bias.to(torch.float32)
    shift = torch.zeros(co, **f32) if shift is None \
        else shift.to(torch.float32)
    for name, t, n_ in (("in_scale", in_scale, ci), ("in_bias", in_bias, ci),
                        ("shift", shift, co)):
        if t.shape != (n_,):
            raise MXNetError(f"fused_conv_unit: {name} shape "
                             f"{tuple(t.shape)} != ({n_},)")
    devs = {t.device for t in (data, weight, in_scale, in_bias, shift)}
    if len(devs) != 1:
        raise MXNetError(f"fused_conv_unit: tensors on different devices "
                         f"{sorted(str(d) for d in devs)}")
    if dev.type == "cpu":
        return fused_conv_unit_ref(data, weight, in_scale, in_bias, shift,
                                   kernel, stride, pad, bool(act_in),
                                   bool(want_stats))
    if dev.type != "cuda":
        raise MXNetError(f"fused_conv_unit: unsupported device {dev}")
    if not data.is_contiguous():
        raise MXNetError("fused_conv_unit: data must be contiguous NHWC")
    ho, wo = _out_hw(data.shape[1], data.shape[2], kernel, stride, pad)
    if ho <= 0 or wo <= 0 or min(stride) < 1 or min(pad) < 0:
        raise MXNetError(f"fused_conv_unit: empty output for shape "
                         f"{tuple(data.shape)}, kernel {kernel}, stride "
                         f"{stride}, pad {pad}")
    out = _FusedConvUnitFn.apply(
        data, weight.contiguous(), in_scale.contiguous(),
        in_bias.contiguous(), shift.contiguous(), kernel, stride, pad,
        bool(act_in), bool(want_stats))
    if want_stats:
        return out
    zeros = _zero_stats(dev, co)
    return out, zeros, zeros
