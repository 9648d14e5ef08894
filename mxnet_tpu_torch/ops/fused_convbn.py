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

The unit is a ``torch.autograd.Function`` (the counterpart of the JAX
package's ``custom_vjp``, ``_unit_fwd``/``_unit_bwd``).  It saves
``(x, w, in_scale, in_bias, shift, y)`` and its backward follows
``_unit_bwd``'s rule by knob and shape: with MXNET_FUSED_CONVBN_BWD=1 a
stride-1 unit runs :func:`fused_conv_unit_bwd` (the CUDA kernel in
``csrc/fused_convbn_bwd.cu`` on the card, its plain version
:func:`fused_conv_unit_bwd_ref` on CPU tensors); every other unit takes
the dgrad/wgrad convolutions of PyTorch in the input dtype, the
counterpart of the XLA branch.  ``shift`` (the running mean) gets no
gradient.  Autograd never differentiates through the plain forward.

One dispatch rule, :func:`_dispatch_plan`, serves forward and backward
(``_dispatch_plan``, pallas_convbn.py:572).  ``single``: no mesh, or a
mesh of one device.  ``sharded``: a data-parallel mesh over ranks
(``_pallas_unit_sharded``/``_pallas_unit_bwd_sharded``), where x is
this rank's block of the batch.  The unit then runs on the local block
as above and sums s1/s2 over the ranks with one differentiable
``dist.all_reduce_sum`` (none without statistics).  Its backward is the
same per-block backward: it receives the global cotangents of s1/s2
through that sum's backward and returns this rank's partials of dw,
gscale and gbias, which the trainer's gradient all-reduce (dw, and γ
through the BN algebra) and the previous unit's statistics sum (the
rest) total.  Summing them here as well, as the JAX kernel does, would
count them once per rank.
"""
from __future__ import annotations

import threading

import torch
import torch.nn.functional as F

from .. import _kernels
from ..base import MXNetError
from ..parallel import dist
from ..parallel.mesh import mesh_shard_plan
from ..util import env

__all__ = ["fused_conv_unit", "fused_conv_unit_ref", "fused_conv_unit_bwd",
           "fused_conv_unit_bwd_ref", "launch_count", "reset_launch_count",
           "bwd_launch_count", "reset_bwd_launch_count"]

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

# launches of the CUDA kernels: one per wrapper call that launched one
# (forward, backward)
_COUNT_LOCK = threading.Lock()
_LAUNCHES = [0]
_BWD_LAUNCHES = [0]


def launch_count() -> int:
    with _COUNT_LOCK:
        return _LAUNCHES[0]


def reset_launch_count() -> None:
    with _COUNT_LOCK:
        _LAUNCHES[0] = 0


def bwd_launch_count() -> int:
    with _COUNT_LOCK:
        return _BWD_LAUNCHES[0]


def reset_bwd_launch_count() -> None:
    with _COUNT_LOCK:
        _BWD_LAUNCHES[0] = 0


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
    u = _affine_in(data, in_scale, in_bias, act_in)
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


# ---------------------------------------------------------------------------
# backward
# ---------------------------------------------------------------------------

def _fold_dy(y, gy, shift, gs1, gs2, want_stats):
    """dy_tot = gy + gs1 + 2(y - shift)·gs2 in fp32, cast to gy's dtype
    (d s1/dy = 1, d s2/dy = 2(y - shift)); gy itself without stats."""
    if not want_stats:
        return gy
    return (gy.float() + gs1 + 2.0 * (y.float() - shift) * gs2).to(gy.dtype)


def _affine_in(x, in_scale, in_bias, act_in):
    if not act_in:
        return x
    return (x.float() * in_scale + in_bias).clamp_min(0.0).to(x.dtype)


def _conv_grads(u, w, dy, stride, pad, dtype):
    """du (NHWC) and dw (Co,Ci,kh,kw) of conv(u, w) for the cotangent dy,
    computed in ``dtype``."""
    un = u.permute(0, 3, 1, 2).to(dtype)
    dn = dy.permute(0, 3, 1, 2).to(dtype)
    wd = w.to(dtype)
    du = torch.nn.grad.conv2d_input(un.shape, wd, dn, stride=stride,
                                    padding=pad)
    dw = torch.nn.grad.conv2d_weight(un, wd.shape, dn, stride=stride,
                                     padding=pad)
    return du.permute(0, 2, 3, 1), dw


def _input_grads(x, in_scale, in_bias, du, act_in):
    """gx, gscale, gbias from du: through the ReLU mask of the pre-ReLU
    affine and the affine itself (gscale sums gu·x with x in fp32)."""
    if not act_in:
        return du.to(x.dtype), torch.zeros_like(in_scale), \
            torch.zeros_like(in_bias)
    uf = x.float() * in_scale + in_bias
    gu = torch.where(uf > 0.0, du.float(), 0.0)
    gx = (gu * in_scale).to(x.dtype)
    return gx, (gu * x.float()).sum(dim=(0, 1, 2)), gu.sum(dim=(0, 1, 2))


def _unit_bwd_plain(x, w, in_scale, in_bias, shift, y, gy, gs1, gs2, stride,
                    pad, act_in, want_stats, conv_dtype):
    """(gx, dw, gscale, gbias) with dgrad and wgrad in ``conv_dtype``.
    In fp32 it is the kernel's plain version; in x's dtype it is the
    counterpart of ``_unit_bwd``'s XLA branch (pallas_convbn.py:710),
    where du rounds to that dtype before the mask and the sums."""
    dy = _fold_dy(y, gy, shift, gs1, gs2, want_stats)
    u = _affine_in(x, in_scale, in_bias, act_in)
    du, dw = _conv_grads(u, w, dy, stride, pad, conv_dtype)
    gx, gscale, gbias = _input_grads(x, in_scale, in_bias, du, act_in)
    return gx, dw.to(w.dtype), gscale, gbias


def fused_conv_unit_bwd_ref(x, w, in_scale, in_bias, shift, y, gy, gs1, gs2,
                            kernel, stride, pad, act_in, want_stats):
    """Plain PyTorch version of the backward kernel, with the TPU
    kernel's rounding points: dy_tot cast to gy's dtype, du accumulated
    and kept in fp32, dw in fp32 cast to w's dtype.  Returns (gx, dw,
    gscale, gbias); gscale and gbias are zeros without ``act_in``."""
    return _unit_bwd_plain(x, w, in_scale, in_bias, shift, y, gy, gs1, gs2,
                           stride, pad, act_in, want_stats, torch.float32)


def _aligned(*ts):
    return all(t.data_ptr() % 16 == 0 for t in ts)


def _launch_bwd(x, w, in_scale, in_bias, shift, y, gy, gs1, gs2, kernel,
                pad, act_in, want_stats):
    """One launch of the backward kernel (dgrad, wgrad and their
    reductions) on contiguous tensors of one CUDA device."""
    lib = _kernels.load()
    n, h, wd, ci = x.shape
    co = w.shape[0]
    ho, wo = _out_hw(h, wd, kernel, (1, 1), pad)
    dev = x.device
    f32 = dict(dtype=torch.float32, device=dev)
    gx = torch.empty_like(x)
    dw = torch.empty_like(w)
    if act_in:
        m_blocks = -(-(n * h * wd) // lib.mx_fused_conv_unit_bwd_block_m())
        gpart = torch.empty((2, m_blocks, ci), **f32)
        gscale = torch.empty(ci, **f32)
        gbias = torch.empty(ci, **f32)
    else:
        gpart = None
        gscale = torch.zeros(ci, **f32)
        gbias = torch.zeros(ci, **f32)
    splits = lib.mx_fused_conv_unit_bwd_splits(kernel[0], kernel[1], ci, co,
                                               n * ho * wo)
    wpart = torch.empty((splits, kernel[0] * kernel[1] * ci, co), **f32)
    # 16-byte vector loads need whole groups of 8 channels and aligned bases
    vec_ci = int(ci % 8 == 0 and _aligned(x))
    vec_co = int(co % 8 == 0 and _aligned(y, gy))
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.mx_fused_conv_unit_bwd(
            _DTYPE_CODE[x.dtype], x.data_ptr(), w.data_ptr(),
            in_scale.data_ptr(), in_bias.data_ptr(), shift.data_ptr(),
            y.data_ptr(), gy.data_ptr(), gs1.data_ptr(), gs2.data_ptr(),
            gx.data_ptr(), dw.data_ptr(), gscale.data_ptr(),
            gbias.data_ptr(), None if gpart is None else gpart.data_ptr(),
            wpart.data_ptr(), n, h, wd, ci, co, kernel[0], kernel[1],
            pad[0], pad[1], int(act_in), int(want_stats), splits, vec_ci,
            vec_co, stream)
    if rc != 0:
        raise MXNetError(f"fused_conv_unit_bwd: CUDA launch failed: "
                         f"{_kernels.error_string(rc)} (code {rc})")
    with _COUNT_LOCK:
        _BWD_LAUNCHES[0] += 1
    return gx, dw, gscale, gbias


def fused_conv_unit_bwd(x, w, in_scale, in_bias, shift, y, gy, gs1=None,
                        gs2=None, kernel=(1, 1), stride=(1, 1), pad=(0, 0),
                        act_in=False, want_stats=True):
    """The fused unit's backward (counterpart of ``_pallas_unit_bwd``):
    (gx, dw, gscale, gbias) for the cotangents (gy, gs1, gs2) of (y, s1,
    s2).  x, w, in_scale, in_bias and shift are the forward's inputs (all
    given), y its output; gs1/gs2 None are zeros.  The C-sized vectors
    are taken in fp32, as the forward takes them.  On CUDA tensors the
    kernel runs, stride (1, 1) only, or the call raises; on CPU tensors
    the plain version runs."""
    kernel = tuple(int(k) for k in kernel)
    stride = tuple(int(s_) for s_ in stride)
    pad = tuple(int(p_) for p_ in pad)
    co = w.shape[0]
    n, h, wd, ci = x.shape
    f32 = dict(dtype=torch.float32, device=x.device)
    gs1 = torch.zeros(co, **f32) if gs1 is None else gs1
    gs2 = torch.zeros(co, **f32) if gs2 is None else gs2
    in_scale, in_bias, shift, gs1, gs2 = (
        t.to(torch.float32) for t in (in_scale, in_bias, shift, gs1, gs2))
    for name, t, n_ in (("in_scale", in_scale, ci), ("in_bias", in_bias, ci),
                        ("shift", shift, co), ("gs1", gs1, co),
                        ("gs2", gs2, co)):
        if t.shape != (n_,):
            raise MXNetError(f"fused_conv_unit_bwd: {name} shape "
                             f"{tuple(t.shape)} != ({n_},)")
    ho, wo = _out_hw(h, wd, kernel, stride, pad)
    if tuple(y.shape) != (n, ho, wo, co) or gy.shape != y.shape:
        raise MXNetError(f"fused_conv_unit_bwd: y {tuple(y.shape)} / gy "
                         f"{tuple(gy.shape)} do not fit x {tuple(x.shape)} "
                         f"and w {tuple(w.shape)}")
    tensors = (x, w, in_scale, in_bias, shift, y, gy, gs1, gs2)
    devs = {t.device for t in tensors}
    if len(devs) != 1:
        raise MXNetError(f"fused_conv_unit_bwd: tensors on different "
                         f"devices {sorted(str(d) for d in devs)}")
    if x.device.type == "cpu":
        return fused_conv_unit_bwd_ref(x, w, in_scale, in_bias, shift, y, gy,
                                       gs1, gs2, kernel, stride, pad,
                                       bool(act_in), bool(want_stats))
    if x.device.type != "cuda":
        raise MXNetError(f"fused_conv_unit_bwd: unsupported device "
                         f"{x.device}")
    if stride != (1, 1):
        raise MXNetError(f"fused_conv_unit_bwd: the kernel takes stride "
                         f"(1, 1) only, got {stride}")
    if x.dtype not in _DTYPE_CODE or {w.dtype, y.dtype, gy.dtype} \
            != {x.dtype}:
        raise MXNetError(f"fused_conv_unit_bwd: x, w, y and gy must share "
                         f"one dtype of {sorted(map(str, _DTYPE_CODE))}, got "
                         f"{x.dtype}, {w.dtype}, {y.dtype}, {gy.dtype}")
    return _launch_bwd(*(t.contiguous() for t in tensors), kernel, pad,
                       bool(act_in), bool(want_stats))


# ---------------------------------------------------------------------------
# the autograd unit
# ---------------------------------------------------------------------------

def _dispatch_plan() -> str:
    """The plan of forward and backward, "single" or "sharded" (see the
    module docstring)."""
    return "single" if mesh_shard_plan() is None else "sharded"


class _FusedConvUnitFn(torch.autograd.Function):
    """Forward: the CUDA kernel on the card, the plain version on CPU
    tensors, returning (y, s1, s2) with stats and y alone without.
    Backward: ``_unit_bwd``'s rule (see the module docstring)."""

    @staticmethod
    def forward(ctx, x, w, in_scale, in_bias, shift, kernel, stride, pad,
                act_in, want_stats):
        if x.device.type == "cpu":
            y, s1, s2 = fused_conv_unit_ref(x, w, in_scale, in_bias, shift,
                                            kernel, stride, pad, act_in,
                                            want_stats)
        else:
            y, s1, s2 = _launch(x, w, in_scale, in_bias, shift, kernel,
                                stride, pad, act_in, want_stats)
        ctx.save_for_backward(x, w, in_scale, in_bias, shift, y)
        ctx.conf = (kernel, stride, pad, act_in, want_stats)
        return (y, s1, s2) if want_stats else y

    @staticmethod
    def backward(ctx, gy, gs1=None, gs2=None):
        x, w, in_scale, in_bias, shift, y = ctx.saved_tensors
        kernel, stride, pad, act_in, want_stats = ctx.conf
        co = w.shape[0]
        f32 = dict(dtype=torch.float32, device=x.device)
        gy = torch.zeros_like(y) if gy is None else gy
        gs1 = torch.zeros(co, **f32) if gs1 is None else gs1
        gs2 = torch.zeros(co, **f32) if gs2 is None else gs2
        args = (x, w, in_scale, in_bias, shift, y, gy, gs1, gs2)
        if env.get_bool("MXNET_FUSED_CONVBN_BWD") and stride == (1, 1):
            gx, dw, gscale, gbias = fused_conv_unit_bwd(
                *args, kernel=kernel, stride=stride, pad=pad, act_in=act_in,
                want_stats=want_stats)
        else:
            gx, dw, gscale, gbias = _unit_bwd_plain(
                *args, stride, pad, act_in, want_stats, conv_dtype=x.dtype)
        # shift is a running statistic: no gradient (pallas_convbn.py:742)
        return gx, dw, gscale, gbias, None, None, None, None, None, None


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
    sum-of-squares of y_raw.  Without ``want_stats`` the call returns
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
    if dev.type not in ("cpu", "cuda"):
        raise MXNetError(f"fused_conv_unit: unsupported device {dev}")
    if dev.type == "cuda":
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
        if _dispatch_plan() == "sharded":
            y, s1, s2 = out
            s1, s2 = dist.all_reduce_sum(torch.stack([s1, s2])).unbind(0)
            return y, s1, s2
        return out
    zeros = _zero_stats(dev, co)
    return out, zeros, zeros
