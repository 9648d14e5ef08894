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
The wrapper hands the kernel its weights in OHWI order
(:func:`weight_ohwi`), picks its output tile from the shape
(:func:`tile_for`) and sizes its statistics scratch
(:func:`scratch_rows`); the bf16 kernel takes Ci % 8 == 0 only.
On CPU tensors it runs :func:`fused_conv_unit_ref`, the plain version
the tests hold the JAX package against.  A mix of CPU and CUDA tensors
raises.

The unit is a ``torch.autograd.Function`` (the counterpart of the JAX
package's ``custom_vjp``, ``_unit_fwd``/``_unit_bwd``).  It saves
``(x, w, in_scale, in_bias, shift, y)`` and its backward follows
``_unit_bwd``'s rule by knob and shape: with MXNET_FUSED_CONVBN_BWD=1 a
stride-1 unit runs :func:`fused_conv_unit_bwd` (the CUDA kernel in
``csrc/fused_convbn_bwd.cu`` on the card, planned by
:func:`bwd_launch_plan` and fed the flipped weights of
:func:`weight_dgrad`; its plain version :func:`fused_conv_unit_bwd_ref`
on CPU tensors); every other unit takes
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

import functools
from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from .. import _kernels
from ..base import MXNetError
from ..parallel import dist
from ..parallel.mesh import batch_group, mesh_shard_plan
from ..util import env
from .registry import register_op

__all__ = ["fused_conv_unit", "fused_conv_unit_ref", "fused_conv_unit_bwd",
           "fused_conv_unit_bwd_ref", "launch_count", "reset_launch_count",
           "bwd_launch_count", "reset_bwd_launch_count", "weight_ohwi",
           "tile_for", "scratch_rows", "launch_plan", "weight_dgrad",
           "bwd_launch_plan", "BwdPlan"]

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

# launches of the CUDA kernels (``_kernels.count_launch``): one per
# wrapper call that launched one, and a graph's replay adds those its
# capture recorded (forward, backward)
_FWD, _BWD = "fused_conv_unit", "fused_conv_unit_bwd"


def launch_count() -> int:
    return _kernels.launch_count(_FWD)


def reset_launch_count() -> None:
    _kernels.reset_launch_count(_FWD)


def bwd_launch_count() -> int:
    return _kernels.launch_count(_BWD)


def reset_bwd_launch_count() -> None:
    _kernels.reset_launch_count(_BWD)


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


# The kernel's output tiles (rows of M x channels of Co).  bf16 takes
# 128 x 128 (one 384-thread block an SM) where Co >= 128 and that gives at
# least two tiles for each of the H100's 132 SMs, else 64 x 64 (two
# 256-thread blocks an SM); fp32 has one tile.  The statistics reduction
# sums REDUCE_ROWS partial rows a block.
TILES_BF16 = ((128, 128), (64, 64))
TILE_FP32 = (128, 64)
MIN_BLOCKS = 2 * 132
REDUCE_ROWS = 128


def weight_ohwi(w):
    """(Co, Ci, kh, kw) checkpoint layout -> (Co, kh, kw, Ci), contiguous:
    the kernel's weights as K-major rows.  A view for 1x1 convs; one copy
    for larger ones (the counterpart of ``_weight_taps``, transposed)."""
    return w.permute(0, 2, 3, 1).contiguous()


def tile_for(m, co, dtype):
    """(bm, bn), the kernel's output tile for an M x Co output."""
    if dtype == torch.float32:
        return TILE_FP32
    big, small = TILES_BF16
    if co >= 128 and -(-m // big[0]) * -(-co // big[1]) >= MIN_BLOCKS:
        return big
    return small


def scratch_rows(tiles):
    """Partial rows per statistics array for `tiles` m-tiles: the tiles'
    own, then each reduction pass's that leaves more than one row."""
    rows = r = tiles
    while r > REDUCE_ROWS:
        r = -(-r // REDUCE_ROWS)
        rows += r
    return rows


def launch_plan(x_shape, co, kernel, stride, pad, dtype):
    """(bm, bn, scratch rows) of one launch, or MXNetError for a shape the
    kernel does not take."""
    n, h, wd, ci = x_shape
    if dtype == torch.bfloat16 and ci % 8:
        raise MXNetError(f"fused_conv_unit: the bf16 kernel loads x in "
                         f"16-byte runs of channels and takes Ci % 8 == 0, "
                         f"got Ci={ci}")
    ho, wo = _out_hw(h, wd, kernel, stride, pad)
    m = n * ho * wo
    bm, bn = tile_for(m, co, dtype)
    return bm, bn, scratch_rows(-(-m // bm))


def _aligned16(t):
    """t itself if its data is 16-byte aligned, else an aligned copy."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _launch(x, w_ohwi, in_scale, in_bias, shift, kernel, stride, pad,
            act_in, want_stats):
    """One launch of the CUDA kernel (plus its stats reduction) on
    contiguous tensors of one CUDA device, w in OHWI order
    (:func:`weight_ohwi`); s1/s2 are None without stats."""
    lib = _kernels.load()
    n, h, wd, ci = x.shape
    co = w_ohwi.shape[0]
    bm, bn, rows = launch_plan(x.shape, co, kernel, stride, pad, x.dtype)
    ho, wo = _out_hw(h, wd, kernel, stride, pad)
    dev = x.device
    x = _aligned16(x)
    w = _aligned16(w_ohwi)
    y = torch.empty((n, ho, wo, co), dtype=x.dtype, device=dev)
    if want_stats:
        part = torch.empty((2, rows, co), dtype=torch.float32, device=dev)
        s1 = torch.empty(co, dtype=torch.float32, device=dev)
        s2 = torch.empty(co, dtype=torch.float32, device=dev)
        ptrs = (part[0].data_ptr(), part[1].data_ptr(), s1.data_ptr(),
                s2.data_ptr())
    else:
        s1 = s2 = None
        ptrs = (None, None, None, None)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.mx_fused_conv_unit(
            _DTYPE_CODE[x.dtype], x.data_ptr(), w.data_ptr(),
            in_scale.data_ptr(), in_bias.data_ptr(), shift.data_ptr(),
            y.data_ptr(), *ptrs, n, h, wd, ci, co, kernel[0], kernel[1],
            stride[0], stride[1], pad[0], pad[1], int(act_in),
            int(want_stats), bm, bn, rows, stream)
        if rc == 0:
            _kernels.count_launch(_FWD)
    if rc != 0:
        raise MXNetError(f"fused_conv_unit: CUDA launch failed: "
                         f"{_kernels.error_string(rc)} (code {rc})")
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


# The backward kernel's plan.  bf16: the dgrad tile is the forward's rule
# with Ci as the output width (tile_for), the wgrad tile wgrad_tile's, and
# wgrad's K = N*Ho*Wo is cut into `splits` ranges of whole 64-pixel
# stages (wgrad_splits).  fp32: the FMA kernels' fixed tiles and their
# 32-pixel K chunks.
SMS = 132
PEAK_BF16 = 989e12   # dense bf16 tensor-core FLOP/s, H100 SXM
PEAK_BYTES = 3.35e12
WGRAD_STAGE = 64     # pixels of one wgrad K stage (bf16)
WGRAD_MIN_STAGES = 4
WGRAD_MAX_SPLITS = 1024
WGRAD_FILL_S = 2e-6  # pipeline fill and epilogue of one wave of items
BWD_TILES_FP32 = ((128, 64), (64, 64))  # dgrad, wgrad
FP32_WGRAD_CHUNK = 32
FP32_WGRAD_BLOCKS = 4 * SMS


class BwdPlan(NamedTuple):
    """One launch of the backward kernel: tiles, splits and scratch."""
    dgrad_tile: Tuple[int, int]   # (rows of N*H*W, channels of Ci)
    m_tiles: int                  # dgrad tiles along N*H*W
    part_rows: int                # rows of each gscale/gbias partial array
    wgrad_tile: Tuple[int, int]   # (channels of Ci, channels of Co)
    splits: int                   # wgrad K ranges
    co_pad: int                   # dy_tot's row pitch (bf16)
    wpart_floats: int             # fp32 wgrad partials: splits*KH*KW*Ci*Co
    dy_elems: int                 # bf16 dy_tot scratch (0: gy itself)


def wgrad_tile(ci, co):
    """bf16 wgrad tile (channels of Ci, channels of Co): 128 x 256 where
    both are wide, else 128 or 64 along each."""
    if ci >= 128 and co >= 256:
        return 128, 256
    return 128 if ci >= 128 else 64, 128 if co >= 128 else 64


def wgrad_splits(khw, ci, co, m_out, tile):
    """bf16 wgrad K ranges: the count that minimises an estimate of the
    time, waves of (tile, range) items at the tensor cores' rate plus the
    partials' bytes written and read, with at least one item an SM where
    the stages allow it; every range at least WGRAD_MIN_STAGES stages."""
    bm, bn = tile
    tiles = khw * -(-ci // bm) * -(-co // bn)
    resident = SMS * (1 if bm == 128 else 2)
    stages = -(-m_out // WGRAD_STAGE)
    most = max(1, min(stages // WGRAD_MIN_STAGES, WGRAD_MAX_SPLITS))
    least = min(most, -(-SMS // tiles))
    flops = 2.0 * m_out * co * ci * khw
    part_s = 2.0 * khw * ci * co * 4 / PEAK_BYTES

    def est(s):
        waves = -(-tiles * s // resident)
        return (waves * (flops / (tiles * s) * resident / PEAK_BF16
                         + WGRAD_FILL_S) + s * part_s)
    return min(range(least, most + 1), key=lambda s: (est(s), s))


def bwd_launch_plan(x_shape, co, kernel, pad, dtype, want_stats=True):
    """The :class:`BwdPlan` of one stride-1 launch, or MXNetError for a
    shape the kernel does not take.  Plans are cached by shape: a
    training step asks for the same few at every step."""
    return _bwd_plan(tuple(int(d) for d in x_shape), int(co), tuple(kernel),
                     tuple(pad), dtype, bool(want_stats))


@functools.lru_cache(maxsize=256)
def _bwd_plan(x_shape, co, kernel, pad, dtype, want_stats):
    n, h, wd, ci = x_shape
    if dtype == torch.bfloat16 and ci % 8:
        raise MXNetError(f"fused_conv_unit_bwd: the bf16 kernel moves x "
                         f"and gx in 16-byte runs of channels and takes "
                         f"Ci % 8 == 0, got Ci={ci}")
    ho, wo = _out_hw(h, wd, kernel, (1, 1), pad)
    khw = kernel[0] * kernel[1]
    m_in, m_out = n * h * wd, n * ho * wo
    if dtype == torch.float32:
        dtile, wtile = BWD_TILES_FP32
        tiles = khw * -(-ci // wtile[0]) * -(-co // wtile[1])
        chunks = -(-m_out // FP32_WGRAD_CHUNK)
        splits = max(1, min(-(-FP32_WGRAD_BLOCKS // tiles),
                            max(chunks // 4, 1), WGRAD_MAX_SPLITS))
        co_pad, dy = co, 0
    else:
        dtile = tile_for(m_in, ci, dtype)
        wtile = wgrad_tile(ci, co)
        splits = wgrad_splits(khw, ci, co, m_out, wtile)
        co_pad = -(-co // 8) * 8
        dy = 0 if not want_stats and co == co_pad else m_out * co_pad
    m_tiles = -(-m_in // dtile[0])
    return BwdPlan(dtile, m_tiles, scratch_rows(m_tiles), wtile, splits,
                   co_pad, splits * khw * ci * co, dy)


def weight_dgrad(w, co_pad):
    """(Co, Ci, kh, kw) -> (Ci, kh, kw, co_pad), contiguous, flipped in
    (kh, kw), zeros past Co: dgrad's weights as K-major rows, so dgrad is
    the forward convolution of dy with them at pad kh-1-ph."""
    co, ci, kh, kw = w.shape
    wf = (w if kh == kw == 1 else w.flip(2, 3)).permute(1, 2, 3, 0)
    if co_pad == co:
        return wf.contiguous()
    out = w.new_zeros((ci, kh, kw, co_pad))
    out[..., :co] = wf
    return out


def _launch_bwd(x, w, in_scale, in_bias, shift, y, gy, gs1, gs2, kernel,
                pad, act_in, want_stats):
    """One launch of the backward kernel (fold, dgrad, wgrad and their
    reductions) on contiguous tensors of one CUDA device."""
    lib = _kernels.load()
    n, h, wd, ci = x.shape
    co = w.shape[0]
    plan = bwd_launch_plan(x.shape, co, kernel, pad, x.dtype, want_stats)
    dev = x.device
    f32 = dict(dtype=torch.float32, device=dev)
    x = _aligned16(x)
    gx = torch.empty_like(x)
    dw = torch.empty_like(w)
    part: Optional[torch.Tensor] = None
    if act_in:
        part = torch.empty((2, plan.part_rows, ci), **f32)
        gscale = torch.empty(ci, **f32)
        gbias = torch.empty(ci, **f32)
    else:
        gscale = torch.zeros(ci, **f32)
        gbias = torch.zeros(ci, **f32)
    wpart = torch.empty(plan.wpart_floats, **f32)
    w_dgrad = dyt = None
    if x.dtype == torch.bfloat16:
        w_dgrad = weight_dgrad(w, plan.co_pad)
        # gy serves as dy_tot where nothing is folded and its rows already
        # have the padded pitch, else the kernel writes dy_tot to scratch
        dyt = gy if plan.dy_elems == 0 and gy.data_ptr() % 16 == 0 else \
            torch.empty(n * y.shape[1] * y.shape[2] * plan.co_pad,
                        dtype=x.dtype, device=dev)
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.mx_fused_conv_unit_bwd(
            _DTYPE_CODE[x.dtype], x.data_ptr(), w.data_ptr(), ptr(w_dgrad),
            in_scale.data_ptr(), in_bias.data_ptr(), shift.data_ptr(),
            y.data_ptr(), gy.data_ptr(), gs1.data_ptr(), gs2.data_ptr(),
            gx.data_ptr(), dw.data_ptr(), gscale.data_ptr(),
            gbias.data_ptr(), ptr(dyt), ptr(part), wpart.data_ptr(), n, h,
            wd, ci, co, kernel[0], kernel[1], pad[0], pad[1], int(act_in),
            int(want_stats), *plan.dgrad_tile, *plan.wgrad_tile,
            plan.splits, plan.part_rows, stream)
        if rc == 0:
            _kernels.count_launch(_BWD)
    if rc != 0:
        raise MXNetError(f"fused_conv_unit_bwd: CUDA launch failed: "
                         f"{_kernels.error_string(rc)} (code {rc})")
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
        if x.device.type in ("cpu", "meta"):  # meta: shape inference
            y, s1, s2 = fused_conv_unit_ref(x, w, in_scale, in_bias, shift,
                                            kernel, stride, pad, act_in,
                                            want_stats)
        else:
            y, s1, s2 = _launch(x, weight_ohwi(w), in_scale, in_bias, shift,
                                kernel, stride, pad, act_in, want_stats)
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
    if dev.type not in ("cpu", "cuda", "meta"):
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
            s1, s2 = dist.all_reduce_sum(torch.stack([s1, s2]),
                                         batch_group()).unbind(0)
            return y, s1, s2
        return out
    zeros = _zero_stats(dev, co)
    return out, zeros, zeros


# the framework op (``nd.FusedConvUnit``, ``sym.FusedConvUnit``, ``F``):
# the JAX package's name and arguments, its three outputs declared
register_op("FusedConvUnit", num_outputs=3)(fused_conv_unit)
