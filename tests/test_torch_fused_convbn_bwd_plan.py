"""The redesigned backward kernel (kernel 2) on the CPU: the reformulation
its bf16 path computes, its launch plan and its source.  Nothing here
builds or launches a kernel.

* The reformulation in plain PyTorch, against ``_pallas_unit_bwd`` run in
  interpret mode (MXNET_PALLAS_INTERPRET=1) on the same inputs from a
  numpy seed, at 1x1 and 3x3 with pad 0 and 1, fp32 and bf16, with the
  tolerances of ``tests/test_torch_fused_convbn_bwd.py`` (fp32 rtol/atol
  1e-4; bf16 gx and dw within 1 bf16 ulp plus 4·√K·2⁻²⁴·Σ|terms|, gscale
  and gbias within 1e-4 of Σ|terms|):
  - dy_tot with the padded row pitch, bit for bit ``_fold_dy`` with zeros
    past Co;
  - dgrad as the forward convolution of dy_tot with ``weight_dgrad``'s
    flipped weights at pad kh-1-ph, gathered tap by tap;
  - wgrad as per-tap fp32 partials over ranges of 64-pixel stages, summed
    in split order, for two split counts.
* ``bwd_launch_plan``: the splits fill the H100's 132 SMs at every
  stride-1 unit of ResNet-50 v1 at N=256 and N=128, every split keeps
  whole stages, the scratch covers every split and reduction pass, and
  the bf16 plan refuses Ci % 8 != 0.
* The bf16 source is the Hopper design: wgmma, mbarriers, TMA, no WMMA.
"""
import math

import ml_dtypes
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax.numpy as jnp

from mxnet_tpu.ops import pallas_convbn as pcb
from mxnet_tpu_torch import _kernels
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.ops import fused_convbn as fcb

# (NHWC shape, Co, kernel, pad, act_in, want_stats); Co = 20 and 12 are
# off the padded pitch of 8
CASES = [
    ((2, 6, 6, 16), 24, (1, 1), (0, 0), True, True),
    ((2, 6, 6, 8), 20, (3, 3), (1, 1), True, True),
    ((2, 7, 7, 8), 12, (3, 3), (0, 0), True, False),
    ((2, 6, 6, 16), 8, (3, 3), (1, 1), False, True),
]
SPLITS = (1, 3)


def _ids(c):
    return (f"{c[2][0]}x{c[2][0]}p{c[3][0]}{'-act' if c[4] else ''}"
            f"{'-stats' if c[5] else ''}-co{c[1]}")


def _arrays(seed, shape, co, kernel, pad):
    rs = np.random.RandomState(seed)
    ci = shape[-1]
    ho = shape[1] + 2 * pad[0] - kernel[0] + 1
    wo = shape[2] + 2 * pad[1] - kernel[1] + 1
    return dict(
        x=rs.randn(*shape).astype(np.float32),
        w=(rs.randn(co, ci, *kernel) * 0.2).astype(np.float32),
        sc=(rs.rand(ci) + 0.5).astype(np.float32),
        bi=rs.randn(ci).astype(np.float32),
        sh=rs.randn(co).astype(np.float32),
        y=rs.randn(shape[0], ho, wo, co).astype(np.float32),
        gy=rs.randn(shape[0], ho, wo, co).astype(np.float32),
        gs1=(rs.randn(co) * 0.1).astype(np.float32),
        gs2=(rs.randn(co) * 0.1).astype(np.float32))


def _to_torch(a, bf16):
    if not bf16:
        return torch.from_numpy(a.copy())
    b = a.astype(ml_dtypes.bfloat16)
    return torch.from_numpy(b.view(np.int16).copy()).view(torch.bfloat16)


def _inputs(case, bf16):
    shape, co, kernel, pad, _, _ = case
    raw = _arrays(31, shape, co, kernel, pad)
    big = ("x", "w", "y", "gy")
    return raw, {k: _to_torch(v, bf16 and k in big) for k, v in raw.items()}


def _fold_padded(y, gy, shift, gs1, gs2, want_stats, co_pad):
    """dy_tot as fold_dy_kernel writes it: (N*Ho*Wo, co_pad) in gy's
    dtype, t1 = gy + gs1, t2 = (2·(y - shift))·gs2, t1 + t2, each op
    rounded to fp32, zeros past Co."""
    co = gy.shape[-1]
    g = gy.float().reshape(-1, co)
    if want_stats:
        t1 = g + gs1
        t2 = (2.0 * (y.float().reshape(-1, co) - shift)) * gs2
        g = t1 + t2
    return F.pad(g, (0, co_pad - co)).to(gy.dtype)


def _reformulated(t, kernel, pad, act_in, want_stats, splits):
    """(gx, dw, gscale, gbias, dy_tot) the way the bf16 kernel computes
    them, in plain PyTorch with fp32 sums."""
    x, w = t["x"], t["w"]
    n, h, wd, ci = x.shape
    co = w.shape[0]
    kh, kw = kernel
    ph, pw = pad
    ho, wo = h + 2 * ph - kh + 1, wd + 2 * pw - kw + 1
    co_pad = -(-co // 8) * 8
    dyt = _fold_padded(t["y"], t["gy"], t["sh"], t["gs1"], t["gs2"],
                       want_stats, co_pad)
    # dgrad: input pixel (ih, iw) at flipped tap (a, b) reads dy_tot at
    # (ih - (kh-1-ph) + a, iw - (kw-1-pw) + b), zeros outside the output
    dimg = dyt.float().reshape(n, ho, wo, co_pad)
    qh, qw = kh - 1 - ph, kw - 1 - pw
    dpad = F.pad(dimg, (0, 0, qw, qw, qh, qh))
    wdg = fcb.weight_dgrad(w, co_pad).float()  # (Ci, kh, kw, co_pad)
    du = torch.zeros(n, h, wd, ci)
    for a in range(kh):
        for b in range(kw):
            du += dpad[:, a:a + h, b:b + wd, :] @ wdg[:, a, b, :].T
    if act_in:
        sc, bi = t["sc"], t["bi"]
        xf = x.float()
        gu = torch.where(xf * sc + bi > 0.0, du, 0.0)
        gx = (gu * sc).to(x.dtype)
        gscale, gbias = (gu * xf).sum(dim=(0, 1, 2)), gu.sum(dim=(0, 1, 2))
    else:
        gx = du.to(x.dtype)
        gscale, gbias = torch.zeros(ci), torch.zeros(ci)
    # wgrad: u padded after the affine, one (M_out, Ci) gather a tap; K
    # cut into ranges of whole 64-pixel stages, [s*nst/splits,
    # (s+1)*nst/splits) as the kernel cuts it, summed in split order
    u = fcb._affine_in(x, t["sc"], t["bi"], act_in).float()
    upad = F.pad(u, (0, 0, pw, pw, ph, ph))
    m_out = n * ho * wo
    nst = -(-m_out // fcb.WGRAD_STAGE)
    dyf = dyt.float()[:, :co]
    dw = torch.zeros(co, ci, kh, kw)
    for ky in range(kh):
        for kx in range(kw):
            ut = upad[:, ky:ky + ho, kx:kx + wo, :].reshape(m_out, ci)
            total = torch.zeros(ci, co)
            for s in range(splits):
                r0 = s * nst // splits * fcb.WGRAD_STAGE
                r1 = min((s + 1) * nst // splits * fcb.WGRAD_STAGE, m_out)
                total = total + ut[r0:r1].T @ dyf[r0:r1]
            dw[:, :, ky, kx] = total.T
    return gx, dw.to(w.dtype), gscale, gbias, dyt


def _bf16_ulp(a):
    a = np.maximum(np.abs(a), 2.0 ** -126)
    return np.exp2(np.floor(np.log2(a)) - 7)


@pytest.mark.parametrize("bf16", [False, True], ids=["fp32", "bf16"])
@pytest.mark.parametrize("case", CASES, ids=[_ids(c) for c in CASES])
def test_reformulation_matches_pallas_bwd_interpret(case, bf16, monkeypatch):
    shape, co, kernel, pad, act_in, want_stats = case
    monkeypatch.setenv("MXNET_PALLAS_INTERPRET", "1")
    raw, t = _inputs(case, bf16)
    order = ("x", "w", "sc", "bi", "sh", "y", "gy", "gs1", "gs2")
    ref = pcb._pallas_unit_bwd(
        *(jnp.asarray(t[k].float().numpy()).astype(
            jnp.bfloat16 if bf16 and t[k].dtype == torch.bfloat16
            else jnp.float32) for k in order),
        kernel=kernel, stride=(1, 1), pad=pad, act_in=act_in,
        want_stats=want_stats)
    ref = [np.asarray(r).astype(np.float32) for r in ref]
    outs = {s: _reformulated(t, kernel, pad, act_in, want_stats, s)
            for s in SPLITS}
    names = ("gx", "dw", "gscale", "gbias")
    if not bf16:
        for s, got in outs.items():
            for name, a, b in zip(names, got, ref):
                np.testing.assert_allclose(a.float().numpy(), b, rtol=1e-4,
                                           atol=1e-4,
                                           err_msg=f"{name} splits={s}")
        return
    # bf16: Σ|terms| of each sum from the same inputs
    f = {k: v.float().abs() for k, v in t.items()}
    dy_abs = fcb._fold_dy(t["y"], t["gy"], t["sh"], t["gs1"], t["gs2"],
                          want_stats).float().abs()
    u_abs = fcb._affine_in(t["x"], t["sc"], t["bi"], act_in).float().abs()
    du_mag, dw_mag = fcb._conv_grads(u_abs, f["w"], dy_abs, (1, 1), pad,
                                     torch.float32)
    sc_abs = f["sc"] if act_in else torch.ones(shape[-1])
    ks = {"gx": kernel[0] * kernel[1] * co,
          "dw": dy_abs.shape[0] * dy_abs.shape[1] * dy_abs.shape[2]}
    mags = {"gx": (du_mag * sc_abs).numpy(), "dw": dw_mag.numpy()}
    for s, got in outs.items():
        for name, a, b in (("gx", got[0], ref[0]), ("dw", got[1], ref[1])):
            a = a.float().numpy()
            slack = 4.0 * math.sqrt(ks[name]) * 2.0 ** -24 * mags[name]
            err = np.abs(a - b)
            assert np.all(err <= _bf16_ulp(b) + slack), \
                f"{name} splits={s}: worst " \
                f"{float(np.max(err - slack - _bf16_ulp(b)))}"
        if act_in:
            du_abs = du_mag.numpy()
            scale_x = (du_abs * f["x"].numpy()).sum(axis=(0, 1, 2))
            scale_1 = du_abs.sum(axis=(0, 1, 2))
            for name, a, b, sc in (("gscale", got[2], ref[2], scale_x),
                                   ("gbias", got[3], ref[3], scale_1)):
                assert np.all(np.abs(a.numpy() - b) <= 1e-4 * sc + 1e-6), \
                    f"{name} splits={s}"
        else:
            assert not got[2].any() and not got[3].any()
            assert not ref[2].any() and not ref[3].any()


@pytest.mark.parametrize("want_stats", [True, False])
@pytest.mark.parametrize("case", CASES, ids=[_ids(c) for c in CASES])
def test_padded_dy_tot_is_fold_dy_bit_for_bit(case, want_stats):
    _, t = _inputs(case, True)
    co = t["w"].shape[0]
    plan = fcb.bwd_launch_plan(t["x"].shape, co, case[2], case[3],
                               torch.bfloat16, want_stats)
    assert plan.co_pad % 8 == 0 and co <= plan.co_pad < co + 8
    got = _fold_padded(t["y"], t["gy"], t["sh"], t["gs1"], t["gs2"],
                       want_stats, plan.co_pad)
    want = fcb._fold_dy(t["y"], t["gy"], t["sh"], t["gs1"], t["gs2"],
                        want_stats).reshape(-1, co)
    assert got.dtype == want.dtype == torch.bfloat16
    assert torch.equal(got[:, :co].view(torch.int16),
                       want.contiguous().view(torch.int16))
    assert not got[:, co:].float().any()
    # without statistics and with a whole pitch the kernel reads gy itself
    assert plan.dy_elems == (0 if not want_stats and co % 8 == 0
                             else got.numel())


@pytest.mark.parametrize("k,co", [(1, 24), (3, 20)])
def test_weight_dgrad_flips_the_taps_and_pads_co(k, co):
    w = torch.from_numpy(np.random.RandomState(k).randn(co, 16, k, k)
                         .astype(np.float32))
    co_pad = -(-co // 8) * 8
    got = fcb.weight_dgrad(w, co_pad)
    assert got.shape == (16, k, k, co_pad) and got.is_contiguous()
    for ky in range(k):
        for kx in range(k):
            assert torch.equal(got[:, ky, kx, :co],
                               w[:, :, k - 1 - ky, k - 1 - kx].T)
    assert not got[..., co:].any()


def resnet50_stride1_units(n):
    """(x shape, Co, kernel, pad) of the 14 stride-1 fused units of
    ResNet-50 v1 at 224x224 and batch n: the backward kernel's shapes."""
    units = [((n, 56, 56, 64), 64, (1, 1), (0, 0)),
             ((n, 56, 56, 64), 256, (1, 1), (0, 0))]
    for hw, c in zip((56, 28, 14, 7), (256, 512, 1024, 2048)):
        mid = c // 4
        units += [((n, hw, hw, mid), mid, (3, 3), (1, 1)),
                  ((n, hw, hw, mid), c, (1, 1), (0, 0)),
                  ((n, hw, hw, c), mid, (1, 1), (0, 0))]
    return units


@pytest.mark.parametrize("n", [256, 128])
def test_bwd_plan_fills_the_card_and_sizes_its_scratch(n):
    units = resnet50_stride1_units(n)
    assert len(units) == 14
    for shape, co, kernel, pad in units:
        plan = fcb.bwd_launch_plan(shape, co, kernel, pad, torch.bfloat16)
        _, h, w, ci = shape
        khw = kernel[0] * kernel[1]
        bm, bn = plan.wgrad_tile
        assert (bm, bn) == fcb.wgrad_tile(ci, co)
        tiles = khw * -(-ci // bm) * -(-co // bn)
        assert tiles * plan.splits >= fcb.SMS, (shape, co, kernel)
        m_out = n * h * w  # stride 1, "same" padding
        stages = -(-m_out // fcb.WGRAD_STAGE)
        # every split holds whole stages, at least WGRAD_MIN_STAGES of them
        assert plan.splits * fcb.WGRAD_MIN_STAGES <= stages
        assert plan.wpart_floats == plan.splits * khw * ci * co
        assert plan.dgrad_tile in fcb.TILES_BF16
        assert plan.m_tiles == -(-n * h * w // plan.dgrad_tile[0])
        assert plan.part_rows == fcb.scratch_rows(plan.m_tiles) \
            >= plan.m_tiles
        assert plan.dy_elems == m_out * plan.co_pad


@pytest.mark.parametrize("ci,co,tile", [
    (64, 64, (64, 64)), (64, 256, (64, 128)), (256, 64, (128, 64)),
    (128, 128, (128, 128)), (128, 512, (128, 256)), (2048, 512, (128, 256)),
    (40, 20, (64, 64))])
def test_wgrad_tile_is_128x256_only_where_both_are_wide(ci, co, tile):
    assert fcb.wgrad_tile(ci, co) == tile


@pytest.mark.parametrize("m_out", [147, 64, 1])
def test_bwd_plan_small_k_keeps_one_split(m_out):
    """Too few stages to split: one K range, however few tiles."""
    plan = fcb.bwd_launch_plan((1, m_out, 1, 64), 64, (1, 1), (0, 0),
                               torch.bfloat16)
    assert plan.splits == 1


def test_bwd_plan_reduction_passes_are_sized():
    # 3136 m-tiles of 64 rows: two reduction passes (25 rows, then 1)
    plan = fcb.bwd_launch_plan((64, 56, 56, 64), 64, (1, 1), (0, 0),
                               torch.bfloat16)
    assert plan.m_tiles == 3136
    assert plan.part_rows == 3136 + 25


@pytest.mark.parametrize("ci", [12, 36, 3])
def test_bf16_bwd_plan_refuses_ci_not_a_multiple_of_8(ci):
    with pytest.raises(MXNetError, match="Ci % 8 == 0"):
        fcb.bwd_launch_plan((2, 8, 8, ci), 64, (3, 3), (1, 1),
                            torch.bfloat16)
    plan = fcb.bwd_launch_plan((2, 8, 8, ci), 64, (3, 3), (1, 1),
                               torch.float32)
    assert (plan.dgrad_tile, plan.wgrad_tile) == fcb.BWD_TILES_FP32
    assert plan.dy_elems == 0


def test_kernel2_source_is_the_hopper_design():
    src = (_kernels._SRC_DIR / "fused_convbn_bwd.cu").read_text()
    header = (_kernels._SRC_DIR / "conv_mainloop.cuh").read_text()
    assert '#include "conv_mainloop.cuh"' in src
    assert "nvcuda::wmma" not in src and "<mma.h>" not in src
    for piece in ("wgmma_ss(", "wgmma_rs<1>(", "ldmatrix_x4_trans(",
                  "tma_load_2d(", "cp_async_arrive(", "mbar_wait(",
                  "fold_dy_kernel", "reduce_stats<1>", "wgrad_reduce_kernel"):
        assert piece in src, piece
    for piece in ("wgmma.mma_async", "ldmatrix.sync.aligned.m8n8.x4.trans",
                  "mbarrier.try_wait", "cp.async.bulk.tensor",
                  "fence.proxy.async", "stats_reduce_kernel"):
        assert piece in header, piece
    # the reduction lives once, in the header, for kernels 1 and 2
    assert "channel_reduce_kernel" not in src
    kernel1 = (_kernels._SRC_DIR / "fused_convbn.cu").read_text()
    assert "reduce_stats<0>" in kernel1
    assert "stats_reduce_kernel(const" not in kernel1 + src
