"""Probe of the fused-conv unit's tap-accumulation form (kernel 6).

    python -m mxnet_tpu_torch.tools.convbn_probe [--time] [--device DEV]

Counterpart of ``tools/scratch_convbn_probe.py``.  ``--device`` defaults
to ``cuda:0`` and the probe raises without CUDA; ``--device cpu`` runs the
check mode on the kernel's plain version.

Check mode runs ``candidate_tap`` (``ops/convbn_tap.py``) at four
ResNet-50-like cases, act_in and want_stats on, batch tile nb=2, and
holds each against the oracle, the conv of relu(affine) in x's dtype by
``F.conv2d``: y within 2 bf16 ulps of the oracle plus the spread of two
fp32 summation orders (4·√K·2⁻²⁴·Σ|u·w|), s1/s2 within 2e-3 of Σ|.| of
the oracle's statistics (fp32: 1e-4).  Its inputs are drawn from
``np.random.RandomState(0)`` in the JAX script's order, so they are the
JAX probe's bit for bit.  It prints an OK or FAIL line per case and
returns 1 when a case fails or raises (the JAX script prints FAIL and
goes on).

Time mode (``--time``, a CUDA device only) times with CUDA events, after
a warm-up, at the nine stage-representative ResNet-50 layers at batch
256 in bf16 with act_in and want_stats on: kernel 1 (``fused_conv_unit``,
the production kernel), the op-granular unit (affine+ReLU, ``F.conv2d``
in bf16 channels-last, the statistics by torch reductions: the
counterpart of ``_xla_unit``), kernel 6 at nb in {1, 16, 256},
``F.conv2d`` alone on the pre-activated input, and the bound.  Its
inputs come from a ``torch.Generator`` on the card.

``main(argv, report)`` fills the dict ``report``, where given, with what
the run did: the mode, the calls it made to each kernel's wrapper and
one record per case or layer.
"""
from __future__ import annotations

import argparse
import collections
import math
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

from ..base import MXNetError
from ..ops.convbn_tap import candidate_tap, weight_taps
from ..ops.fused_convbn import _out_hw, fused_conv_unit

__all__ = ["CASES", "LAYERS", "TAP_NB", "case_inputs", "oracle",
           "unit_bound", "run_check", "run_time", "main"]

PEAK_BF16 = 989e12     # dense bf16 tensor-core FLOP/s, H100 SXM
PEAK_FP32 = 67e12      # fp32 FLOP/s outside the tensor cores
PEAK_BYTES = 3.35e12   # HBM3 bytes/s

# (shape NHWC, Co, kernel, stride, pad): the JAX probe's ResNet-50 hot set
CASES = [
    ((4, 16, 16, 128), 128, (3, 3), (1, 1), (1, 1)),
    ((4, 16, 16, 128), 256, (1, 1), (1, 1), (0, 0)),
    ((4, 16, 16, 256), 128, (1, 1), (1, 1), (0, 0)),
    ((4, 16, 16, 128), 128, (3, 3), (2, 2), (1, 1)),
]
CHECK_NB = 2
# the nine stage-representative ResNet-50 layers at batch 256
LAYERS = [
    ((256, 56, 56, 64), 64, (3, 3), (1, 1), (1, 1)),
    ((256, 56, 56, 64), 256, (1, 1), (1, 1), (0, 0)),
    ((256, 56, 56, 256), 64, (1, 1), (1, 1), (0, 0)),
    ((256, 28, 28, 128), 128, (3, 3), (1, 1), (1, 1)),
    ((256, 28, 28, 128), 512, (1, 1), (1, 1), (0, 0)),
    ((256, 14, 14, 256), 256, (3, 3), (1, 1), (1, 1)),
    ((256, 14, 14, 1024), 256, (1, 1), (1, 1), (0, 0)),
    ((256, 7, 7, 512), 512, (3, 3), (1, 1), (1, 1)),
    ((256, 7, 7, 512), 2048, (1, 1), (1, 1), (0, 0)),
]
TAP_NB = (1, 16, 256)
WARMUP, ITERS = 2, 10   # calls before and inside each timed window


def tap_footprint(size, k, s, p, out):
    """How many of `size` input rows (or columns) the taps of a conv with
    kernel k, stride s and pad p read for `out` output rows."""
    return len({o * s - p + t for o in range(out) for t in range(k)}
               & set(range(size)))


def unit_bound(shape, co, kernel, stride, pad, dtype, want_stats):
    """The least time one H100 SXM could take for the fused unit: the
    larger of its FLOPs over the peak of `dtype` and the bytes it must
    move over 3.35 TB/s, where x counts only the pixels some tap reads,
    each once.  Returns dict(bound_ms, bound_by, gflop, mbytes)."""
    n, h, wd, ci = shape
    ho, wo = _out_hw(h, wd, kernel, stride, pad)
    item = 2 if dtype == torch.bfloat16 else 4
    flops = 2.0 * n * ho * wo * co * kernel[0] * kernel[1] * ci
    x_read = n * ci * tap_footprint(h, kernel[0], stride[0], pad[0], ho) \
        * tap_footprint(wd, kernel[1], stride[1], pad[1], wo)
    nbytes = (x_read + co * ci * kernel[0] * kernel[1] + n * ho * wo * co) \
        * item + 4 * (2 * ci + co + (2 * co if want_stats else 0))
    peak = PEAK_BF16 if dtype == torch.bfloat16 else PEAK_FP32
    t_ops, t_bytes = flops / peak * 1e3, nbytes / PEAK_BYTES * 1e3
    return dict(bound_ms=max(t_ops, t_bytes),
                bound_by="operations" if t_ops >= t_bytes else "bytes",
                gflop=flops / 1e9, mbytes=nbytes / 1e6)


def _bf16_ulp(t):
    """The spacing of bf16 numbers at |t| (fp32 tensor)."""
    return torch.exp2(torch.floor(torch.log2(t.abs().clamp_min(2.0 ** -126)))
                      - 7)


# ---------------------------------------------------------------------------
# check mode
# ---------------------------------------------------------------------------

def case_inputs(rng, shape, co, kernel, device):
    """One check case's (x, w_taps, in_scale, in_bias, shift), drawn from
    `rng` in the JAX probe's order and scales, bf16 rounded to nearest."""
    ci = shape[-1]
    x = rng.randn(*shape).astype("float32") * 0.5
    w = rng.randn(kernel[0], kernel[1], ci, co).astype("float32") * 0.05
    sc = rng.rand(ci).astype("float32") + 0.5
    bi = rng.randn(ci).astype("float32") * 0.1
    sh = rng.randn(co).astype("float32") * 0.1
    bf = torch.bfloat16
    return tuple(torch.from_numpy(a).to(device=device, dtype=d)
                 for a, d in ((x, bf), (w, bf), (sc, torch.float32),
                              (bi, torch.float32), (sh, torch.float32)))


def oracle(x, w_taps, in_scale, in_bias, stride, pad):
    """The probe's oracle: the conv of relu(affine) in x's dtype, NHWC."""
    u = (x.float() * in_scale + in_bias).clamp_min(0.0).to(x.dtype)
    y = F.conv2d(u.permute(0, 3, 1, 2), w_taps.permute(3, 2, 0, 1),
                 stride=stride, padding=pad)
    return y.permute(0, 2, 3, 1)


def _hold(x, w_taps, sc, bi, sh, kernel, stride, pad, y, s1, s2):
    """y, s1, s2 against the oracle; returns (ok, note)."""
    yo = oracle(x, w_taps, sc, bi, stride, pad).float()
    yf = y.float()
    err = (yf - yo).abs()
    if x.dtype == torch.bfloat16:
        u = (x.float() * sc + bi).clamp_min(0.0).to(x.dtype).float()
        mag = F.conv2d(u.abs().permute(0, 3, 1, 2), w_taps.float().abs()
                       .permute(3, 2, 0, 1), stride=stride,
                       padding=pad).permute(0, 2, 3, 1)
        k = kernel[0] * kernel[1] * x.shape[-1]
        slack = 4.0 * math.sqrt(k) * 2.0 ** -24 * mag
        worst = float(((err - slack) / _bf16_ulp(yo)).max())
        y_ok, note = worst <= 2.0, f"worst {worst:.2f} ulp"
        rtol = 2e-3
    else:
        y_ok = bool((err <= 1e-4 + 1e-4 * yo.abs()).all())
        note, rtol = f"max abs {float(err.max()):.3g}", 1e-4
    d = yo - sh
    s1o, s2o = yo.sum(dim=(0, 1, 2)), (d * d).sum(dim=(0, 1, 2))
    r1 = float(((s1.reshape(-1) - s1o).abs()
                / yo.abs().sum(dim=(0, 1, 2)).clamp_min(1e-30)).max())
    r2 = float(((s2.reshape(-1) - s2o).abs() / s2o.clamp_min(1e-30)).max())
    note += (f" maxerr={float(err.max()):.4f} s1 rel {r1:.2g} s2 rel "
             f"{r2:.2g}")
    return y_ok and r1 <= rtol and r2 <= rtol, note


def run_check(device):
    """The four cases at nb=CHECK_NB against the oracle.  Returns
    (records, calls): one record per case with its inputs, outputs and
    verdict, and the calls made to each wrapper."""
    rng = np.random.RandomState(0)
    records, calls = [], collections.Counter()
    for shape, co, kernel, stride, pad in CASES:
        label = f"{shape} co={co} k={kernel} s={stride}"
        inputs = case_inputs(rng, shape, co, kernel, device)
        rec = dict(case=label, inputs=inputs, out=None, ok=False)
        t0 = time.perf_counter()
        try:
            calls["candidate_tap"] += 1
            out = candidate_tap(*inputs, kernel=kernel, stride=stride,
                                pad=pad, act_in=True, want_stats=True,
                                nb=CHECK_NB)
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            dt = time.perf_counter() - t0
            rec["out"] = out
            rec["ok"], note = _hold(*inputs, kernel, stride, pad, *out)
            print(f"{'OK  ' if rec['ok'] else 'FAIL'} {label} run "
                  f"{dt:.1f}s {note}", flush=True)
        except Exception as e:  # noqa: BLE001 — reported per case, rc 1
            print(f"FAIL {label}: {type(e).__name__}: "
                  f"{str(e).splitlines()[0][:160]}", flush=True)
        records.append(rec)
    return records, calls


# ---------------------------------------------------------------------------
# time mode
# ---------------------------------------------------------------------------

def _time_ms(fn):
    for _ in range(WARMUP):
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(ITERS):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / ITERS


def composed_unit(x, w, in_scale, in_bias, shift, stride, pad):
    """The op-granular unit (counterpart of ``_xla_unit``): affine+ReLU,
    ``F.conv2d`` in x's dtype on the channels-last view, the statistics
    by torch reductions over the cast y."""
    u = (x.float() * in_scale + in_bias).clamp_min(0.0).to(x.dtype)
    y = F.conv2d(u.permute(0, 3, 1, 2), w, stride=stride, padding=pad)
    yf = y.float()
    d = yf - shift.view(1, -1, 1, 1)
    return (y.permute(0, 2, 3, 1), yf.sum(dim=(0, 2, 3)),
            (d * d).sum(dim=(0, 2, 3)))


def layer_inputs(gen, shape, co, kernel):
    """One layer's (x, w, in_scale, in_bias, shift), w in the checkpoint
    layout (Co, Ci, kh, kw), drawn on the generator's device at the JAX
    probe's scales."""
    dev = gen.device
    ci = shape[-1]

    def randn(*s):
        return torch.randn(*s, generator=gen, device=dev)
    x = (randn(*shape) * 0.5).to(torch.bfloat16)
    w = (randn(co, ci, *kernel) * 0.05).to(torch.bfloat16)
    sc = torch.rand(ci, generator=gen, device=dev) + 0.5
    return x, w, sc, randn(ci) * 0.1, randn(co) * 0.1


def run_time(device):
    """Kernel 1, the op-granular unit, kernel 6 at each nb of TAP_NB and
    F.conv2d at the nine LAYERS.  Returns (records, calls)."""
    gen = torch.Generator(device=device).manual_seed(0)
    records, calls = [], collections.Counter()
    name = torch.cuda.get_device_name(device)
    print(f"per-layer forward, bf16, act_in and want_stats on, CUDA events "
          f"over {ITERS} calls after {WARMUP} [{name}]", flush=True)
    for shape, co, kernel, stride, pad in LAYERS:
        n, h, wd, ci = shape
        x, w, sc, bi, sh = layer_inputs(gen, shape, co, kernel)
        w_taps = weight_taps(w)
        kw = dict(kernel=kernel, stride=stride, pad=pad, act_in=True,
                  want_stats=True)

        def fused():
            calls["fused_conv_unit"] += 1
            fused_conv_unit(x, w, sc, bi, sh, **kw)

        def tap(nb):
            def run():
                calls["candidate_tap"] += 1
                candidate_tap(x, w_taps, sc, bi, sh, nb=nb, **kw)
            return run
        u_nchw = (x.float() * sc + bi).clamp_min(0.0).to(x.dtype) \
            .permute(0, 3, 1, 2)
        rec = dict(layer=f"{h}x{wd} {ci}->{co} k{kernel[0]}s{stride[0]}",
                   shape=list(shape), co=co, k=kernel[0], s=stride[0],
                   fused_ms=_time_ms(fused),
                   composed_ms=_time_ms(lambda: composed_unit(
                       x, w, sc, bi, sh, stride, pad)),
                   tap_ms={nb: _time_ms(tap(nb)) for nb in TAP_NB},
                   library_ms=_time_ms(lambda: F.conv2d(
                       u_nchw, w, stride=stride, padding=pad)),
                   **unit_bound(shape, co, kernel, stride, pad, x.dtype,
                                True))
        records.append(rec)
        taps = " ".join(f"nb={nb} {ms:.4f}" for nb, ms in
                        rec["tap_ms"].items())
        print(f"  {rec['layer']:<20} fused_ms={rec['fused_ms']:.4f} "
              f"composed_ms={rec['composed_ms']:.4f} tap_ms[{taps}] "
              f"library_ms={rec['library_ms']:.4f} bound_ms="
              f"{rec['bound_ms']:.4f} ({rec['bound_by']})", flush=True)
        del x, w, w_taps, u_nchw
    return records, calls


def main(argv=None, report=None):
    ap = argparse.ArgumentParser(
        prog="python -m mxnet_tpu_torch.tools.convbn_probe",
        description="Check (default) or time (--time) the tap-accumulation "
                    "fused unit, kernel 6.")
    ap.add_argument("--time", action="store_true",
                    help="time kernel 1, the op-granular unit, kernel 6 and "
                         "F.conv2d at the nine ResNet-50 layers at batch "
                         "256 (CUDA only)")
    ap.add_argument("--device", default="cuda:0",
                    help="cuda:N (default cuda:0) or cpu (check mode on "
                         "the plain version)")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise MXNetError("convbn_probe: CUDA is not available; pass --device "
                         "cpu to run the check mode on the CPU")
    if args.time and device.type != "cuda":
        ap.error("--time measures on a CUDA device")
    print(f"device: {device}"
          + (f" ({torch.cuda.get_device_name(device)})"
             if device.type == "cuda" else ""), flush=True)
    if args.time:
        records, calls = run_time(device)
        rc = 0
    else:
        records, calls = run_check(device)
        rc = 0 if all(r["ok"] for r in records) else 1
    if report is not None:
        report.update(mode="time" if args.time else "check",
                      calls=dict(calls), records=records)
    return rc


if __name__ == "__main__":
    sys.exit(main())
