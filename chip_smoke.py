#!/usr/bin/env python3
"""Smoke run of mxnet_tpu_torch on one CUDA card.

    python3 chip_smoke.py            # every phase, one card

Phases, each failing loudly (exit code 1, no result line):

1. device: CUDA must be present; prints the card's name and power limit
   (nvidia-smi) and turns TF32 off for every fp32 comparison.
2. build: compiles the port's CUDA kernels from mxnet_tpu_torch/csrc with
   nvcc and prints the build time and ptxas' register/smem report.
3. kernels: fused_conv_unit's CUDA kernel against its plain PyTorch
   version at the 20 fused-unit configurations of ResNet-50 v1 at 224x224
   (N=32, bf16, want_stats on and off, random shift), two fp32
   configurations and a 3x3 stride-2 one (BasicBlockV1).  One line per
   configuration: kernel_ms, ref_ms (the plain version), library_ms
   (F.conv2d on the pre-activated input, a yardstick the port never
   calls) and bound_ms (max of FLOPs over peak and bytes over 3.35 TB/s,
   where x counts only the pixels the taps read).
   Tolerances:
     fp32: y within atol/rtol 1e-4; s1/s2 within rtol 1e-4 of sum|.|
     bf16: |y - y_ref| <= 1 bf16 ulp of y_ref on >= 99.9% of elements and
           <= 2 ulp everywhere, each plus 4*sqrt(K)*2^-24*sum|u*w|, the
           spread of two fp32 summation orders over K products (without
           it an output that cancels to near zero would be held to an ulp
           of itself); the share within 1 ulp without that slack is
           printed beside it ("1ulp bare"); s1/s2 within rtol 2e-3 of
           sum|.|
     want_stats=False: s1/s2 exactly 0.
4. main path: full-width ResNet-50 v1 (random weights from a seed), bf16,
   NHWC, 224x224, exported with export_model, served through
   ModelRepository -> InferenceServer with MXNET_FUSED_CONVBN=1 to
   requests from several threads.  Every request must be answered, the
   kernel launch count must rise by exactly 52 per launched batch, and
   the answers must match a direct forward with MXNET_FUSED_CONVBN=0
   (op-granular, no kernel) to relative L2 error < 2e-2; then the same
   with an fp32 copy of the net, bound 1e-4.

The line before the last is the kernel summary
{"kernels": [...]}; the last line is
{"ok": true, "device": {"platform": "gpu", ...}}.
"""
from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import threading
import time

import torch
import torch.nn.functional as F

PEAK_BF16 = 989e12     # dense bf16 tensor-core FLOP/s, H100 SXM
PEAK_FP32 = 67e12      # fp32 FLOP/s outside the tensor cores
PEAK_BYTES = 3.35e12   # HBM3 bytes/s
BATCH = 32
REQUESTS, THREADS = 128, 8   # single-image requests, client threads
KERNEL = {"name": "fused_conv_unit", "route": "cuda",
          "source": "mxnet_tpu_torch/csrc/fused_convbn.cu",
          "replaces": "mxnet_tpu/ops/pallas_convbn.py:156"}

FAILURES = []


def fail(msg):
    FAILURES.append(msg)
    print(f"FAIL: {msg}", flush=True)


# ---------------------------------------------------------------------------
# phase 1: device
# ---------------------------------------------------------------------------

def phase_device():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False — "
                         "this script runs on a CUDA card only")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.stdout.strip() \
        else f"{torch.cuda.get_device_name(0)}, power limit unknown"
    print(f"card: {card}", flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}", flush=True)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return card


# ---------------------------------------------------------------------------
# phase 2: build
# ---------------------------------------------------------------------------

def phase_build():
    from mxnet_tpu_torch import _kernels

    t0 = time.perf_counter()
    _kernels.build(force=True)
    _kernels.load()
    info = _kernels.last_build()
    if not info.get("built"):
        fail("build: the kernel library was not compiled in this run")
        return
    print(f"build: nvcc {info['seconds']:.2f} s, load "
          f"{time.perf_counter() - t0:.2f} s total -> {info['path']}",
          flush=True)
    for line in info.get("log", "").splitlines():
        if "registers" in line or "smem" in line or "spill" in line:
            print(f"  ptxas: {line.strip()}", flush=True)


# ---------------------------------------------------------------------------
# phase 3: kernel against its plain version
# ---------------------------------------------------------------------------

def resnet50_unit_configs():
    """The 20 distinct fused-unit configurations of ResNet-50 v1 at 224x224
    with how often one forward launches each (16 bottlenecks x 3 convs +
    4 downsample convs = 52)."""
    cfgs = []
    in_c, hw = 64, 56
    for stage, (blocks, c) in enumerate(zip([3, 4, 6, 3],
                                            [256, 512, 1024, 2048]), 1):
        s = 1 if stage == 1 else 2
        ho = (hw - 1) // s + 1
        mid = c // 4
        cfgs += [
            (f"s{stage}.conv1.first", hw, in_c, mid, 1, s, 0, False, 1),
            (f"s{stage}.downsample", hw, in_c, c, 1, s, 0, False, 1),
            (f"s{stage}.conv2", ho, mid, mid, 3, 1, 1, True, blocks),
            (f"s{stage}.conv3", ho, mid, c, 1, 1, 0, True, blocks),
            (f"s{stage}.conv1.later", ho, c, mid, 1, 1, 0, False,
             blocks - 1),
        ]
        in_c, hw = c, ho
    return cfgs


def time_ms(fn, iters=10, warmup=2):
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / iters


def tap_footprint(size, k, s, p, out):
    """How many of `size` input rows (or columns) the taps of a conv with
    kernel k, stride s and pad p read for `out` output rows."""
    return len({o * s - p + t for o in range(out) for t in range(k)}
               & set(range(size)))


def bf16_ordered(t):
    """bf16 bit patterns as integers ordered like the values."""
    i = t.contiguous().view(torch.int16).to(torch.int32)
    return torch.where(i < 0, -(i & 0x7FFF), i)


def bf16_ulp(t):
    """The spacing of bf16 numbers at |t| (fp32 tensor)."""
    a = t.abs().clamp_min(2.0 ** -126)
    return torch.exp2(torch.floor(torch.log2(a)) - 7)


def check_unit(name, x, w, sc, bi, sh, k, s, p, act_in, want_stats):
    """Kernel vs plain version on one configuration; returns a record."""
    from mxnet_tpu_torch.ops import fused_convbn as fcb

    kernel, stride, pad = (k, k), (s, s), (p, p)
    args = (x, w, sc, bi, sh)
    kw = dict(kernel=kernel, stride=stride, pad=pad, act_in=act_in,
              want_stats=want_stats)
    y, s1, s2 = fcb.fused_conv_unit(*args, **kw)
    torch.cuda.synchronize()
    yr, s1r, s2r = fcb.fused_conv_unit_ref(*args, kernel, stride, pad,
                                           act_in, want_stats)
    n, h, wd, ci = x.shape
    co = w.shape[0]
    ho, wo = y.shape[1], y.shape[2]
    m = n * ho * wo
    kdim = k * k * ci
    ok = True
    err = (y.float() - yr.float()).abs()
    max_abs = float(err.max())
    if x.dtype == torch.bfloat16:
        u = (x.float() * sc + bi).clamp_min(0).to(x.dtype) if act_in else x
        mag = F.conv2d(u.permute(0, 3, 1, 2).float().abs(), w.float().abs(),
                       stride=stride, padding=pad).permute(0, 2, 3, 1)
        slack = 4.0 * math.sqrt(kdim) * 2.0 ** -24 * mag
        ulp = bf16_ulp(yr.float())
        frac1 = float((err <= ulp + slack).float().mean())
        # the same share held to 1 ulp without the slack, reported only
        frac1_bare = float((err <= ulp).float().mean())
        worst = float(((err - slack) / ulp).max())
        ulps = (bf16_ordered(y) - bf16_ordered(yr)).abs()
        if frac1 < 0.999 or worst > 2.0:
            ok = False
            fail(f"{name}: y within 1 ulp on {frac1:.5f} (< 0.999) or worst "
                 f"{worst:.2f} ulp (> 2)")
        ytol = (f"1ulp+slack {frac1 * 100:.3f}% 1ulp bare "
                f"{frac1_bare * 100:.4f}% worst {worst:.2f}ulp "
                f"maxbits {int(ulps.max())}")
        stat_rtol = 2e-3
    else:
        bad = err > 1e-4 + 1e-4 * yr.float().abs()
        if bool(bad.any()):
            ok = False
            fail(f"{name}: fp32 y off by {max_abs:.3g} on "
                 f"{int(bad.sum())} elements")
        ytol = f"max_abs {max_abs:.3g}"
        stat_rtol = 1e-4
    if want_stats:
        yf = yr.float()
        ref_abs1 = yf.abs().sum(dim=(0, 1, 2))
        d1 = (s1 - s1r).abs() / ref_abs1.clamp_min(1e-30)
        d2 = (s2 - s2r).abs() / s2r.abs().clamp_min(1e-30)
        if float(d1.max()) > stat_rtol or float(d2.max()) > stat_rtol:
            ok = False
            fail(f"{name}: stats rel err s1 {float(d1.max()):.3g} s2 "
                 f"{float(d2.max()):.3g} > {stat_rtol}")
    elif bool(s1.any()) or bool(s2.any()):
        ok = False
        fail(f"{name}: want_stats=False but s1/s2 are not all zero")
    # timings (the plain version and the library call on the same inputs)
    kernel_ms = time_ms(lambda: fcb.fused_conv_unit(*args, **kw))
    ref_ms = time_ms(lambda: fcb.fused_conv_unit_ref(
        *args, kernel, stride, pad, act_in, want_stats))
    u = (x.float() * sc + bi).clamp_min(0).to(x.dtype) if act_in else x
    u_nchw = u.permute(0, 3, 1, 2)
    library_ms = time_ms(lambda: F.conv2d(u_nchw, w, stride=stride,
                                          padding=pad))
    flops = 2.0 * m * co * kdim
    item = x.element_size()
    # x counts only the pixels some tap reads (a strided 1x1 conv skips
    # 1 - 1/s^2 of them), each once
    x_read = n * tap_footprint(h, k, s, p, ho) \
        * tap_footprint(wd, k, s, p, wo) * ci
    nbytes = (x_read + w.numel() + y.numel()) * item \
        + 4 * (2 * ci + co + (2 * co if want_stats else 0))
    peak = PEAK_BF16 if x.dtype == torch.bfloat16 else PEAK_FP32
    t_ops, t_bytes = flops / peak * 1e3, nbytes / PEAK_BYTES * 1e3
    rec = dict(name=name, dtype=str(x.dtype).replace("torch.", ""),
               shape=[n, h, wd, ci], co=co, k=k, s=s, p=p, act_in=act_in,
               want_stats=want_stats, ok=ok, max_abs_err=max_abs,
               kernel_ms=kernel_ms, ref_ms=ref_ms, library_ms=library_ms,
               bound_ms=max(t_ops, t_bytes),
               bound_by="operations" if t_ops >= t_bytes else "bytes",
               gflop=flops / 1e9, mbytes=nbytes / 1e6)
    print(f"  {name:<22} {rec['dtype']:<8} x{rec['shape']} co={co} k{k}s{s}"
          f"p{p} act={int(act_in)} stats={int(want_stats)} | "
          f"kernel_ms={kernel_ms:.4f} ref_ms={ref_ms:.4f} "
          f"library_ms={library_ms:.4f} bound_ms={rec['bound_ms']:.4f} "
          f"({rec['bound_by']}) | {ytol} | {'ok' if ok else 'FAIL'}",
          flush=True)
    return rec


def make_unit_inputs(gen, n, hw, ci, co, k, dtype, dev):
    x = torch.randn(n, hw, hw, ci, generator=gen).to(dev, dtype)
    w = (torch.randn(co, ci, k, k, generator=gen)
         / math.sqrt(ci * k * k)).to(dev, dtype)
    sc = (torch.rand(ci, generator=gen) + 0.5).to(dev)
    bi = (torch.randn(ci, generator=gen) * 0.5).to(dev)
    sh = (torch.randn(co, generator=gen) * 0.1).to(dev)
    return x, w, sc, bi, sh


def phase_kernels():
    dev = torch.device("cuda", 0)
    gen = torch.Generator().manual_seed(1234)
    recs = []
    print(f"kernel vs plain version, N={BATCH}:", flush=True)
    for (name, hw, ci, co, k, s, p, act_in, count) \
            in resnet50_unit_configs():
        x, w, sc, bi, sh = make_unit_inputs(gen, BATCH, hw, ci, co, k,
                                            torch.bfloat16, dev)
        for want_stats in (False, True):
            rec = check_unit(name, x, w, sc, bi, sh, k, s, p, act_in,
                             want_stats)
            rec["count"] = count
            recs.append(rec)
        del x, w
    extra = [("fp32.s2.conv2", 28, 128, 128, 3, 1, 1, True, torch.float32),
             ("fp32.s3.conv1.first", 28, 512, 256, 1, 2, 0, False,
              torch.float32),
             ("basic.3x3s2", 56, 64, 128, 3, 2, 1, True, torch.bfloat16)]
    for (name, hw, ci, co, k, s, p, act_in, dt) in extra:
        x, w, sc, bi, sh = make_unit_inputs(gen, BATCH, hw, ci, co, k, dt,
                                            dev)
        rec = check_unit(name, x, w, sc, bi, sh, k, s, p, act_in, True)
        rec["count"] = 0
        recs.append(rec)
    torch.cuda.empty_cache()
    return recs


def kernel_summary(recs, launches):
    """One record for the kernel: times summed over the 52 launches of one
    batch-32 ResNet-50 forward (eval: want_stats off), each configuration
    weighted by how often the forward launches it."""
    main = [r for r in recs if r["dtype"] == "bfloat16"
            and not r["want_stats"] and r["count"]]
    tot = {k: sum(r[k] * r["count"] for r in main)
           for k in ("kernel_ms", "ref_ms", "library_ms", "bound_ms")}
    by_ops = sum(r["bound_ms"] * r["count"] for r in main
                 if r["bound_by"] == "operations")
    return dict(KERNEL, launches=launches,
                max_abs_err=max(r["max_abs_err"] for r in recs),
                ms=tot["kernel_ms"], plain_ms=tot["ref_ms"],
                bound_ms=tot["bound_ms"],
                bound_by="operations" if by_ops >= tot["bound_ms"] / 2
                else "bytes",
                library_ms=tot["library_ms"])


# ---------------------------------------------------------------------------
# phase 4: the main path — serve ResNet-50 v1
# ---------------------------------------------------------------------------

def rel_l2(a, b):
    a, b = a.float(), b.float()
    return float((a - b).norm() / b.norm().clamp_min(1e-30))


def direct_forward(net, xs, fused, bs=BATCH):
    os.environ["MXNET_FUSED_CONVBN"] = "1" if fused else "0"
    outs = []
    with torch.inference_mode():
        for i in range(0, xs.shape[0], bs):
            outs.append(net(xs[i:i + bs]))
    torch.cuda.synchronize()
    return torch.cat(outs)


def build_net(dtype, seed):
    from mxnet_tpu_torch import gpu, init
    from mxnet_tpu_torch.gluon.model_zoo import vision

    net = vision.resnet50_v1(classes=1000, layout="NHWC")
    net.initialize(init.Xavier(), ctx=gpu(0), seed=seed)
    net.cast(dtype)
    net.hybridize()
    net.eval()
    return net


def serve(server, model, images, threads):
    """Submit one request per image from `threads` client threads; returns
    (answers in image order, per-request latencies in s, wall s, errors).
    A latency runs from submit to the future's completion."""
    n = images.shape[0]
    answers, t_sub, t_done = [None] * n, [0.0] * n, [0.0] * n
    errors = []

    def client(idx):
        futs = []
        for i in idx:
            t_sub[i] = time.perf_counter()
            f = server.submit(model, [images[i:i + 1]])
            f.add_done_callback(
                lambda _f, i=i: t_done.__setitem__(i, time.perf_counter()))
            futs.append((i, f))
        for i, f in futs:
            try:
                answers[i] = f.result(timeout=300)
            except Exception as e:  # noqa: BLE001 — reported below
                errors.append(f"request {i}: {type(e).__name__}: {e}")

    chunks = [list(range(t, n, threads)) for t in range(threads)]
    t0 = time.perf_counter()
    ts = [threading.Thread(target=client, args=(c,)) for c in chunks]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    wall = time.perf_counter() - t0
    lat = sorted(d - s for s, d in zip(t_sub, t_done) if d)
    return answers, lat, wall, errors


def percentile_ms(sorted_s, q):
    if not sorted_s:
        return None
    return sorted_s[min(len(sorted_s) - 1,
                        int(round(q * (len(sorted_s) - 1))))] * 1e3


def phase_main(card, n_requests, threads):
    from mxnet_tpu_torch import serving
    from mxnet_tpu_torch.contrib import deploy
    from mxnet_tpu_torch.ops import fused_convbn as fcb

    dev = torch.device("cuda", 0)
    gen = torch.Generator().manual_seed(7)
    images_f32 = torch.rand(n_requests, 224, 224, 3, generator=gen)
    result = {}
    # artifacts go under build/ in the checkout (listed in .gitignore)
    tmp = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                       "chip_smoke_deploy")
    repo = serving.ModelRepository()
    models = {}
    for dtype, tag in (("bfloat16", "bf16"), ("float32", "fp32")):
        net = build_net(dtype, seed=0)
        ex = images_f32[:1].to(dev, net.features[0].weight.dtype)
        path = os.path.join(tmp, tag)
        deploy.export_model(net, path, [ex], dynamic_batch=True)
        repo.add(f"resnet50_v1_{tag}", path)
        models[tag] = net
    server = serving.InferenceServer(
        repo, serving.ServingConfig(max_batch_size=BATCH,
                                    batch_timeout_ms=2))
    try:
        for tag, bound, n_req in (("bf16", 2e-2, n_requests),
                                  ("fp32", 1e-4, BATCH)):
            net = models[tag]
            dt = net.features[0].weight.dtype
            imgs = images_f32[:n_req].to(dt)
            model = f"resnet50_v1_{tag}"
            # warm the served model (first launches, allocator, cuDNN)
            os.environ["MXNET_FUSED_CONVBN"] = "1"
            serve(server, model, imgs[:4], 2)
            m = repo.get(model).metrics
            b0 = m.value("batches")
            fcb.reset_launch_count()
            answers, lat, wall, errors = serve(server, model, imgs, threads)
            launches = fcb.launch_count()
            batches = m.value("batches") - b0
            for e in errors[:5]:
                fail(f"{tag}: {e}")
            if any(a is None for a in answers):
                fail(f"{tag}: {sum(a is None for a in answers)} of {n_req} "
                     f"requests unanswered")
                continue
            if launches != 52 * batches:
                fail(f"{tag}: {launches} kernel launches for {batches} "
                     f"batches (want 52 per batch)")
            got = torch.cat([a.float() for a in answers]).to(dev)
            ref = direct_forward(net, imgs.to(dev), fused=False).float()
            err = rel_l2(got, ref)
            row_err = max(rel_l2(got[i], ref[i]) for i in range(n_req))
            finite = bool(torch.isfinite(got).all())
            shape_ok = tuple(got.shape) == (n_req, 1000)
            print(f"main path {tag}: {n_req} requests from {threads} threads"
                  f" in {batches} batches, {launches} kernel launches; "
                  f"served vs unfused rel L2 {err:.3g} (worst row "
                  f"{row_err:.3g}, bound {bound}); finite={finite} "
                  f"shape={tuple(got.shape)}", flush=True)
            if not (err < bound and row_err < bound and finite and shape_ok):
                fail(f"{tag}: served answers disagree with the unfused "
                     f"forward (rel L2 {err:.3g}, worst row {row_err:.3g}, "
                     f"bound {bound}, finite {finite}, shape "
                     f"{tuple(got.shape)})")
            p50, p99 = percentile_ms(lat, 0.50), percentile_ms(lat, 0.99)
            result[tag] = dict(requests=n_req, batches=batches,
                               launches=launches, wall_s=wall,
                               req_per_s=n_req / wall, p50_ms=p50,
                               p99_ms=p99, rel_l2=err,
                               worst_row_rel_l2=row_err)
            if tag == "bf16":
                result["launches"] = launches
            print(f"serving {tag}: {n_req / wall:.2f} requests/s, p50 "
                  f"{p50:.3f} ms, p99 {p99:.3f} ms (submit to answer), "
                  f"{n_req / max(batches, 1):.1f} rows per batch [{card}]",
                  flush=True)
    finally:
        server.shutdown(drain=True)
    # direct batch-32 forward throughput, fused and unfused, in turns
    net = models["bf16"]
    xb = images_f32[:BATCH].to(dev, torch.bfloat16)
    for fused in (True, False):
        direct_forward(net, xb, fused)
    rates = {True: [], False: []}
    for fused in (True, False, False, True):
        os.environ["MXNET_FUSED_CONVBN"] = "1" if fused else "0"
        with torch.inference_mode():
            ms = time_ms(lambda: net(xb), iters=5, warmup=1)
        rates[fused].append(BATCH / ms * 1e3)
    for fused in (True, False):
        print(f"direct forward bf16 batch {BATCH} "
              f"{'fused' if fused else 'unfused'}: "
              f"{' '.join(f'{r:.1f}' for r in rates[fused])} img/s "
              f"[{card}]", flush=True)
    result["img_per_s"] = {"fused": rates[True], "unfused": rates[False]}
    result["profile"] = {
        tag: profile_forward(net, xb, fused, card,
                             BATCH / (sum(rates[fused]) / 2) * 1e3)
        for tag, fused in (("fused", True), ("unfused", False))}
    return result


def profile_forward(net, xb, fused, card, wall_ms, iters=3):
    """Device time by kernel over `iters` direct forwards (torch.profiler).
    The profiler slows the host, so the idle share is taken against
    `wall_ms`, the forward's time measured without it.  A forward that
    fails fails the run; a profiler that cannot start, stop or show
    device time prints "not measured"."""
    from torch.profiler import ProfilerActivity, profile

    os.environ["MXNET_FUSED_CONVBN"] = "1" if fused else "0"
    tag = "fused" if fused else "unfused"
    with torch.inference_mode():
        net(xb)
        torch.cuda.synchronize()
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    try:
        prof.start()
    except Exception as e:  # noqa: BLE001 — auxiliary measurement
        print(f"profile {tag}: not measured ({type(e).__name__}: {e})",
              flush=True)
        return None
    stop_error = None
    try:
        with torch.inference_mode():
            for _ in range(iters):
                net(xb)
            torch.cuda.synchronize()
    finally:
        try:
            prof.stop()
        except Exception as e:  # noqa: BLE001 — auxiliary measurement
            stop_error = e
    if stop_error is not None:
        print(f"profile {tag}: not measured ({type(stop_error).__name__}: "
              f"{stop_error})", flush=True)
        return None
    try:
        rows = []
        for e in prof.key_averages():
            # device-side events only (kernels, copies); CPU ops carry the
            # same time attributed to them and would count it twice
            if not str(getattr(e, "device_type", "")).endswith("CUDA"):
                continue
            dev = getattr(e, "self_device_time_total", None)
            if dev is None:
                dev = getattr(e, "self_cuda_time_total", 0.0)
            if dev > 0:
                rows.append((dev / 1e3 / iters, e.count // iters, e.key))
        rows.sort(reverse=True)
        busy = sum(r[0] for r in rows)
        if busy <= 0:
            print(f"profile {tag}: device time not measured (profiler "
                  f"shows none)", flush=True)
            return None
        print(f"profile {tag} bf16 batch {xb.shape[0]}: device busy "
              f"{busy:.3f} ms/forward; against the un-profiled "
              f"{wall_ms:.3f} ms forward the idle share is "
              f"{1 - busy / wall_ms:.1%} [{card}]", flush=True)
        for ms, n, key in rows[:8]:
            print(f"    {ms:8.3f} ms  x{n:<4d} {key[:90]}", flush=True)
        return {"wall_ms": wall_ms, "busy_ms": busy,
                "top": [[ms, n, key[:120]] for ms, n, key in rows[:12]]}
    except Exception as e:  # noqa: BLE001 — auxiliary measurement
        print(f"profile {tag}: not measured ({type(e).__name__}: {e})",
              flush=True)
        return None


def main():
    card = phase_device()
    phase_build()
    recs = phase_kernels()
    main_res = phase_main(card, REQUESTS, THREADS)
    summary = kernel_summary(recs, main_res.get("launches", 0))
    if FAILURES:
        print(f"chip_smoke: {len(FAILURES)} failure(s)", flush=True)
        return 1
    print(f"card: {card}", flush=True)
    print(json.dumps({"kernels": [summary]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
