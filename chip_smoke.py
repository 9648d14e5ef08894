#!/usr/bin/env python3
"""Smoke run of mxnet_tpu_torch on one CUDA card.

    python3 chip_smoke.py            # every phase, one card (or more)

Phases, each failing loudly (exit code 1, no result line):

1. device: CUDA must be present; prints the card's name and power limit
   (nvidia-smi) and turns TF32 off for every fp32 comparison.
2. build: compiles the port's CUDA kernels from mxnet_tpu_torch/csrc with
   nvcc and prints the build time and ptxas' register/smem report.
3. kernels, at the shapes each main path gives them: fused_conv_unit's
   CUDA kernel against its plain PyTorch version at the 20 fused-unit
   configurations of ResNet-50 v1 at 224x224 in bf16, at N=32 without
   statistics (a served batch) and at N=256 with them and a random shift
   (a training step); then two fp32 configurations, a 3x3 stride-2 one
   (BasicBlockV1) at N=32 and bf16 edge cases: M off every tile (N=3 at
   7x7), Co=72, Ci=40, 3x3 stride 2 with in_bias -1.5 and +2.0 (padding
   after the affine), N=1 at 56x56.  Two launches must give bit-identical
   y, s1 and s2 (a training shape with two reduction passes and three
   extras), and bf16 Ci=12 must raise without a launch.  One line per
   configuration: the output tile, kernel_ms (the launch step, conv
   kernel and statistics reduction, on OHWI weights, replayed from a
   CUDA graph: device time), op_ms (the whole wrapper call), ref_ms (the
   plain version), library_ms (F.conv2d on the pre-activated input, a
   yardstick the port never calls) and bound_ms (max of FLOPs over peak
   and bytes over 3.35 TB/s, where x counts only the pixels the taps
   read).
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
   Then fused_conv_unit_bwd's CUDA kernel (kernel 2: the dy fold, dgrad,
   split-K wgrad and their reductions) against its plain version at the
   14 stride-1 configurations of ResNet-50 v1 (N=256, bf16, want_stats
   on), then one fp32 and one want_stats-off configuration (N=32) and
   bf16 edge cases: M off every tile (N=3 at 7x7), Co=72 and Co=20 (dy's
   padded pitch, with and without statistics), Ci=40, 3x3 with in_bias
   -1.5 and +2.0 (padding after the affine), N=1 at 56x56, and several
   wgrad splits with two gscale reduction passes; y from the forward
   kernel, random cotangents.  Two launches must give bit-identical gx,
   dw, gscale and gbias (a training shape and four edge cases), and bf16
   Ci=12 must raise without a launch.  kernel_ms is the launch step
   replayed from a CUDA graph (device time), op_ms the whole wrapper
   call; each training configuration prints torch.profiler's split of
   the launch step into fold, dgrad, wgrad and reductions (shares only).
   library_ms is PyTorch's dgrad + wgrad convolutions
   (torch.nn.grad.conv2d_input + conv2d_weight) on the same tensors;
   bound_ms is max(2x the forward FLOPs / peak, bytes of x, y, gy, gx, w,
   dw / 3.35 TB/s).  Tolerances: gx and dw as y above (bf16: 1 ulp +
   4*sqrt(K)*2^-24*sum|terms| on >= 99.9%, <= 2 ulp + slack everywhere;
   fp32: 2^-23 relative + the slack), K = kh*kw*Co for gx and N*Ho*Wo for
   dw; gscale and gbias within 1e-4 of sum|terms|; without act_in
   exactly 0.
   Then the attention kernel (dot_product_attention, kernel 5) against its
   plain version at BERT-base serving shapes: (B*H, S, D) = (384, 128, 64)
   bf16 through `attend` and the packed (32, 128, 768) projections through
   the op as the main path calls it, valid lengths from a seed in
   [1, 128] with one row at 0; then one fp32 case, S = 200 with lengths
   [200, 77], causal with S = 40 and Sk = 72, and the head-split layout.
   kernel_ms times launches through the wrapper's launch step (device-
   bound), op_ms the whole op call, ref_ms the plain version, library_ms
   F.scaled_dot_product_attention on the same tensors (a yardstick the
   port never calls), bound_ms max(4*BH*S*Sk*D / peak, bytes of q, k, v,
   out and mask / 3.35 TB/s).  Tolerances: bf16 |o - o_ref| <= 2 bf16
   ulps of o_ref + 2^-8 * sum_k p_k |v_k|; fp32 <= 1e-5 * sum_k p_k |v_k|;
   fully masked rows at the mean of v over the real keys.
4. main path, serving: full-width ResNet-50 v1 (random weights from a
   seed), bf16, NHWC, 224x224, exported with export_model, served through
   ModelRepository -> InferenceServer with MXNET_FUSED_CONVBN=1 to
   requests from several threads.  Every request must be answered, the
   kernel launch count must rise by exactly 52 per launched batch, and
   the answers must match a direct forward with MXNET_FUSED_CONVBN=0
   (op-granular, no kernel) to relative L2 error < 2e-2; then the same
   with an fp32 copy of the net, bound 1e-4.
4b. main path, BERT serving: full-width BERT-base (bert_12_768_12,
   Normal(0.02) weights from a seed), exported with dynamic_batch=True in
   bf16 and fp32 and served through ModelRepository -> InferenceServer
   (max_batch_size 32, batch_timeout_ms 2) to single-sequence requests of
   128 tokens (valid lengths from a seed in [16, 128]) from several
   threads.  Every request must be answered with its (seq, pooled) pair,
   the attention kernel must launch exactly 12 times per launched batch,
   and the answers of 16 requests must match the port's fp32 forward of
   the same weights on the CPU (plain versions) to relative L2 < 2e-2
   (bf16) and < 1e-4 (fp32 served on the card).  Scrambling the tokens at
   and past valid_length must not change a valid position.  Then req/s,
   p50/p99, a direct batch-32 forward time and its torch.profiler
   breakdown (the kernel's share, the idle share).
5. main path, training (bench.py's configuration): make_mesh(dp=1) +
   SPMDTrainer(SoftmaxCrossEntropyLoss, sgd lr 0.1 momentum 0.9 wd 1e-4)
   on full-width ResNet-50 v1, bf16, NHWC, 224x224, batch 256, a fixed
   synthetic batch, with MXNET_FUSED_CONVBN=1 and MXNET_FUSED_CONVBN_BWD=1.
   Every step must launch the forward kernel exactly 52 times and the
   backward kernel 46 times, and give a finite loss.  One step from
   identical weights (running means warm) is held against the
   op-granular step (both knobs off, cuDNN), and both against a step of
   a higher-precision copy (fp32 at batch 8 against float64; bf16 at
   batch 256 against fp32), leaf by leaf (step_agreement): on every
   leaf where op-granular lands within 25% of the reference, the fused
   update w1 - w0, and the logits of a training-mode forward, must lie
   within 2x (fp32) / 1.25x (bf16) the op-granular distance, or the
   witness's where larger, plus 1e-4 (fp32) / 2e-2 (bf16) of the
   reference; the loss within 1e-5 (fp32) / 2e-2 (bf16) relative of
   op-granular's.  The fp32 witness is the float64 step with inputs and
   weights moved by 2^-24 relative: at random weights it lands ~0.7%
   away, so no fp32 step can be held to 1e-3 over all weights.  Then
   each mode trains its own copy of the net, in turns, timed and
   profiled (with the fused step's kernel-2 time split into fold, dgrad,
   wgrad and reductions, as shares).
6. main path, data-parallel training: kernels 1 (with statistics) and 2
   checked as in phase 3 at the per-rank shapes (N = 256 / 2), then
   bench.py's step over 2 rank processes of this script (spawned, never
   forked; `--dp-rank r` runs one), each calling dist.init() from the
   DMLC_* environment -> make_mesh(dp=2) -> SPMDTrainer(...).step on
   phase 5's weights and global batches: fp32 at batch 8 and bf16 at
   batch 256, fused with the fused backward and op-granular.  With one
   card both ranks run on cuda:0 over gloo; with two or more, rank r on
   cuda:r over NCCL; every time is printed beside that mode.  Every
   fused step must launch 52 forward and 46 backward kernels on each
   rank; after every step the ranks must hold bit-identical parameters,
   running statistics and momenta (hashes); rank 0's update and the
   loss are held against phase 5's reference of the same step by phase
   5's per-leaf rule (fp32 against float64 with its witness, bf16
   against fp32).  Then 3 timed steps a mode and a profile of a fused
   step on rank 0 (kernel time, kernel 2's split as in phase 5, the
   collectives' host and device time).
   A rank that fails or outlives its time makes the parent kill every
   rank and fail.
7. the probe path (row 6): kernel 6 (candidate_tap, the tap-accumulation
   unit with an explicit batch tile nb) against its plain version by
   phase 3's tolerances: (a) at the probe's four cases (N=4, nb=2, bf16,
   the probe's own inputs), one fp32 case, one want_stats-off and one
   act_in-off case, a 3x3 stride-2 case at nb 1 and 4, and N=6 at nb=4,
   which must raise without a launch; (b) at the nine batch-256 layers
   of the probe's time mode for each nb in {1, 16, 256}.  library_ms is
   F.conv2d on the pre-activated input, bound_ms phase 3's.  (c) The
   probe's entry point, mxnet_tpu_torch.tools.convbn_probe.main(argv),
   in check mode and in time mode on cuda:0, with the launch counters of
   kernels 1 and 6 set to 0 just before: both must return 0, kernel 6
   must launch once per call the probe made (4 + 9 x 3 x 12) and kernel
   1 once per timed call (9 x 12).  Prints the probe's per-layer table
   (kernel 1, the op-granular unit, kernel 6 by nb, F.conv2d, the bound)
   and its ratios, then a torch.profiler split of kernels 1 and 6 (at
   each nb) into the conv kernel and the statistics reduction over one
   sweep of the nine layers, and of kernel 1 per layer.

The line before the last is the kernel summary {"kernels": [...]}, one
entry per kernel and main path (kernel 1 served, trained and per rank
under dp, kernel 2 trained and per rank under dp, kernel 5 on the BERT
serving path, kernel 6 on the probe path: summed over the 27
configurations of one time sweep, with ms_by_nb), from the checks at
that path's shapes; the last line is
{"ok": true, "device": {"platform": "gpu", ...}}.
"""
from __future__ import annotations

import contextlib
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
# phase 3's extra kernel-1 cases, all with statistics: name, N, hw, Ci,
# Co, k, s, p, act_in, dtype, in_bias (None: random); the edge cases hold
# M off every tile (N=3 at 7x7), Co and Ci off 64, padding after a
# strongly negative and a positive affine, and one image at 56x56
UNIT_EXTRAS = [
    ("fp32.s2.conv2", BATCH, 28, 128, 128, 3, 1, 1, True, torch.float32,
     None),
    ("fp32.s3.conv1.first", BATCH, 28, 512, 256, 1, 2, 0, False,
     torch.float32, None),
    ("basic.3x3s2", BATCH, 56, 64, 128, 3, 2, 1, True, torch.bfloat16, None),
    ("edge.n3.7x7", 3, 7, 512, 512, 3, 1, 1, True, torch.bfloat16, None),
    ("edge.co72", 8, 14, 64, 72, 1, 1, 0, True, torch.bfloat16, None),
    ("edge.ci40", 8, 14, 40, 64, 3, 1, 1, True, torch.bfloat16, None),
    ("edge.3x3s2.bias-1.5", 8, 28, 64, 128, 3, 2, 1, True, torch.bfloat16,
     -1.5),
    ("edge.3x3s2.bias+2.0", 8, 28, 64, 128, 3, 2, 1, True, torch.bfloat16,
     2.0),
    ("edge.n1.56x56", 1, 56, 64, 64, 3, 1, 1, True, torch.bfloat16, None)]
DETERMINISM_CASES = ("basic.3x3s2", "edge.n3.7x7", "edge.ci40")
KERNEL_TAP = {"name": "candidate_tap", "route": "cuda",
              "source": "mxnet_tpu_torch/csrc/convbn_tap.cu",
              "replaces": "tools/scratch_convbn_probe.py:17"}
KERNEL_BWD = {"name": "fused_conv_unit_bwd", "route": "cuda",
              "source": "mxnet_tpu_torch/csrc/fused_convbn_bwd.cu",
              "replaces": "mxnet_tpu/ops/pallas_convbn.py:283"}
TRAIN_BATCH, TRAIN_STEPS = 256, 3     # bench.py's batch; timed steps a mode
TRAIN_FP32_BATCH = 8
TRAIN_OPT = {"learning_rate": 0.1, "momentum": 0.9, "wd": 1e-4}
FWD_PER_STEP, BWD_PER_STEP = 52, 46   # fused units; the stride-1 ones
# one step, fused against op-granular and a higher-precision reference
# (see step_agreement): a leaf's update is checked where op-granular lands
# within LEAF_POWER of the reference
LEAF_POWER = 0.25
TRAIN_BOUNDS_FP32 = dict(loss=1e-5, rel=2.0, abs=1e-4)
TRAIN_BOUNDS_BF16 = dict(loss=2e-2, rel=1.25, abs=2e-2)
KERNEL_ATT = {"name": "dot_product_attention", "route": "cuda",
              "source": "mxnet_tpu_torch/csrc/attention.cu",
              "replaces": "mxnet_tpu/ops/pallas_attention.py:102"}
# BERT-base serving (bench_all.py's sequence length): one kernel launch
# per encoder layer and served batch
BERT_SEQ, BERT_LAYERS, BERT_HEADS, BERT_UNITS = 128, 12, 12, 768
BERT_VOCAB = 30522
BERT_CHECKED = 16            # requests held against the CPU fp32 forward
BERT_BOUNDS = {"bf16": 2e-2, "fp32": 1e-4}
# phase 6: bench.py's step data parallel over DP ranks; rows 3-4 of the
# TPU kernel table are kernels 1-2 per rank plus the sums over the ranks
DP = 2
DP_TIMEOUT = 480.0             # s, the ranks' whole run
DP_COLLECTIVE_TIMEOUT = 180.0  # s, one collective
# the device functions of kernels 1, 6 and 2 as torch.profiler names them
KERNEL1_NAMES = ("::conv_unit_wgmma_kernel<", "::stats_reduce_kernel<0>(")
KERNEL6_NAMES = ("::convbn_tap_kernel<", "::tap_reduce_tiles_kernel(",
                 "::tap_reduce_total_kernel(")
# kernel 2's device functions by part of its launch step (bf16; fp32 runs
# dgrad_fma_kernel and wgrad_fma_kernel)
KERNEL2_PARTS = {"fold": ("::fold_dy_kernel(",),
                 "dgrad": ("::dgrad_wgmma_kernel<", "::dgrad_fma_kernel("),
                 "wgrad": ("::wgrad_wgmma_kernel<", "::wgrad_fma_kernel("),
                 "reductions": ("::stats_reduce_kernel<1>(",
                                "::wgrad_reduce_kernel<")}
KERNEL2_NAMES = tuple(n for names in KERNEL2_PARTS.values() for n in names)
# phase 3's extra kernel-2 cases, bf16 unless noted: name, N, hw, Ci, Co,
# k, p, act_in, want_stats, dtype, in_bias (None: random); the edge cases
# hold M off every tile, Co off 8 and 64 (dy_tot's padded pitch, folded
# and copied), Ci off 64, padding after a strongly negative and a positive
# affine, one image at 56x56, and several wgrad splits with two gscale
# reduction passes
BWD_EXTRAS = [
    ("fp32.s2.conv2", BATCH, 28, 128, 128, 3, 1, True, True, torch.float32,
     None),
    ("nostats.s3.conv3", BATCH, 14, 256, 1024, 1, 0, True, False,
     torch.bfloat16, None),
    ("edge.n3.7x7", 3, 7, 512, 512, 3, 1, True, True, torch.bfloat16, None),
    ("edge.co72", 8, 14, 64, 72, 1, 0, True, True, torch.bfloat16, None),
    ("edge.co20", 8, 14, 64, 20, 3, 1, True, True, torch.bfloat16, None),
    ("edge.co20.nostats", 8, 14, 64, 20, 3, 1, True, False, torch.bfloat16,
     None),
    ("edge.ci40", 8, 14, 40, 64, 3, 1, True, True, torch.bfloat16, None),
    ("edge.bias-1.5", 8, 28, 64, 128, 3, 1, True, True, torch.bfloat16,
     -1.5),
    ("edge.bias+2.0", 8, 28, 64, 128, 3, 1, True, True, torch.bfloat16, 2.0),
    ("edge.n1.56x56", 1, 56, 64, 64, 3, 1, True, True, torch.bfloat16, None),
    ("edge.splits.passes", 16, 28, 128, 128, 3, 1, True, True,
     torch.bfloat16, None)]
BWD_DETERMINISM_CASES = ("s1.conv2", "edge.n3.7x7", "edge.co20",
                         "edge.ci40", "edge.splits.passes")
KERNEL_DP = dict(KERNEL, name="fused_conv_unit/dp",
                 replaces="mxnet_tpu/ops/pallas_convbn.py:618")
KERNEL_BWD_DP = dict(KERNEL_BWD, name="fused_conv_unit_bwd/dp",
                     replaces="mxnet_tpu/ops/pallas_convbn.py:406")

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


def graph_ms(fn, launches=10, reps=3):
    """Device time of one call of `fn`: CUDA events around replays of a
    CUDA graph that holds `launches` calls, so the host's time to enqueue
    them drops out."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(launches):
            fn()
    g.replay()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        g.replay()
    b.record()
    torch.cuda.synchronize()
    del g
    return a.elapsed_time(b) / (reps * launches)


def bf16_ordered(t):
    """bf16 bit patterns as integers ordered like the values."""
    i = t.contiguous().view(torch.int16).to(torch.int32)
    return torch.where(i < 0, -(i & 0x7FFF), i)


def bf16_ulp(t):
    """The spacing of bf16 numbers at |t| (fp32 tensor)."""
    a = t.abs().clamp_min(2.0 ** -126)
    return torch.exp2(torch.floor(torch.log2(a)) - 7)


def hold_unit(name, x, w, sc, bi, k, s, p, act_in, want_stats, got, ref):
    """A fused unit's (y, s1, s2) against its plain version's, by the
    tolerances of the docstring; w is (Co, Ci, k, k).  Returns (ok,
    max_abs_err, note)."""
    y, s1, s2 = got
    yr, s1r, s2r = ref
    ok = True
    err = (y.float() - yr.float()).abs()
    max_abs = float(err.max())
    if x.dtype == torch.bfloat16:
        u = (x.float() * sc + bi).clamp_min(0).to(x.dtype) if act_in else x
        mag = F.conv2d(u.permute(0, 3, 1, 2).float().abs(), w.float().abs(),
                       stride=(s, s), padding=(p, p)).permute(0, 2, 3, 1)
        slack = 4.0 * math.sqrt(k * k * x.shape[-1]) * 2.0 ** -24 * mag
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
    return ok, max_abs, ytol


def check_unit(name, x, w, sc, bi, sh, k, s, p, act_in, want_stats):
    """Kernel vs plain version on one configuration; returns a record."""
    from mxnet_tpu_torch.ops import fused_convbn as fcb
    from mxnet_tpu_torch.tools.convbn_probe import unit_bound

    kernel, stride, pad = (k, k), (s, s), (p, p)
    args = (x, w, sc, bi, sh)
    kw = dict(kernel=kernel, stride=stride, pad=pad, act_in=act_in,
              want_stats=want_stats)
    got = fcb.fused_conv_unit(*args, **kw)
    torch.cuda.synchronize()
    ref = fcb.fused_conv_unit_ref(*args, kernel, stride, pad, act_in,
                                  want_stats)
    ok, max_abs, ytol = hold_unit(name, x, w, sc, bi, k, s, p, act_in,
                                  want_stats, got, ref)
    n, h, wd, ci = x.shape
    co = w.shape[0]
    bm, bn, _ = fcb.launch_plan(x.shape, co, kernel, stride, pad, x.dtype)
    # timings: kernel_ms the launch step (conv kernel and statistics
    # reduction) on OHWI weights, replayed from a CUDA graph, so the device
    # and not the host sets it; op_ms the whole wrapper call as the main
    # path makes it; the plain version and the library call on the same
    # inputs
    w_ohwi = fcb.weight_ohwi(w)
    kernel_ms = graph_ms(lambda: fcb._launch(x, w_ohwi, sc, bi, sh, kernel,
                                             stride, pad, act_in,
                                             want_stats))
    op_ms = time_ms(lambda: fcb.fused_conv_unit(*args, **kw))
    ref_ms = time_ms(lambda: fcb.fused_conv_unit_ref(
        *args, kernel, stride, pad, act_in, want_stats))
    u = (x.float() * sc + bi).clamp_min(0).to(x.dtype) if act_in else x
    u_nchw = u.permute(0, 3, 1, 2)
    library_ms = time_ms(lambda: F.conv2d(u_nchw, w, stride=stride,
                                          padding=pad))
    # the bound: x counts only the pixels some tap reads (a strided 1x1
    # conv skips 1 - 1/s^2 of them), each once
    rec = dict(name=name, dtype=str(x.dtype).replace("torch.", ""),
               shape=[n, h, wd, ci], co=co, k=k, s=s, p=p, act_in=act_in,
               want_stats=want_stats, ok=ok, max_abs_err=max_abs, tile=[bm, bn],
               kernel_ms=kernel_ms, op_ms=op_ms, ref_ms=ref_ms,
               library_ms=library_ms,
               **unit_bound(x.shape, co, kernel, stride, pad, x.dtype,
                            want_stats))
    print(f"  {name:<22} {rec['dtype']:<8} x{rec['shape']} co={co} k{k}s{s}"
          f"p{p} act={int(act_in)} stats={int(want_stats)} tile {bm}x{bn} | "
          f"kernel_ms={kernel_ms:.4f} op_ms={op_ms:.4f} ref_ms={ref_ms:.4f} "
          f"library_ms={library_ms:.4f} bound_ms={rec['bound_ms']:.4f} "
          f"({rec['bound_by']}) | {ytol} | {'ok' if ok else 'FAIL'}",
          flush=True)
    return rec


def make_unit_inputs(gen, n, hw, ci, co, k, dtype, dev):
    """Random inputs of one unit, drawn on the card from `gen`."""
    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=dev)
    x = randn(n, hw, hw, ci).to(dtype)
    w = (randn(co, ci, k, k) / math.sqrt(ci * k * k)).to(dtype)
    sc = torch.rand(ci, generator=gen, device=dev) + 0.5
    bi = randn(ci) * 0.5
    sh = randn(co) * 0.1
    return x, w, sc, bi, sh


def phase_kernels():
    """Kernel 1 at the shapes each main path gives it: the 20 ResNet-50
    configurations at N=BATCH without statistics (a served batch) and at
    N=TRAIN_BATCH with them (a training step); then two fp32
    configurations and a 3x3 stride-2 one at N=BATCH."""
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(1234)
    recs = []
    for n, want_stats, path in ((BATCH, False, "serve"),
                                (TRAIN_BATCH, True, "train")):
        print(f"kernel vs plain version, N={n}, want_stats={want_stats} "
              f"({path}):", flush=True)
        for (name, hw, ci, co, k, s, p, act_in, count) \
                in resnet50_unit_configs():
            x, w, sc, bi, sh = make_unit_inputs(gen, n, hw, ci, co, k,
                                                torch.bfloat16, dev)
            rec = check_unit(name, x, w, sc, bi, sh, k, s, p, act_in,
                             want_stats)
            recs.append(dict(rec, count=count, path=path))
            if want_stats and name == "s1.conv2":  # two reduction passes
                check_deterministic(f"{path}.{name}", x, w, sc, bi, sh, k, s,
                                    p, act_in)
            del x, w
        torch.cuda.empty_cache()
    print("kernel vs plain version, extras and edge cases:", flush=True)
    for (name, n, hw, ci, co, k, s, p, act_in, dt, bias) in UNIT_EXTRAS:
        x, w, sc, bi, sh = make_unit_inputs(gen, n, hw, ci, co, k, dt, dev)
        if bias is not None:
            bi = torch.full_like(bi, bias)
        rec = check_unit(name, x, w, sc, bi, sh, k, s, p, act_in, True)
        recs.append(dict(rec, count=0, path="extra"))
        if name in DETERMINISM_CASES:
            check_deterministic(name, x, w, sc, bi, sh, k, s, p, act_in)
    check_refuses_ci()
    torch.cuda.empty_cache()
    return recs


def same_bits(outs_a, outs_b):
    """[bit-identical?] for each pair of output tensors of two launches."""
    torch.cuda.synchronize()
    return [torch.equal(u.view(torch.int16 if u.element_size() == 2
                               else torch.int32),
                        v.view(torch.int16 if v.element_size() == 2
                               else torch.int32))
            for u, v in zip(outs_a, outs_b)]


def check_deterministic(name, x, w, sc, bi, sh, k, s, p, act_in):
    """Two launches on the same inputs give bit-identical y, s1 and s2."""
    from mxnet_tpu_torch.ops import fused_convbn as fcb

    kw = dict(kernel=(k, k), stride=(s, s), pad=(p, p), act_in=act_in,
              want_stats=True)
    bits = same_bits(fcb.fused_conv_unit(x, w, sc, bi, sh, **kw),
                     fcb.fused_conv_unit(x, w, sc, bi, sh, **kw))
    print(f"  {name}: two launches bit-identical y {bits[0]} s1 {bits[1]} "
          f"s2 {bits[2]}", flush=True)
    if not all(bits):
        fail(f"{name}: two launches differ (y, s1, s2 identical: {bits})")


def check_refuses_ci():
    """bf16 with Ci % 8 != 0 raises MXNetError and launches nothing."""
    from mxnet_tpu_torch.base import MXNetError
    from mxnet_tpu_torch.ops import fused_convbn as fcb

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(5)
    x, w, sc, bi, sh = make_unit_inputs(gen, 2, 8, 12, 64, 3, torch.bfloat16,
                                        dev)
    before = fcb.launch_count()
    try:
        fcb.fused_conv_unit(x, w, sc, bi, sh, kernel=(3, 3), pad=(1, 1),
                            act_in=True)
        fail("fused_conv_unit: bf16 Ci=12 did not raise")
    except MXNetError as e:
        print(f"  bf16 Ci=12 raises: {e}", flush=True)
    if fcb.launch_count() != before:
        fail("fused_conv_unit: the refused call launched the kernel")


def kernel_summary(kernel, recs, path, launches):
    """One record of the `kernels` line for one kernel on one main path:
    times and bounds summed over the launches of one forward (served
    batch of BATCH) or one training step (batch TRAIN_BATCH), from the
    checks at that path's shapes, each configuration weighted by how
    often the path launches it.  `launches` is the count of the path's
    counted run."""
    main = [r for r in recs if r["path"] == path and r["count"]]
    tot = {k: sum(r[k] * r["count"] for r in main)
           for k in ("kernel_ms", "ref_ms", "library_ms", "bound_ms")}
    by_ops = sum(r["bound_ms"] * r["count"] for r in main
                 if r["bound_by"] == "operations")
    rec = dict(kernel, path=path, batch=main[0]["shape"][0],
               launches=launches,
               max_abs_err=max(r["max_abs_err"] for r in main),
               ms=tot["kernel_ms"], plain_ms=tot["ref_ms"],
               bound_ms=tot["bound_ms"],
               bound_by="operations" if by_ops >= tot["bound_ms"] / 2
               else "bytes",
               library_ms=tot["library_ms"])
    if all("op_ms" in r for r in main):  # kernel 1: the whole wrapper call
        rec["op_ms"] = sum(r["op_ms"] * r["count"] for r in main)
    return rec


def bwd_split(rows):
    """Kernel 2's device time in a profile's rows, by part of its launch
    step: {part: ms} over KERNEL2_PARTS."""
    return {part: sum(ms for ms, _, k in rows
                      if any(n in k for n in names))
            for part, names in KERNEL2_PARTS.items()}


def print_bwd_shares(tag, split, card):
    total = sum(split.values())
    if total <= 0:
        print(f"profile {tag}: kernel 2 not measured (no device time)",
              flush=True)
        return
    print(f"profile {tag}: kernel 2 " + ", ".join(
        f"{part} {ms / total:.1%}" for part, ms in split.items())
        + f" of its profiled time (shares only) [{card}]", flush=True)


def check_unit_bwd(name, x, w, sc, bi, sh, k, p, act_in, want_stats, gen,
                   card=None):
    """Backward kernel vs its plain version on one stride-1
    configuration; y comes from the forward kernel, the cotangents from
    `gen`.  With `card`, also the profiler's split of the launch step into
    its parts (shares).  Returns a record."""
    from mxnet_tpu_torch.ops import fused_convbn as fcb

    kernel, pad = (k, k), (p, p)
    dev = x.device
    y, _, _ = fcb.fused_conv_unit(x, w, sc, bi, sh, kernel=kernel, pad=pad,
                                  act_in=act_in, want_stats=True)
    co = w.shape[0]
    gy = (torch.randn(y.shape, generator=gen, device=dev)
          / math.sqrt(y.numel())).to(x.dtype)
    gs1 = torch.randn(co, generator=gen, device=dev) * 1e-4
    gs2 = torch.randn(co, generator=gen, device=dev) * 1e-4
    args = (x, w, sc, bi, sh, y, gy, gs1, gs2)
    kw = dict(kernel=kernel, stride=(1, 1), pad=pad, act_in=act_in,
              want_stats=want_stats)
    got = fcb.fused_conv_unit_bwd(*args, **kw)
    torch.cuda.synchronize()
    ref = fcb.fused_conv_unit_bwd_ref(*args, kernel, (1, 1), pad, act_in,
                                      want_stats)
    # Σ|terms| of each sum: the conv gradients of |dy| and |u|, |w| in fp32
    dy_abs = fcb._fold_dy(y, gy, sh, gs1, gs2, want_stats).float().abs()
    u_abs = fcb._affine_in(x, sc, bi, act_in).float().abs()
    du_mag, dw_mag = fcb._conv_grads(u_abs, w.float().abs(), dy_abs, (1, 1),
                                     pad, torch.float32)
    n, h, wd, ci = x.shape
    m_out = y.shape[0] * y.shape[1] * y.shape[2]
    sc_abs = sc.abs() if act_in else torch.ones_like(sc)
    ok, notes, max_abs = True, [], 0.0
    for tag, a, b, mag, klen in (
            ("gx", got[0], ref[0], du_mag * sc_abs, k * k * co),
            ("dw", got[1], ref[1], dw_mag, m_out)):
        a, b = a.float(), b.float()
        err = (a - b).abs()
        max_abs = max(max_abs, float(err.max()))
        slack = 4.0 * math.sqrt(klen) * 2.0 ** -24 * mag
        if x.dtype == torch.bfloat16:
            ulp = bf16_ulp(b)
            frac = float((err <= ulp + slack).float().mean())
            worst = float(((err - slack) / ulp).max())
            notes.append(f"{tag} 1ulp+slack {frac * 100:.3f}% worst "
                         f"{worst:.2f}ulp")
            if frac < 0.999 or worst > 2.0:
                ok = False
                fail(f"bwd {name}: {tag} within 1 ulp on {frac:.5f} (< 0.999)"
                     f" or worst {worst:.2f} ulp (> 2)")
        else:
            bad = err > 2.0 ** -23 * b.abs() + slack
            notes.append(f"{tag} max_abs {float(err.max()):.3g}")
            if bool(bad.any()):
                ok = False
                fail(f"bwd {name}: fp32 {tag} off on {int(bad.sum())} "
                     f"elements (max abs {float(err.max()):.3g})")
    if act_in:
        scale_x = (du_mag * x.float().abs()).sum(dim=(0, 1, 2))
        scale_1 = du_mag.sum(dim=(0, 1, 2))
        for tag, a, b, s in (("gscale", got[2], ref[2], scale_x),
                             ("gbias", got[3], ref[3], scale_1)):
            rel = float(((a - b).abs() / s.clamp_min(1e-30)).max())
            notes.append(f"{tag} rel {rel:.2g}")
            if rel > 1e-4:
                ok = False
                fail(f"bwd {name}: {tag} rel err {rel:.3g} > 1e-4")
    elif bool(got[2].any()) or bool(got[3].any()):
        ok = False
        fail(f"bwd {name}: act_in=False but gscale/gbias are not zero")
    # timings: kernel_ms the launch step (fold, dgrad, wgrad and the
    # reductions) replayed from a CUDA graph, so the device and not the
    # host sets it; op_ms the whole wrapper call as the main path makes it
    cargs = tuple(t.contiguous() for t in args)
    kernel_ms = graph_ms(lambda: fcb._launch_bwd(*cargs, kernel, pad, act_in,
                                                 want_stats))
    op_ms = time_ms(lambda: fcb.fused_conv_unit_bwd(*args, **kw))
    ref_ms = time_ms(lambda: fcb.fused_conv_unit_bwd_ref(
        *args, kernel, (1, 1), pad, act_in, want_stats))
    # yardstick: PyTorch's dgrad + wgrad convolutions on the same tensors
    u_nchw = fcb._affine_in(x, sc, bi, act_in).permute(0, 3, 1, 2)
    dy_nchw = fcb._fold_dy(y, gy, sh, gs1, gs2, want_stats).permute(
        0, 3, 1, 2)

    def library():
        torch.nn.grad.conv2d_input(u_nchw.shape, w, dy_nchw, padding=pad)
        torch.nn.grad.conv2d_weight(u_nchw, w.shape, dy_nchw, padding=pad)
    library_ms = time_ms(library)
    flops = 2.0 * (2.0 * m_out * co * k * k * ci)
    item = x.element_size()
    nbytes = (x.numel() * 2 + y.numel() * 2 + w.numel() * 2) * item
    peak = PEAK_BF16 if x.dtype == torch.bfloat16 else PEAK_FP32
    t_ops, t_bytes = flops / peak * 1e3, nbytes / PEAK_BYTES * 1e3
    plan = fcb.bwd_launch_plan(x.shape, co, kernel, pad, x.dtype, want_stats)
    shares = None
    if card is not None:
        with contextlib.redirect_stdout(None):
            prof = profile_device(lambda: fcb._launch_bwd(
                *cargs, kernel, pad, act_in, want_stats), name, "call", card,
                1.0, iters=3, top=0)
        if prof is not None:
            split = bwd_split(prof["rows"])
            total = sum(split.values())
            if total > 0:
                shares = {part: ms / total for part, ms in split.items()}
    rec = dict(name=name, dtype=str(x.dtype).replace("torch.", ""),
               shape=[n, h, wd, ci], co=co, k=k, p=p, act_in=act_in,
               want_stats=want_stats, ok=ok, max_abs_err=max_abs,
               kernel_ms=kernel_ms, op_ms=op_ms, ref_ms=ref_ms,
               library_ms=library_ms, bound_ms=max(t_ops, t_bytes),
               bound_by="operations" if t_ops >= t_bytes else "bytes",
               gflop=flops / 1e9, mbytes=nbytes / 1e6,
               dgrad_tile=list(plan.dgrad_tile),
               wgrad_tile=list(plan.wgrad_tile), splits=plan.splits,
               shares=shares)
    share_txt = "" if shares is None else " | " + " ".join(
        f"{part} {v:.0%}" for part, v in shares.items())
    print(f"  bwd {name:<18} {rec['dtype']:<8} x{rec['shape']} co={co} k{k}"
          f"p{p} act={int(act_in)} stats={int(want_stats)} dgrad "
          f"{plan.dgrad_tile[0]}x{plan.dgrad_tile[1]} wgrad "
          f"{plan.wgrad_tile[0]}x{plan.wgrad_tile[1]}/{plan.splits} | "
          f"kernel_ms={kernel_ms:.4f} op_ms={op_ms:.4f} ref_ms={ref_ms:.4f} "
          f"library_ms={library_ms:.4f} bound_ms={rec['bound_ms']:.4f} "
          f"({rec['bound_by']}){share_txt} | {'; '.join(notes)} | "
          f"{'ok' if ok else 'FAIL'}", flush=True)
    if name in BWD_DETERMINISM_CASES:
        check_deterministic_bwd(name, args, kw)
    return rec


def check_deterministic_bwd(name, args, kw):
    """Two launches on the same inputs give bit-identical gx, dw, gscale
    and gbias."""
    from mxnet_tpu_torch.ops import fused_convbn as fcb

    bits = same_bits(fcb.fused_conv_unit_bwd(*args, **kw),
                     fcb.fused_conv_unit_bwd(*args, **kw))
    print(f"  bwd {name}: two launches bit-identical gx {bits[0]} dw "
          f"{bits[1]} gscale {bits[2]} gbias {bits[3]}", flush=True)
    if not all(bits):
        fail(f"bwd {name}: two launches differ (gx, dw, gscale, gbias "
             f"identical: {bits})")


def check_refuses_ci_bwd():
    """bf16 with Ci % 8 != 0 raises MXNetError and launches nothing."""
    from mxnet_tpu_torch.base import MXNetError
    from mxnet_tpu_torch.ops import fused_convbn as fcb

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(6)
    x, w, sc, bi, sh = make_unit_inputs(gen, 2, 8, 12, 64, 3, torch.bfloat16,
                                        dev)
    y = torch.randn(2, 8, 8, 64, generator=gen, device=dev).to(x.dtype)
    before = fcb.bwd_launch_count()
    try:
        fcb.fused_conv_unit_bwd(x, w, sc, bi, sh, y, y.clone(),
                                kernel=(3, 3), pad=(1, 1), act_in=True)
        fail("fused_conv_unit_bwd: bf16 Ci=12 did not raise")
    except MXNetError as e:
        print(f"  bwd bf16 Ci=12 raises: {e}", flush=True)
    if fcb.bwd_launch_count() != before:
        fail("fused_conv_unit_bwd: the refused call launched the kernel")


def phase_kernels_bwd(card):
    """The backward kernel at the 14 stride-1 configurations of ResNet-50
    v1 at the training step's shapes (N=TRAIN_BATCH, bf16, want_stats
    on), each with the profiler's split of its launch step, then the
    extras and edge cases of BWD_EXTRAS."""
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(4321)
    recs = []
    cfgs = [c for c in resnet50_unit_configs() if c[5] == 1]
    if len(cfgs) != 14 or sum(c[8] for c in cfgs) != BWD_PER_STEP:
        fail(f"bwd: {len(cfgs)} stride-1 configurations launched "
             f"{sum(c[8] for c in cfgs)} times (want 14 and {BWD_PER_STEP})")
    print(f"backward kernel vs plain version, N={TRAIN_BATCH} (train), "
          f"then extras and edge cases:", flush=True)
    cases = [(name, TRAIN_BATCH, hw, ci, co, k, p, act_in, True,
              torch.bfloat16, None, count)
             for (name, hw, ci, co, k, s, p, act_in, count) in cfgs]
    cases += [c + (0,) for c in BWD_EXTRAS]
    for (name, n, hw, ci, co, k, p, act_in, stats, dt, bias, count) in cases:
        x, w, sc, bi, sh = make_unit_inputs(gen, n, hw, ci, co, k, dt, dev)
        if bias is not None:
            bi = torch.full_like(bi, bias)
        rec = check_unit_bwd(name, x, w, sc, bi, sh, k, p, act_in, stats,
                             gen, card=card if count else None)
        recs.append(dict(rec, count=count, path="train" if count else "extra"))
        del x, w
        torch.cuda.empty_cache()
    check_refuses_ci_bwd()
    return recs


# ---------------------------------------------------------------------------
# phase 3c: the attention kernel against its plain version
# ---------------------------------------------------------------------------

def key_mask(gen, rows, sk, lengths=None, zero_rows=0):
    """(rows, sk) 1/0 key mask: valid lengths from `gen` in [1, sk] (or
    the given ones), the first `zero_rows` rows at length 0."""
    if lengths is None:
        lengths = torch.randint(1, sk + 1, (rows,), generator=gen)
    lengths = torch.as_tensor(lengths).clone()
    lengths[:zero_rows] = 0
    return (torch.arange(sk)[None, :] < lengths[:, None]).float()


def check_attention(name, q, k, v, mask, causal, card, heads=None):
    """The attention kernel against its plain version on one case.

    With `heads`, q/k/v are BERT's packed (B, S, heads*D) projections and
    the op runs as the main path calls it (mask (B, Sk)); else they are
    (BH, S, D) and `attend` runs (mask (BH, Sk)).  Tolerances: bf16
    |o - o_ref| <= 2 bf16 ulps of o_ref + 2^-8 * sum_k p_k |v_k| (one bf16
    rounding of each probability); fp32 <= 1e-5 * sum_k p_k |v_k|; a row
    whose keys are all masked is the mean of v over the real keys.
    Returns a record."""
    from mxnet_tpu_torch.ops import attention as att

    if heads is None:
        bh, s, d = q.shape
        qf, kf, vf, maskf = q, k, v, mask
        scale = 1.0 / math.sqrt(d)

        def run():
            return att.attend(q, k, v, mask, scale, causal)
    else:
        b, s, u = q.shape
        d = u // heads
        bh = b * heads

        def flat(x):
            return x.reshape(b, x.shape[1], heads, d).permute(
                0, 2, 1, 3).reshape(bh, x.shape[1], d)
        qf, kf, vf = flat(q), flat(k), flat(v)
        maskf = mask.repeat_interleave(heads, dim=0)
        scale = 1.0 / math.sqrt(d)

        def run():
            return att.dot_product_attention(q, k, v, mask, num_heads=heads,
                                             causal=causal)
    sk = kf.shape[1]
    out = run()
    torch.cuda.synchronize()
    if heads is not None:
        out = flat(out)
    ref = att.dot_product_attention_ref(qf, kf, vf, maskf.to(q.dtype), scale,
                                        causal)
    p = att._softmax(att._scores(qf, kf, maskf, scale, causal))
    spread = torch.matmul(p, vf.float().abs())
    o, r = out.float(), ref.float()
    err = (o - r).abs()
    if q.dtype == torch.bfloat16:
        lim = 2.0 * bf16_ulp(r) + 2.0 ** -8 * spread
    else:
        lim = 1e-5 * spread
    ok = bool(torch.isfinite(o).all()) and bool((err <= lim).all())
    worst = float((err / lim.clamp_min(1e-30)).max())
    dead = maskf.sum(dim=1) == 0
    dead_txt = ""
    if bool(dead.any()):
        mean_v = vf.float()[dead].mean(dim=1, keepdim=True)
        dev = float((o[dead] - mean_v).abs().max())
        dlim = (2.0 * bf16_ulp(mean_v) + 2.0 ** -8 * vf.float()[dead].abs()
                .mean(dim=1, keepdim=True)) if q.dtype == torch.bfloat16 \
            else 1e-5 * vf.float()[dead].abs().mean(dim=1, keepdim=True)
        dead_ok = bool(((o[dead] - mean_v).abs() <= dlim).all())
        ok = ok and dead_ok
        dead_txt = (f" | {int(dead.sum())} fully masked rows at the mean of "
                    f"v: max dev {dev:.3g} {'ok' if dead_ok else 'FAIL'}")
    if not ok:
        fail(f"attention {name}: kernel vs plain version off (worst "
             f"{worst:.3f} of the bound, max abs {float(err.max()):.3g})"
             f"{dead_txt}")
    # the kernel: launches through the wrapper's launch step on prepared
    # (B, H, S, D) views, so the device and not the op's Python sets the
    # pace; op_ms is the whole op call as the main path makes it
    if heads is None:
        q4, k4, v4 = qf[:, None], kf[:, None], vf[:, None]
        m4 = (maskf > 0)[:, None, None, :]
    else:
        q4, k4, v4 = (x.reshape(b, x.shape[1], heads, d).permute(0, 2, 1, 3)
                      for x in (q, k, v))
        m4 = (mask > 0)[:, None, None, :]
    out4 = att._out_buffer(q4, heads is not None)
    mk = mask.to(q.dtype)
    kernel_ms = time_ms(lambda: att._launch(q4, k4, v4, mk, scale, causal,
                                            out4), iters=20)
    op_ms = time_ms(run)
    ref_ms = time_ms(lambda: att.dot_product_attention_ref(
        qf, kf, vf, maskf.to(q.dtype), scale, causal))
    # yardstick the port never calls: PyTorch's fused attention on the
    # same (B, H, S, D) views, the key mask as a boolean (B, 1, 1, Sk),
    # and with `causal` the kernel's causal mask (last query on the last
    # key) as a boolean (S, Sk) folded into it
    if causal:
        qpos = torch.arange(s, device=q.device)[:, None] + (sk - s)
        m4 = m4 & (qpos >= torch.arange(sk, device=q.device)[None, :])
    library_ms = time_ms(lambda: F.scaled_dot_product_attention(
        q4, k4, v4, attn_mask=m4))
    item = q.element_size()
    nbytes = (2 * bh * s * d + 2 * bh * sk * d) * item + mask.numel() * item
    flops = 4.0 * bh * s * sk * d
    peak = PEAK_BF16 if q.dtype == torch.bfloat16 else PEAK_FP32
    t_ops, t_bytes = flops / peak * 1e3, nbytes / PEAK_BYTES * 1e3
    rec = dict(name=name, dtype=str(q.dtype).replace("torch.", ""),
               bh=bh, s=s, sk=sk, d=d, causal=causal,
               layout="packed" if heads else "(BH,S,D)", ok=ok,
               max_abs_err=float(err.max()), worst_of_bound=worst,
               kernel_ms=kernel_ms, op_ms=op_ms, ref_ms=ref_ms,
               library_ms=library_ms, bound_ms=max(t_ops, t_bytes),
               bound_by="operations" if t_ops >= t_bytes else "bytes",
               gflop=flops / 1e9, mbytes=nbytes / 1e6)
    print(f"  {name:<18} {rec['dtype']:<8} BH={bh} S={s} Sk={sk} D={d} "
          f"causal={int(causal)} {rec['layout']} | kernel_ms={kernel_ms:.4f}"
          f" op_ms={op_ms:.4f} ref_ms={ref_ms:.4f} library_ms="
          f"{library_ms:.4f} bound_ms={rec['bound_ms']:.4f} "
          f"({rec['bound_by']}) | max_abs {rec['max_abs_err']:.3g}, worst "
          f"{worst:.3f} of the bound{dead_txt} | {'ok' if ok else 'FAIL'} "
          f"[{card}]", flush=True)
    return rec


def phase_kernels_attention(card):
    """Kernel 5 at the BERT-base serving shapes (B*H = 32*12, S = Sk =
    128, D = 64, bf16; valid lengths from a seed in [1, 128], one row at
    0), as `attend` takes it and as the main path calls it (packed
    (B, S, 768) projections, a (B, Sk) mask); then one fp32 case, S = 200
    with lengths [200, 77] (several query tiles, Sk not a multiple of 8),
    causal with S = 40, Sk = 72, and the head-split layout."""
    dev = torch.device("cuda", 0)
    gen = torch.Generator().manual_seed(99)
    recs = {}

    def randn(*shape, dtype=torch.bfloat16):
        return torch.randn(*shape, generator=gen).to(dev, dtype)
    print("attention kernel vs plain version:", flush=True)
    bh = BATCH * BERT_HEADS
    d = BERT_UNITS // BERT_HEADS
    s = BERT_SEQ
    q, k, v = (randn(bh, s, d) for _ in range(3))
    m = key_mask(gen, bh, s, zero_rows=1).to(dev)
    recs["bert.(BH,S,D)"] = check_attention("bert.(BH,S,D)", q, k, v, m,
                                            False, card)
    q, k, v = (randn(BATCH, s, BERT_UNITS) for _ in range(3))
    m = key_mask(gen, BATCH, s, zero_rows=1).to(dev)
    recs["bert.packed"] = check_attention("bert.packed", q, k, v, m, False,
                                          card, heads=BERT_HEADS)
    q, k, v = (randn(48, s, d, dtype=torch.float32) for _ in range(3))
    m = key_mask(gen, 48, s, zero_rows=1).to(dev)
    recs["fp32"] = check_attention("fp32", q, k, v, m, False, card)
    q, k, v = (randn(2, 200, d) for _ in range(3))
    m = key_mask(gen, 2, 200, lengths=[200, 77]).to(dev)
    recs["s200"] = check_attention("s200.lens200,77", q, k, v, m, False,
                                   card)
    q = randn(8, 40, d)
    k, v = randn(8, 72, d), randn(8, 72, d)
    m = key_mask(gen, 8, 72).to(dev)
    recs["causal"] = check_attention("causal.s40.sk72", q, k, v, m, True,
                                     card)
    # head-split (B, H, S, D) input through the op
    from mxnet_tpu_torch.ops import attention as att

    q4, k4, v4 = (randn(4, BERT_HEADS, s, d) for _ in range(3))
    m = key_mask(gen, 4, s).to(dev)
    out = att.dot_product_attention(q4, k4, v4, m)
    torch.cuda.synchronize()
    ref = att.dot_product_attention_ref(
        *(x.reshape(-1, s, d) for x in (q4, k4, v4)),
        m.to(q4.dtype).repeat_interleave(BERT_HEADS, dim=0), 1 / math.sqrt(d))
    e = float((out.reshape(-1, s, d).float() - ref.float()).abs().max())
    same = bool(torch.equal(out.reshape(-1, s, d), att.attend(
        *(x.reshape(-1, s, d) for x in (q4, k4, v4)),
        m.repeat_interleave(BERT_HEADS, dim=0), 1 / math.sqrt(d))))
    print(f"  head-split (B,H,S,D) {tuple(q4.shape)}: max abs vs plain "
          f"{e:.3g}; bit-equal to the (BH,S,D) call: {same}", flush=True)
    if not same or not e < 0.05:
        fail(f"attention head-split layout: max abs {e:.3g}, equal to the "
             f"(BH,S,D) call: {same}")
    return recs


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


def build_net(dtype, seed, dev=None):
    from mxnet_tpu_torch import gpu, init
    from mxnet_tpu_torch.gluon.model_zoo import vision

    net = vision.resnet50_v1(classes=1000, layout="NHWC")
    net.initialize(init.Xavier(), ctx=dev or gpu(0), seed=seed)
    net.cast(dtype)
    net.hybridize()
    net.eval()
    return net


def serve(server, model, inputs, threads):
    """Submit one request per row of `inputs` (a tensor, or a list of
    tensors that share the row count) from `threads` client threads;
    returns (answers in row order, per-request latencies in s, wall s,
    errors).  A latency runs from submit to the future's completion."""
    xs = list(inputs) if isinstance(inputs, (list, tuple)) else [inputs]
    n = xs[0].shape[0]
    answers, t_sub, t_done = [None] * n, [0.0] * n, [0.0] * n
    errors = []

    def client(idx):
        futs = []
        for i in idx:
            t_sub[i] = time.perf_counter()
            f = server.submit(model, [x[i:i + 1] for x in xs])
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
    """Device time by kernel over `iters` direct forwards."""
    os.environ["MXNET_FUSED_CONVBN"] = "1" if fused else "0"

    def run():
        with torch.inference_mode():
            net(xb)
    return profile_device(run, f"{'fused' if fused else 'unfused'} bf16 "
                          f"batch {xb.shape[0]}", "forward", card, wall_ms,
                          iters)


def profile_device(run, tag, what, card, wall_ms, iters=3, top=10,
                   host_prefix=None):
    """Device time by kernel over `iters` calls of `run` (torch.profiler).
    The profiler slows the host, so the idle share is taken against
    `wall_ms`, the time of one call measured without it.  With
    `host_prefix`, also the host time per call inside the ranges whose
    name starts with it.  A call that fails fails the run; a profiler
    that cannot start, stop or show device time prints "not measured"."""
    from torch.profiler import ProfilerActivity, profile

    run()
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
        for _ in range(iters):
            run()
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
        rows, host = [], [0.0, 0]
        for e in prof.key_averages():
            mine = bool(host_prefix) and e.key.startswith(host_prefix)
            # device-side events only (kernels, copies); CPU ops carry the
            # same time attributed to them and would count it twice, and
            # the device span of a named range repeats its kernels' time
            if not str(getattr(e, "device_type", "")).endswith("CUDA"):
                if mine:
                    host[0] += e.cpu_time_total / 1e3 / iters
                    host[1] += e.count // iters
                continue
            if mine:
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
        print(f"profile {tag}: device busy {busy:.3f} ms/{what}; against "
              f"the un-profiled {wall_ms:.3f} ms {what} the idle share is "
              f"{1 - busy / wall_ms:.1%} [{card}]", flush=True)
        for ms, n, key in rows[:top]:
            print(f"    {ms:8.3f} ms  x{n:<4d} {key[:90]}", flush=True)
        out = {"wall_ms": wall_ms, "busy_ms": busy,
               "top": [[ms, n, key[:120]] for ms, n, key in rows[:12]],
               "rows": rows}
        if host_prefix:
            out["host_ms"], out["host_calls"] = host
            print(f"profile {tag}: host time in {host_prefix}* "
                  f"{host[0]:.3f} ms/{what} in {host[1]} calls", flush=True)
        return out
    except Exception as e:  # noqa: BLE001 — auxiliary measurement
        print(f"profile {tag}: not measured ({type(e).__name__}: {e})",
              flush=True)
        return None


# ---------------------------------------------------------------------------
# phase 4b: the main path — serve BERT-base
# ---------------------------------------------------------------------------

def bert_requests(n, seed):
    """n single-sequence requests of BERT_SEQ tokens: ids from a seed,
    token types 0 then 1 from a random split, valid lengths in [16, 128]."""
    gen = torch.Generator().manual_seed(seed)
    tok = torch.randint(0, BERT_VOCAB, (n, BERT_SEQ), generator=gen,
                        dtype=torch.int32)
    split = torch.randint(1, BERT_SEQ, (n, 1), generator=gen)
    types = (torch.arange(BERT_SEQ)[None, :] >= split).to(torch.int32)
    vlen = torch.randint(16, BERT_SEQ + 1, (n,), generator=gen).float()
    return [tok, types, vlen]


def bert_forward(net, inputs, dev, bs=BATCH):
    """(seq, pooled) of a direct forward over `inputs`, `bs` rows at a
    time, on `dev`."""
    seqs, pooled = [], []
    with torch.inference_mode():
        for i in range(0, inputs[0].shape[0], bs):
            a, b = net(*[x[i:i + bs].to(dev) for x in inputs])
            seqs.append(a)
            pooled.append(b)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    return torch.cat(seqs), torch.cat(pooled)


def phase_bert(card, n_requests, threads):
    """Full-width BERT-base (Normal(0.02) weights from a seed, as
    bench_all.py initialises it), exported with dynamic_batch=True in
    bf16 and fp32, served through ModelRepository -> InferenceServer to
    single-sequence requests from several threads.  Every request must
    be answered, the attention kernel must launch exactly BERT_LAYERS
    times per launched batch, and the answers (seq and pooled) of
    BERT_CHECKED requests must match the port's fp32 forward of the same
    weights on the CPU (plain versions): relative L2 < 2e-2 (bf16) and
    < 1e-4 (fp32 served on the card).  Positions at or past valid_length
    must not move the valid ones."""
    import gc

    from mxnet_tpu_torch import cpu, gpu, init, serving
    from mxnet_tpu_torch.contrib import deploy
    from mxnet_tpu_torch.gluon import load_numpy_params
    from mxnet_tpu_torch.gluon.model_zoo import bert
    from mxnet_tpu_torch.ops import attention as att

    gc.collect()
    torch.cuda.empty_cache()
    dev = torch.device("cuda", 0)
    result = {}
    tmp = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                       "chip_smoke_deploy")
    t0 = time.perf_counter()
    net = bert.get_bert_model("bert_12_768_12", vocab_size=BERT_VOCAB,
                              max_length=512, dropout=0.1)
    net.initialize(init.Normal(0.02), ctx=gpu(0), seed=3)
    net.hybridize()
    net.eval()
    w32 = {k: v.detach().cpu().clone()
           for k, v in net.collect_params().items()}
    reqs = bert_requests(n_requests, seed=21)
    example = [x[:1].to(dev) for x in reqs]
    paths = {"fp32": deploy.export_model(net, os.path.join(tmp, "bert_fp32"),
                                         example, dynamic_batch=True)}
    net.cast("bfloat16")
    paths["bf16"] = deploy.export_model(net, os.path.join(tmp, "bert_bf16"),
                                        example, dynamic_batch=True)
    print(f"bert: built, initialised and exported BERT-base "
          f"({sum(v.numel() for v in net.parameters()) / 1e6:.1f} M "
          f"parameters) in {time.perf_counter() - t0:.1f} s", flush=True)
    # the reference: the port's fp32 forward of the same weights on the CPU
    ref_net = bert.get_bert_model("bert_12_768_12", vocab_size=BERT_VOCAB,
                                  max_length=512, dropout=0.1)
    ref_net.initialize(ctx=cpu())
    load_numpy_params(ref_net, w32)
    ref_net.eval()
    t0 = time.perf_counter()
    checked = [x[:BERT_CHECKED] for x in reqs]
    ref_seq, ref_pooled = bert_forward(ref_net, checked, torch.device("cpu"))
    print(f"bert: CPU fp32 reference forward of {BERT_CHECKED} sequences in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    del ref_net
    repo = serving.ModelRepository()
    for tag, path in paths.items():
        repo.add(f"bert_{tag}", path)
    server = serving.InferenceServer(
        repo, serving.ServingConfig(max_batch_size=BATCH,
                                    batch_timeout_ms=2))
    try:
        for tag, n_req in (("bf16", n_requests), ("fp32", BATCH)):
            model = f"bert_{tag}"
            xs = [x[:n_req] for x in reqs]
            serve(server, model, [x[:4] for x in xs], 2)  # warm
            m = repo.get(model).metrics
            b0 = m.value("batches")
            att.reset_attention_launch_count()
            answers, lat, wall, errors = serve(server, model, xs, threads)
            launches = att.attention_launch_count()
            batches = m.value("batches") - b0
            for e in errors[:5]:
                fail(f"bert {tag}: {e}")
            if any(a is None for a in answers):
                fail(f"bert {tag}: {sum(a is None for a in answers)} of "
                     f"{n_req} requests unanswered")
                continue
            if launches != BERT_LAYERS * batches:
                fail(f"bert {tag}: {launches} attention launches for "
                     f"{batches} batches (want {BERT_LAYERS} per batch)")
            shapes_ok = all(
                isinstance(a, tuple) and len(a) == 2
                and tuple(a[0].shape) == (1, BERT_SEQ, BERT_UNITS)
                and tuple(a[1].shape) == (1, BERT_UNITS) for a in answers)
            seq = torch.cat([a[0].float().cpu() for a in answers])
            pooled = torch.cat([a[1].float().cpu() for a in answers])
            finite = bool(torch.isfinite(seq).all()
                          and torch.isfinite(pooled).all())
            e_seq = rel_l2(seq[:BERT_CHECKED], ref_seq)
            e_pool = rel_l2(pooled[:BERT_CHECKED], ref_pooled)
            row = max(rel_l2(seq[i], ref_seq[i]) for i in range(BERT_CHECKED))
            bound = BERT_BOUNDS[tag]
            print(f"bert {tag}: {n_req} requests from {threads} threads in "
                  f"{batches} batches, {launches} attention launches; vs the "
                  f"CPU fp32 forward ({BERT_CHECKED} requests) rel L2 seq "
                  f"{e_seq:.3g} (worst row {row:.3g}) pooled {e_pool:.3g} "
                  f"(bound {bound}); finite={finite} shapes={shapes_ok}",
                  flush=True)
            if not (e_seq < bound and e_pool < bound and row < bound
                    and finite and shapes_ok):
                fail(f"bert {tag}: served answers disagree with the CPU "
                     f"fp32 forward (seq {e_seq:.3g}, worst row {row:.3g}, "
                     f"pooled {e_pool:.3g}, bound {bound}, finite {finite},"
                     f" shapes {shapes_ok})")
            p50, p99 = percentile_ms(lat, 0.50), percentile_ms(lat, 0.99)
            result[tag] = dict(requests=n_req, batches=batches,
                               launches=launches, wall_s=wall,
                               req_per_s=n_req / wall, p50_ms=p50,
                               p99_ms=p99, rel_l2_seq=e_seq,
                               rel_l2_pooled=e_pool, worst_row=row)
            if tag == "bf16":
                result["launches"] = launches
            print(f"serving bert {tag}: {n_req / wall:.2f} requests/s, p50 "
                  f"{p50:.3f} ms, p99 {p99:.3f} ms (submit to answer), "
                  f"{n_req / max(batches, 1):.1f} rows per batch [{card}]",
                  flush=True)
    finally:
        server.shutdown(drain=True)
    # padding invariance on the card: scramble tokens and token types at
    # and past valid_length
    xs = [x[:8].clone() for x in reqs]
    tok2, typ2 = xs[0].clone(), xs[1].clone()
    past = torch.arange(BERT_SEQ)[None, :] >= xs[2][:, None]
    tok2[past] = (tok2[past] + 7919) % BERT_VOCAB
    typ2[past] = 1 - typ2[past]
    a, _ = bert_forward(net, xs, dev)
    b, _ = bert_forward(net, [tok2, typ2, xs[2]], dev)
    keep = (~past).to(dev)
    moved = float((a.float() - b.float()).abs()[keep].max())
    print(f"bert bf16 padding invariance: max change of a valid position "
          f"{moved:.3g} after scrambling the padding", flush=True)
    if moved != 0.0:
        fail(f"bert: valid positions moved by {moved:.3g} when the padding "
             f"changed")
    result["padding_max_change"] = moved
    # direct batch-32 forward and its profile
    xb = [x[:BATCH].to(dev) for x in reqs]
    with torch.inference_mode():
        fwd_ms = [time_ms(lambda: net(*xb), iters=5, warmup=2)
                  for _ in range(2)]
    print(f"direct forward bert bf16 batch {BATCH}: "
          f"{' '.join(f'{t:.3f}' for t in fwd_ms)} ms, "
          f"{' '.join(f'{BATCH / t * 1e3:.1f}' for t in fwd_ms)} seq/s "
          f"[{card}]", flush=True)
    result["forward_ms"] = fwd_ms

    def run():
        with torch.inference_mode():
            net(*xb)
    prof = profile_device(run, f"bert bf16 batch {BATCH}", "forward", card,
                          sum(fwd_ms) / len(fwd_ms), iters=3, top=12)
    if prof is not None:
        kern = sum(ms for ms, _, key in prof["top"]
                   if "attention_fwd_kernel" in key)
        print(f"profile bert: attention kernel {kern:.3f} ms of "
              f"{prof['busy_ms']:.3f} ms busy ({kern / prof['busy_ms']:.1%})"
              f" [{card}]", flush=True)
        prof["attention_ms"] = kern
    result["profile"] = prof
    del net
    gc.collect()
    torch.cuda.empty_cache()
    return result


# ---------------------------------------------------------------------------
# phase 5: the training main path — SPMDTrainer on ResNet-50 v1
# ---------------------------------------------------------------------------

def set_knobs(fused, bwd):
    os.environ["MXNET_FUSED_CONVBN"] = "1" if fused else "0"
    os.environ["MXNET_FUSED_CONVBN_BWD"] = "1" if bwd else "0"


def new_trainer(net, mesh=None):
    from mxnet_tpu_torch import parallel
    from mxnet_tpu_torch.gluon import loss as gloss

    return parallel.SPMDTrainer(net, gloss.SoftmaxCrossEntropyLoss(), "sgd",
                                dict(TRAIN_OPT),
                                mesh=mesh or parallel.make_mesh(dp=1))


def counted_steps(trainer, xb, yb, steps):
    """`steps` training steps with the launch counters reset just before
    and read just after; returns (losses, fwd launches, bwd launches,
    seconds per step by the host clock around synchronised steps)."""
    from mxnet_tpu_torch.ops import fused_convbn as fcb

    torch.cuda.synchronize()
    fcb.reset_launch_count()
    fcb.reset_bwd_launch_count()
    t0 = time.perf_counter()
    losses = [trainer.step(xb, yb) for _ in range(steps)]
    torch.cuda.synchronize()
    dt = (time.perf_counter() - t0) / steps
    return ([float(v) for v in losses], fcb.launch_count(),
            fcb.bwd_launch_count(), dt)


def warm_running_means(net, xb):
    """Set every BatchNorm running mean to its layer's mean over `xb`
    (one op-granular train forward from zero means leaves 0.1 x the batch
    mean in them), as in training past its first steps.  From cold zero
    means the single-pass shifted variance cancels catastrophically, and
    the fused and op-granular paths, which sum in different orders, then
    differ by percents in fp32 already."""
    from mxnet_tpu_torch.gluon import ActiveTrace

    set_knobs(False, False)
    with torch.no_grad():
        for k, v in net.collect_params().items():
            if k.endswith("running_mean"):
                v.zero_()
        with ActiveTrace(train=True):
            net(xb)
        for k, v in net.collect_params().items():
            if k.endswith("running_mean"):
                v.div_(0.1)


def restore(net, w0):
    with torch.no_grad():
        for k, v in net.collect_params().items():
            v.copy_(w0[k])


def one_step(net, w0, xb, yb, fused):
    """One step of a fresh trainer from the weights `w0`; returns (loss,
    fwd launches, bwd launches, {trainable leaf: update}).  The update is
    read as the step computes it, before w1 is rounded to the weight's
    dtype: the new momentum, which SGD's first step sets to w1 - w0 (a
    bf16 weight would round most of a 0.1·g step away)."""
    restore(net, w0)
    set_knobs(fused, fused)
    trainer = new_trainer(net)
    losses, fwd, bwd, _ = counted_steps(trainer, xb, yb, 1)
    return losses[0], fwd, bwd, {k: s[0] for k, s in trainer.opt_state.items()}


def train_logits(net, w0, xb, fused):
    """The logits of a training-mode forward (batch statistics) from the
    weights `w0`."""
    from mxnet_tpu_torch.gluon import ActiveTrace

    restore(net, w0)
    set_knobs(fused, fused)
    with torch.no_grad(), ActiveTrace(train=True):
        return net(xb).float()


@contextlib.contextmanager
def exact_var():
    """MXNET_BN_EXACT_VAR=1 (the two-pass variance) inside the block; the
    port reads the knob once per process, so the cached read is
    dropped on the way in and out."""
    from mxnet_tpu_torch.ops import nn as onn

    os.environ["MXNET_BN_EXACT_VAR"] = "1"
    onn._BN_EXACT_VAR = None
    try:
        yield
    finally:
        os.environ["MXNET_BN_EXACT_VAR"] = "0"
        onn._BN_EXACT_VAR = None


def perturb(t, rel, gen):
    """`t` with each element moved by a relative amount drawn uniformly
    from [-rel, rel]."""
    u = torch.rand(t.shape, generator=gen, device=t.device, dtype=t.dtype)
    return t * (1.0 + rel * (2.0 * u - 1.0))


def leaf_rel(a, b):
    """Relative L2 of a[k] - b[k] for each tensor of b, in float64."""
    out = {}
    for k, bk in b.items():
        bk = bk.double()
        out[k] = float((a[k].to(bk.device).double() - bk).norm()
                       / bk.norm().clamp_min(1e-300))
    return out


def rel_l2_all(a, b):
    """Relative L2 of a - b over all tensors of b together."""
    num = sum(float((a[k].to(b[k].device).double() - b[k].double()).norm())
              ** 2 for k in b)
    den = sum(float(b[k].double().norm()) ** 2 for k in b)
    return math.sqrt(num / max(den, 1e-300))


def leaf_check(e, e_op, e_wit, checked, bounds):
    """The per-leaf bound of step_agreement: e[k] <= bounds["rel"] x
    max(e_op[k], e_wit[k]) + bounds["abs"] on each checked leaf.
    Returns (the worst leaf's share of its bound, [(share, leaf, e,
    bound) over it])."""
    rows = []
    for k in checked:
        lim = bounds["rel"] * max(e_op[k], e_wit.get(k, 0.0)) + bounds["abs"]
        rows.append((e[k] / lim, k, e[k], lim))
    worst = max(r[0] for r in rows)
    return worst, [r for r in rows if not r[0] <= 1.0]


LEAF_GROUPS = ("stem", "stage1", "stage2", "stage3", "stage4", "output")


def leaf_group(name):
    if name.startswith("output"):
        return "output"
    i = int(name.split(".")[1])
    return "stem" if i < 4 else f"stage{i - 3}"


def print_leaf_table(tag, errs, checked):
    """Per group of leaves: the median and the largest relative L2 of
    each comparison over the leaves the check holds."""
    cols = list(errs)
    print(f"  {tag}: per-leaf update rel L2, median / max over the checked "
          f"leaves of each group", flush=True)
    print("    " + f"{'group':<8}{'leaves':>7}  "
          + "  ".join(f"{c:>22}" for c in cols), flush=True)
    for g in LEAF_GROUPS:
        ks = [k for k in checked if leaf_group(k) == g]
        if not ks:
            continue
        cells = []
        for c in cols:
            v = sorted(errs[c][k] for k in ks)
            cells.append(f"{v[len(v) // 2]:.3g} / {v[-1]:.3g}")
        print("    " + f"{g:<8}{len(ks):>7}  "
              + "  ".join(f"{s:>22}" for s in cells), flush=True)


def step_agreement(net, xb, yb, tag, ref_dtype, bounds, witness):
    """One step from identical weights (running means warm), fused with
    the fused backward against op-granular (cuDNN), each held against an
    op-granular step of a `ref_dtype` copy of the net, leaf by leaf.

    A leaf is checked where the op-granular update lands within
    LEAF_POWER of the reference: there the comparison can tell a right
    update from a wrong one (a conv bias that a BatchNorm follows has a
    gradient of rounding noise only).  On each checked leaf the fused
    update must lie within bounds["rel"] x max(op-granular's distance,
    the witness's) + bounds["abs"] of the reference, and so must the
    logits of a training-mode forward.  With `witness`, the reference
    step and forward are repeated with the inputs and every weight moved
    by up to 2^-24 relative (less than one fp32 rounding): how far that
    moves a float64 step is how far the function itself lets any fp32
    step land.  The op-granular step is then also repeated with the
    exact two-pass variance (MXNET_BN_EXACT_VAR=1), against a float64
    step that uses it too.  The loss is held to bounds["loss"] of the
    op-granular loss.  Returns the record, and what phase 6 needs to hold
    a step against the same reference (on the host)."""
    import copy

    dev = xb.device
    w0 = {k: v.detach().clone() for k, v in net.collect_params().items()}
    ref_net = copy.deepcopy(net).to(ref_dtype)
    w_ref = {k: v.to(ref_dtype) for k, v in w0.items()}
    x_ref = xb.to(ref_dtype)
    z_ref = train_logits(ref_net, w_ref, x_ref, False)
    l_ref, _, _, d_ref = one_step(ref_net, w_ref, x_ref, yb, False)
    errs, z_errs = {}, {}
    if witness:
        gen = torch.Generator(device=dev).manual_seed(5)
        w_p = {k: perturb(v, 2.0 ** -24, gen) for k, v in w_ref.items()}
        x_p = perturb(x_ref, 2.0 ** -24, gen)
        z_errs["witness"] = rel_l2(train_logits(ref_net, w_p, x_p, False),
                                   z_ref)
        errs["witness"] = leaf_rel(one_step(ref_net, w_p, x_p, yb,
                                            False)[3], d_ref)
        with exact_var():
            d_ref_x = one_step(ref_net, w_ref, x_ref, yb, False)[3]
            d_u_x = one_step(net, w0, xb, yb, False)[3]
        errs["exact var"] = leaf_rel(d_u_x, d_ref_x)
    del ref_net
    torch.cuda.empty_cache()
    z_u = train_logits(net, w0, xb, False)
    z_f = train_logits(net, w0, xb, True)
    l_u, _, _, d_u = one_step(net, w0, xb, yb, False)
    l_f, fwd, bwd, d_f = one_step(net, w0, xb, yb, True)
    restore(net, w0)
    e_u, e_f = leaf_rel(d_u, d_ref), leaf_rel(d_f, d_ref)
    errs = {"op-granular": e_u, "fused": e_f,
            "fused vs op-granular": leaf_rel(d_f, d_u), **errs}
    z_errs.update({"op-granular": rel_l2(z_u, z_ref),
                   "fused": rel_l2(z_f, z_ref),
                   "fused vs op-granular": rel_l2(z_f, z_u)})
    e_w = errs.get("witness", {})
    checked = [k for k in d_ref if e_u[k] <= LEAF_POWER]
    # the worst checked leaf, 1 = at its bound
    ratio, bad = leaf_check(e_f, e_u, e_w, checked, bounds)
    z_lim = bounds["rel"] * max(z_errs["op-granular"],
                                z_errs.get("witness", 0.0)) + bounds["abs"]
    dl = abs(l_f - l_u) / max(abs(l_u), 1e-30)
    ref_name = str(ref_dtype).replace("torch.", "")
    bound_txt = (f"{bounds['rel']} x max(op-granular"
                 f"{', witness' if witness else ''}) + {bounds['abs']}")
    print(f"train {tag} batch {xb.shape[0]}: one step, loss fused "
          f"{l_f:.7f} op-granular {l_u:.7f} (rel {dl:.3g}, bound "
          f"{bounds['loss']}) {ref_name} {l_ref:.7f}; launches fwd {fwd} "
          f"bwd {bwd}", flush=True)
    print(f"  train {tag} logits of a training-mode forward, rel L2 to the "
          f"{ref_name} forward: "
          + ", ".join(f"{c} {v:.4g}" for c, v in z_errs.items())
          + f" (fused bound {bound_txt} = {z_lim:.4g})", flush=True)
    print(f"  train {tag} update over all leaves, rel L2 to the {ref_name} "
          f"step: op-granular {rel_l2_all(d_u, d_ref):.4g}, fused "
          f"{rel_l2_all(d_f, d_ref):.4g}; fused vs op-granular "
          f"{rel_l2_all(d_f, d_u):.4g}; {len(checked)} of {len(d_ref)} "
          f"leaves checked (op-granular within {LEAF_POWER}), bound per "
          f"leaf {bound_txt}, worst leaf at {ratio:.3f} of its bound, "
          f"{len(bad)} over it", flush=True)
    print_leaf_table(f"train {tag}", errs, checked)
    unchecked = sorted(set(d_ref) - set(checked))
    print(f"  train {tag}: unchecked leaves by group: "
          + ", ".join(f"{g} {sum(leaf_group(k) == g for k in unchecked)}"
                      for g in LEAF_GROUPS), flush=True)
    for r, k, e, lim in sorted(bad, reverse=True)[:5]:
        print(f"    over: {k} fused {e:.4g} > {lim:.4g}", flush=True)
    if not all(math.isfinite(v) for v in (l_f, l_u, l_ref)):
        fail(f"train {tag}: loss not finite ({l_f}, {l_u}, {l_ref})")
    if dl > bounds["loss"] or not z_errs["fused"] <= z_lim:
        fail(f"train {tag}: fused forward disagrees (loss rel {dl:.3g} > "
             f"{bounds['loss']} or logits rel L2 {z_errs['fused']:.4g} > "
             f"{z_lim:.4g})")
    if bad or "output.weight" not in checked:
        fail(f"train {tag}: fused update off on {len(bad)} of "
             f"{len(checked)} checked leaves (output layer checked: "
             f"{'output.weight' in checked})")
    if (fwd, bwd) != (FWD_PER_STEP, BWD_PER_STEP):
        fail(f"train {tag}: {fwd} forward / {bwd} backward kernel launches "
             f"in one step (want {FWD_PER_STEP} / {BWD_PER_STEP})")
    groups = {c: {g: max([v[k] for k in checked if leaf_group(k) == g],
                         default=None) for g in LEAF_GROUPS}
              for c, v in errs.items()}
    rec = dict(loss_fused=l_f, loss_unfused=l_u, loss_ref=l_ref,
               loss_rel=dl, logits_rel_l2=z_errs, leaves=len(d_ref),
               leaves_checked=len(checked), leaves_over=len(bad),
               worst_leaf_of_bound=ratio,
               update_err_unfused=rel_l2_all(d_u, d_ref),
               update_err_fused=rel_l2_all(d_f, d_ref),
               update_fused_vs_unfused=rel_l2_all(d_f, d_u),
               group_max=groups)
    # what phase 6 holds its data-parallel steps against, on the host
    cpu = lambda d: {k: v.detach().cpu() for k, v in d.items()}
    ref = dict(w0=cpu(w0), x=xb.cpu(), y=yb.cpu(), d_ref=cpu(d_ref),
               e_u=e_u, e_w=e_w, checked=checked, l_u=l_u, l_ref=l_ref,
               bounds=bounds, ref_dtype=ref_name)
    return rec, ref


def phase_train(card):
    """bench.py's configuration through the port's entry points:
    make_mesh(dp=1) + SPMDTrainer(SoftmaxCrossEntropyLoss, sgd lr 0.1,
    momentum 0.9, wd 1e-4) on full-width ResNet-50 v1, bf16, NHWC, 224²,
    batch 256, one fixed synthetic batch."""
    import copy
    import gc

    gc.collect()
    torch.cuda.empty_cache()
    dev = torch.device("cuda", 0)
    gen = torch.Generator().manual_seed(11)
    result = {}
    # fp32 first, at a smaller batch (TF32 is off since phase 1), against
    # float64
    net = build_net("float32", seed=1)
    xb = torch.rand(TRAIN_FP32_BATCH, 224, 224, 3, generator=gen).to(dev)
    yb = torch.randint(0, 1000, (TRAIN_FP32_BATCH,), generator=gen).to(dev)
    warm_running_means(net, xb)
    refs = {}
    result["fp32"], refs["fp32"] = step_agreement(
        net, xb, yb, "fp32", torch.float64, TRAIN_BOUNDS_FP32, witness=True)
    del net, xb, yb
    gc.collect()
    torch.cuda.empty_cache()

    net = build_net("bfloat16", seed=0)
    xb = torch.rand(TRAIN_BATCH, 224, 224, 3, generator=gen).to(
        dev, torch.bfloat16)
    yb = torch.randint(0, 1000, (TRAIN_BATCH,), generator=gen).to(dev)
    warm_running_means(net, xb)
    result["bf16"], refs["bf16"] = step_agreement(
        net, xb, yb, "bf16", torch.float32, TRAIN_BOUNDS_BF16, witness=False)
    gc.collect()
    torch.cuda.empty_cache()
    # the main path: fused with the fused backward, then op-granular, in
    # turns (fused, unfused, unfused, fused), each after one warm-up step;
    # each mode trains its own copy of the net from the same weights
    nets = {True: net, False: copy.deepcopy(net)}
    trainers = {}
    for fused in (True, False):
        set_knobs(fused, fused)
        trainers[fused] = new_trainer(nets[fused])
        counted_steps(trainers[fused], xb, yb, 1)
    runs = {True: [], False: []}
    launches = {"fwd": 0, "bwd": 0}
    for fused in (True, False, False, True):
        set_knobs(fused, fused)
        losses, fwd, bwd, dt = counted_steps(trainers[fused], xb, yb,
                                             TRAIN_STEPS)
        tag = "fused" if fused else "unfused"
        if not all(math.isfinite(v) for v in losses):
            fail(f"train {tag}: loss not finite: {losses}")
        want = (FWD_PER_STEP * TRAIN_STEPS, BWD_PER_STEP * TRAIN_STEPS) \
            if fused else (0, 0)
        if (fwd, bwd) != want:
            fail(f"train {tag}: {fwd} forward / {bwd} backward kernel "
                 f"launches in {TRAIN_STEPS} steps (want {want})")
        if fused:
            launches["fwd"] += fwd
            launches["bwd"] += bwd
        runs[fused].append(dt)
        print(f"train bf16 batch {TRAIN_BATCH} {tag}: {dt * 1e3:.1f} ms/step"
              f", {TRAIN_BATCH / dt:.1f} img/s over {TRAIN_STEPS} steps, "
              f"losses {' '.join(f'{v:.4f}' for v in losses)}, launches "
              f"fwd {fwd} bwd {bwd} [{card}]", flush=True)
    result["ms_per_step"] = {"fused": [t * 1e3 for t in runs[True]],
                             "unfused": [t * 1e3 for t in runs[False]]}
    result["profile"] = {}
    for fused in (True, False):
        set_knobs(fused, fused)
        tag = "fused" if fused else "unfused"
        result["profile"][tag] = profile_device(
            lambda: trainers[fused].step(xb, yb),
            f"train {tag} bf16 batch {TRAIN_BATCH}", "step", card,
            sum(runs[fused]) / len(runs[fused]) * 1e3, iters=2, top=24)
        if fused and result["profile"][tag] is not None:
            print_bwd_shares(f"train fused bf16 batch {TRAIN_BATCH}",
                             bwd_split(result["profile"][tag]["rows"]), card)
    result["launches"] = launches
    result["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f"train peak device memory {result['peak_gib']:.1f} GiB", flush=True)
    return result, refs


# ---------------------------------------------------------------------------
# phase 6: the data-parallel training main path — dp=2 over two ranks
# ---------------------------------------------------------------------------

def phase_kernels_dp():
    """Kernels 1 (with statistics) and 2 at the per-rank shapes of the
    data-parallel step (N = TRAIN_BATCH / DP), with phase 3's checks."""
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(2468)
    n = TRAIN_BATCH // DP
    fwd, bwd = [], []
    print(f"kernels at the per-rank shapes of dp={DP}, N={n} (train_dp):",
          flush=True)
    for (name, hw, ci, co, k, s, p, act_in, count) in resnet50_unit_configs():
        x, w, sc, bi, sh = make_unit_inputs(gen, n, hw, ci, co, k,
                                            torch.bfloat16, dev)
        fwd.append(dict(check_unit(name, x, w, sc, bi, sh, k, s, p, act_in,
                                   True), count=count, path="train_dp"))
        if s == 1:
            bwd.append(dict(check_unit_bwd(name, x, w, sc, bi, sh, k, p,
                                           act_in, True, gen),
                            count=count, path="train_dp"))
        del x, w
    torch.cuda.empty_cache()
    return fwd, bwd


def state_digest(net, trainer):
    """{name: sha256 of the bytes} of every parameter, running statistic
    and momentum tensor: equal digests are bit-identical states."""
    import hashlib

    def digest(t):
        b = t.detach().contiguous().reshape(-1).view(torch.uint8).cpu()
        return hashlib.sha256(b.numpy().tobytes()).hexdigest()[:20]
    out = {k: digest(v) for k, v in sorted(net.collect_params().items())}
    out.update({f"momentum:{k}": digest(st[0])
                for k, st in sorted(trainer.opt_state.items())})
    return out


def dp_rank(rank, out_dir, backend, devices):
    """One rank of phase 6 (a process of its own): join the group from
    the DMLC_* environment, run the checked steps and the timed ones,
    write rank<r>.json (and rank 0 its updates).  Exits non-zero on any
    failure."""
    import gc

    from mxnet_tpu_torch import parallel

    dev = torch.device(devices[rank])
    torch.cuda.set_device(dev)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    parallel.dist.init(backend=backend, timeout=DP_COLLECTIVE_TIMEOUT)
    mesh = parallel.make_mesh(dp=DP, devices=devices)
    mode = (f"{DP} ranks, backend {parallel.dist.backend()}, devices "
            f"{','.join(devices)}")
    print(f"rank {rank}/{parallel.dist.num_workers()} on "
          f"{mesh.local_device} ({mode})", flush=True)
    res = {"rank": rank, "mode": mode, "steps": {}}
    for tag, dtype, seed in (("fp32", "float32", 1), ("bf16", "bfloat16", 0)):
        data = torch.load(os.path.join(out_dir, f"{tag}.pt"))
        net = build_net(dtype, seed, dev)
        xb, yb = data["x"].to(dev), data["y"].to(dev)
        if tag == "bf16":
            torch.cuda.reset_peak_memory_stats(dev)
        for fused in (True, False):
            restore(net, data["w0"])
            set_knobs(fused, fused)
            trainer = new_trainer(net, mesh)
            losses, fwd, bwd, _ = counted_steps(trainer, xb, yb, 1)
            case = f"{tag}.{'fused' if fused else 'unfused'}"
            res["steps"][case] = dict(loss=losses[0], fwd=fwd, bwd=bwd,
                                      digest=state_digest(net, trainer))
            if rank == 0:
                torch.save({k: st[0].detach().cpu()
                            for k, st in trainer.opt_state.items()},
                           os.path.join(out_dir, f"update.{case}.pt"))
            print(f"step {case} global batch {xb.shape[0]} "
                  f"({xb.shape[0] // DP} a rank): loss {losses[0]:.7f}, "
                  f"launches fwd {fwd} bwd {bwd}", flush=True)
            del trainer
        if tag == "fp32":
            del net, data, xb, yb
            gc.collect()
            torch.cuda.empty_cache()
    # timed steps, fused with the fused backward then op-granular, each
    # after one warm-up step, the ranks started together
    trainers, res["timed"] = {}, {}
    for fused in (True, False):
        restore(net, data["w0"])
        set_knobs(fused, fused)
        trainers[fused] = new_trainer(net, mesh)
        counted_steps(trainers[fused], xb, yb, 1)
        parallel.dist.barrier()
        losses, fwd, bwd, dt = counted_steps(trainers[fused], xb, yb,
                                             TRAIN_STEPS)
        tag = "fused" if fused else "unfused"
        res["timed"][tag] = dict(ms=dt * 1e3, losses=losses, fwd=fwd,
                                 bwd=bwd)
        print(f"train_dp bf16 {tag}: {dt * 1e3:.1f} ms/step on this rank, "
              f"{TRAIN_BATCH / dt:.1f} img/s global (batch {TRAIN_BATCH}, "
              f"{TRAIN_BATCH // DP} a rank) over {TRAIN_STEPS} steps, losses "
              f"{' '.join(f'{v:.4f}' for v in losses)}, launches fwd {fwd} "
              f"bwd {bwd} [{mode}]", flush=True)
    res["peak_gib"] = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    # the profile of a fused step on rank 0; rank 1 takes the same steps
    set_knobs(True, True)
    parallel.dist.barrier()
    iters = 2
    step = lambda: trainers[True].step(xb, yb)
    if rank == 0:
        prof = profile_device(step, f"train_dp fused bf16 rank 0 [{mode}]",
                              "step", mode, res["timed"]["fused"]["ms"],
                              iters=iters, top=16,
                              host_prefix="mxnet_tpu_torch.dist.")
        if prof is not None:
            rows = prof.pop("rows")
            prof["kernel1_ms"] = sum(ms for ms, _, k in rows
                                     if any(n in k for n in KERNEL1_NAMES))
            prof["kernel2_ms"] = sum(ms for ms, _, k in rows
                                     if any(n in k for n in KERNEL2_NAMES))
            print_bwd_shares(f"train_dp fused bf16 rank 0 [{mode}]",
                             bwd_split(rows), mode)
            prof["collective_device_ms"] = sum(
                ms for ms, _, k in rows
                if "nccl" in k.lower() or k.startswith("Memcpy"))
            print(f"profile train_dp rank 0: kernel 1 {prof['kernel1_ms']:.3f}"
                  f" ms, kernel 2 {prof['kernel2_ms']:.3f} ms, collectives "
                  f"on the device (NCCL kernels, copies) "
                  f"{prof['collective_device_ms']:.3f} ms, host time in the "
                  f"collective calls {prof.get('host_ms', 0.0):.3f} ms of "
                  f"{res['timed']['fused']['ms']:.3f} ms a step [{mode}]",
                  flush=True)
        res["profile"] = prof
    else:
        for _ in range(iters + 1):
            step()
        torch.cuda.synchronize()
    parallel.dist.barrier()
    parallel.dist.shutdown()
    res["jax_imported"] = sorted(m for m in sys.modules
                                 if m == "jax" or m.startswith("jax.")
                                 or m.split(".")[0] == "mxnet_tpu")
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(res, f)
    print(f"peak device memory {res['peak_gib']:.1f} GiB on this rank; "
          f"JAX modules loaded: {len(res['jax_imported'])}", flush=True)
    return 1 if FAILURES or res["jax_imported"] else 0


def free_port():
    import socket

    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as sk:
        sk.bind(("127.0.0.1", 0))
        return sk.getsockname()[1]


def spawn_ranks(out_dir, backend, devices):
    """Start DP rank processes of this script (spawned, never forked);
    wait for all, killing every rank when one fails or DP_TIMEOUT runs
    out; print their logs.  Returns the list of failures."""
    port = free_port()
    env = dict(os.environ, DMLC_PS_ROOT_URI="127.0.0.1",
               DMLC_PS_ROOT_PORT=str(port), DMLC_NUM_WORKER=str(DP))
    logs = [open(os.path.join(out_dir, f"rank{r}.log"), "w")
            for r in range(DP)]
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--dp-rank", str(r),
         "--dp-dir", out_dir, "--dp-backend", backend, "--dp-devices",
         ",".join(devices)], env=dict(env, DMLC_WORKER_ID=str(r)),
        stdout=logs[r], stderr=subprocess.STDOUT) for r in range(DP)]
    t0 = time.monotonic()
    errors = []
    try:
        while any(p.poll() is None for p in procs):
            if any(p.poll() not in (None, 0) for p in procs):
                break
            if time.monotonic() - t0 > DP_TIMEOUT:
                errors.append(f"ranks still running after {DP_TIMEOUT} s")
                break
            time.sleep(0.5)
    finally:
        for r, p in enumerate(procs):
            if p.poll() is None:
                p.kill()
                errors.append(f"rank {r} killed")
            p.wait()
            logs[r].close()
    for r, p in enumerate(procs):
        if p.returncode != 0:
            errors.append(f"rank {r} exited with {p.returncode}")
        with open(os.path.join(out_dir, f"rank{r}.log")) as f:
            for line in f.read().splitlines()[-400:]:
                print(f"  [rank {r}] {line}", flush=True)
    print(f"dp: ranks done in {time.monotonic() - t0:.1f} s", flush=True)
    return errors


def hold_dp_update(case, d, loss, ref):
    """A data-parallel step's update and loss against phase 5's
    reference for the same weights and batch, by phase 5's rule."""
    bounds = ref["bounds"]
    e = leaf_rel(d, ref["d_ref"])
    worst, bad = leaf_check(e, ref["e_u"], ref["e_w"], ref["checked"],
                            bounds)
    dl = abs(loss - ref["l_u"]) / max(abs(ref["l_u"]), 1e-30)
    print(f"train_dp {case}: loss {loss:.7f} vs phase 5's op-granular "
          f"{ref['l_u']:.7f} (rel {dl:.3g}, bound {bounds['loss']}); update "
          f"over all leaves rel L2 {rel_l2_all(d, ref['d_ref']):.4g} to the "
          f"{ref['ref_dtype']} step; {len(ref['checked'])} leaves checked, "
          f"worst at {worst:.3f} of its bound, {len(bad)} over it",
          flush=True)
    for r, k, ek, lim in sorted(bad, reverse=True)[:5]:
        print(f"    over: {k} {ek:.4g} > {lim:.4g}", flush=True)
    if not math.isfinite(loss) or dl > bounds["loss"] or bad \
            or "output.weight" not in ref["checked"]:
        fail(f"train_dp {case}: loss rel {dl:.3g} (bound {bounds['loss']}),"
             f" {len(bad)} of {len(ref['checked'])} leaves over their bound")
    return dict(loss=loss, loss_rel=dl, worst_leaf_of_bound=worst,
                leaves_over=len(bad),
                update_err=rel_l2_all(d, ref["d_ref"]))


def phase_dp(card, refs):
    """bench.py's step data parallel: DP ranks, each calling
    dist.init() -> make_mesh(dp=DP) -> SPMDTrainer(...).step on the
    global batch, from phase 5's weights and batches.  With fewer than
    DP cards both ranks share cuda:0 over gloo, else rank r runs on
    cuda:r over NCCL."""
    import gc
    import shutil

    out_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "build", "chip_smoke_dp")
    shutil.rmtree(out_dir, ignore_errors=True)
    os.makedirs(out_dir)
    for tag, ref in refs.items():
        torch.save(dict(w0=ref["w0"], x=ref["x"], y=ref["y"]),
                   os.path.join(out_dir, f"{tag}.pt"))
    gc.collect()
    torch.cuda.empty_cache()
    if torch.cuda.device_count() >= DP:
        backend, devices = "nccl", [f"cuda:{r}" for r in range(DP)]
    else:
        backend, devices = "gloo", ["cuda:0"] * DP
    mode = f"{DP} ranks, backend {backend}, devices {','.join(devices)}"
    print(f"train_dp: {mode} [{card}]", flush=True)
    errors = spawn_ranks(out_dir, backend, devices)
    for e in errors:
        fail(f"train_dp: {e}")
    if errors:
        return {"launches": {"fwd": 0, "bwd": 0}, "mode": mode}
    ranks = []
    for r in range(DP):
        with open(os.path.join(out_dir, f"rank{r}.json")) as f:
            ranks.append(json.load(f))
    result = {"mode": mode, "backend": backend, "ranks": DP, "steps": {}}
    for case, step0 in ranks[0]["steps"].items():
        fused = case.endswith(".fused")
        want = (FWD_PER_STEP, BWD_PER_STEP) if fused else (0, 0)
        for r, rk in enumerate(ranks):
            got = (rk["steps"][case]["fwd"], rk["steps"][case]["bwd"])
            if got != want:
                fail(f"train_dp {case}: rank {r} launched {got} kernels "
                     f"(want {want} per step)")
        differ = sorted(k for k, v in step0["digest"].items()
                        if any(rk["steps"][case]["digest"][k] != v
                               for rk in ranks[1:]))
        print(f"train_dp {case}: ranks bit-identical after the step on "
              f"{len(step0['digest']) - len(differ)} of "
              f"{len(step0['digest'])} tensors (parameters, running "
              f"statistics, momentum)", flush=True)
        if differ or any(rk["steps"][case]["loss"] != step0["loss"]
                         for rk in ranks[1:]):
            fail(f"train_dp {case}: ranks differ on {len(differ)} tensors "
                 f"(first: {differ[:3]}) or in the loss")
        d = torch.load(os.path.join(out_dir, f"update.{case}.pt"))
        result["steps"][case] = hold_dp_update(case, d, step0["loss"],
                                               refs[case.split(".")[0]])
    for rk in ranks:
        if rk["jax_imported"]:
            fail(f"train_dp: rank {rk['rank']} loaded {rk['jax_imported']}")
    timed = ranks[0]["timed"]
    want = (FWD_PER_STEP * TRAIN_STEPS, BWD_PER_STEP * TRAIN_STEPS)
    for r, rk in enumerate(ranks):
        got = (rk["timed"]["fused"]["fwd"], rk["timed"]["fused"]["bwd"])
        if got != want:
            fail(f"train_dp timed fused: rank {r} launched {got} (want "
                 f"{want})")
    result["ms_per_step"] = {t: [rk["timed"][t]["ms"] for rk in ranks]
                             for t in ("fused", "unfused")}
    result["peak_gib"] = [rk["peak_gib"] for rk in ranks]
    result["profile"] = ranks[0].get("profile")
    result["launches"] = {"fwd": timed["fused"]["fwd"],
                          "bwd": timed["fused"]["bwd"]}
    print(f"train_dp: ms/step per rank fused {result['ms_per_step']['fused']}"
          f", op-granular {result['ms_per_step']['unfused']}; peak GiB per "
          f"rank {[round(g, 2) for g in result['peak_gib']]} [{mode}] "
          f"[{card}]", flush=True)
    return result


# ---------------------------------------------------------------------------
# phase 7: the probe path (row 6) — kernel 6 and the probe's entry point
# ---------------------------------------------------------------------------

def check_tap(name, x, w_taps, sc, bi, sh, k, s, p, act_in, want_stats, nbs):
    """Kernel 6 against its plain version on one configuration, once for
    each batch tile in `nbs`, by phase 3's tolerances; one record each."""
    from mxnet_tpu_torch.ops import convbn_tap as ct
    from mxnet_tpu_torch.tools.convbn_probe import unit_bound

    kernel, stride, pad = (k, k), (s, s), (p, p)
    args = (x, w_taps, sc, bi, sh)
    kw = dict(kernel=kernel, stride=stride, pad=pad, act_in=act_in,
              want_stats=want_stats)
    w = w_taps.permute(3, 2, 0, 1)
    u = (x.float() * sc + bi).clamp_min(0).to(x.dtype) if act_in else x
    u_nchw = u.permute(0, 3, 1, 2)
    library_ms = time_ms(lambda: F.conv2d(u_nchw, w, stride=stride,
                                          padding=pad))
    bound = unit_bound(x.shape, w_taps.shape[-1], kernel, stride, pad,
                       x.dtype, want_stats)
    recs = []
    for nb in nbs:
        got = ct.candidate_tap(*args, nb=nb, **kw)
        torch.cuda.synchronize()
        ref = ct.candidate_tap_ref(*args, kernel, stride, pad, act_in,
                                   want_stats, nb)
        if got[1].shape != (1, w_taps.shape[-1]):
            fail(f"{name} nb={nb}: s1 shape {tuple(got[1].shape)}")
        ok, max_abs, ytol = hold_unit(
            f"{name} nb={nb}", x, w, sc, bi, k, s, p, act_in, want_stats,
            (got[0], got[1].reshape(-1), got[2].reshape(-1)),
            (ref[0], ref[1].reshape(-1), ref[2].reshape(-1)))
        del got, ref
        kernel_ms = time_ms(lambda: ct.candidate_tap(*args, nb=nb, **kw))
        ref_ms = time_ms(lambda: ct.candidate_tap_ref(
            *args, kernel, stride, pad, act_in, want_stats, nb), iters=3,
            warmup=1)
        rec = dict(name=name, nb=nb, dtype=str(x.dtype).replace("torch.", ""),
                   shape=list(x.shape), co=w_taps.shape[-1], k=k, s=s, p=p,
                   act_in=act_in, want_stats=want_stats, ok=ok,
                   max_abs_err=max_abs, kernel_ms=kernel_ms, ref_ms=ref_ms,
                   library_ms=library_ms, **bound)
        recs.append(rec)
        print(f"  tap {name:<16} nb={nb:<3} {rec['dtype']:<8} x{rec['shape']}"
              f" co={rec['co']} k{k}s{s}p{p} act={int(act_in)} "
              f"stats={int(want_stats)} | kernel_ms={kernel_ms:.4f} "
              f"ref_ms={ref_ms:.4f} library_ms={library_ms:.4f} bound_ms="
              f"{bound['bound_ms']:.4f} ({bound['bound_by']}) | {ytol} | "
              f"{'ok' if ok else 'FAIL'}", flush=True)
    return recs


def phase_kernels_tap():
    """Kernel 6 against its plain version: (a) the probe's four cases
    (N=4, nb=2, bf16, the probe's own inputs), an fp32 case, a
    want_stats-off and an act_in-off case, a 3x3 stride-2 case at nb 1
    and 4, and an indivisible batch that must raise; (b) the nine
    batch-256 layers of the probe's time mode at each nb of its TAP_NB."""
    import numpy as np

    from mxnet_tpu_torch.base import MXNetError
    from mxnet_tpu_torch.ops import convbn_tap as ct
    from mxnet_tpu_torch.tools import convbn_probe as probe

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(1357)
    recs = []
    print("kernel 6 (candidate_tap) vs plain version, probe cases and "
          "extras:", flush=True)
    rng = np.random.RandomState(0)
    for i, (shape, co, kernel, stride, pad) in enumerate(probe.CASES):
        inputs = probe.case_inputs(rng, shape, co, kernel, dev)
        recs += [dict(r, path="extra") for r in check_tap(
            f"probe.case{i}", *inputs, kernel[0], stride[0], pad[0], True,
            True, (probe.CHECK_NB,))]
    extra = [  # name, N, hw, Ci, Co, k, s, p, act_in, stats, dtype, nbs
        ("fp32.28.3x3", 8, 28, 128, 128, 3, 1, 1, True, True,
         torch.float32, (2,)),
        ("nostats.14.1x1", 8, 14, 256, 1024, 1, 1, 0, True, False,
         torch.bfloat16, (4,)),
        ("noact.56.1x1s2", 8, 56, 64, 256, 1, 2, 0, False, True,
         torch.bfloat16, (2,)),
        ("bf16.56.3x3s2", 8, 56, 64, 128, 3, 2, 1, True, True,
         torch.bfloat16, (1, 4))]
    for name, n, hw, ci, co, k, s, p, act_in, stats, dt, nbs in extra:
        x, w, sc, bi, sh = make_unit_inputs(gen, n, hw, ci, co, k, dt, dev)
        recs += [dict(r, path="extra") for r in check_tap(
            name, x, ct.weight_taps(w), sc, bi, sh, k, s, p, act_in, stats,
            nbs)]
    x, w, sc, bi, sh = make_unit_inputs(gen, 6, 14, 64, 64, 1,
                                        torch.bfloat16, dev)
    before = ct.launch_count()
    try:
        ct.candidate_tap(x, ct.weight_taps(w), sc, bi, sh, kernel=(1, 1),
                         stride=(1, 1), pad=(0, 0), act_in=True,
                         want_stats=True, nb=4)
        fail("tap: N=6, nb=4 did not raise")
    except MXNetError as e:
        print(f"  tap N=6 nb=4 raises: {e}", flush=True)
    if ct.launch_count() != before:
        fail("tap: the refused call launched the kernel")
    print(f"kernel 6 vs plain version at the probe's batch-{TRAIN_BATCH} "
          f"layers, nb in {probe.TAP_NB}:", flush=True)
    for shape, co, kernel, stride, pad in probe.LAYERS:
        n, hw, _, ci = shape
        x, w, sc, bi, sh = make_unit_inputs(gen, n, hw, ci, co, kernel[0],
                                            torch.bfloat16, dev)
        recs += [dict(r, path="probe", count=1) for r in check_tap(
            f"{hw}x{hw}.{ci}-{co}", x, ct.weight_taps(w), sc, bi, sh,
            kernel[0], stride[0], pad[0], True, True, probe.TAP_NB)]
        del x, w
        torch.cuda.empty_cache()
    return recs


def profile_probe_layers(card):
    """Device time of kernel 1 and of kernel 6 at each nb over one sweep
    of the nine layers, split into the conv kernel and its statistics
    reduction(s) (torch.profiler)."""
    from mxnet_tpu_torch.ops import convbn_tap as ct
    from mxnet_tpu_torch.ops import fused_convbn as fcb
    from mxnet_tpu_torch.tools import convbn_probe as probe

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(97)
    layers = []
    for shape, co, kernel, stride, pad in probe.LAYERS:
        x, w, sc, bi, sh = probe.layer_inputs(gen, shape, co, kernel)
        layers.append((x, w, ct.weight_taps(w), sc, bi, sh,
                       dict(kernel=kernel, stride=stride, pad=pad,
                            act_in=True, want_stats=True)))
    out = {}
    runs = [("kernel 1", KERNEL1_NAMES, lambda L: fcb.fused_conv_unit(
        L[0], L[1], *L[3:6], **L[6]))]
    runs += [(f"kernel 6 nb={nb}", KERNEL6_NAMES,
              lambda L, nb=nb: ct.candidate_tap(L[0], *L[2:6], nb=nb, **L[6]))
             for nb in probe.TAP_NB]
    for tag, names, call in runs:
        def sweep():
            for L in layers:
                call(L)
        wall = time_ms(sweep, iters=2, warmup=1)
        prof = profile_device(sweep, f"probe layers, {tag}", "sweep", card,
                              wall, iters=2, top=4)
        if prof is None:
            continue
        conv = sum(ms for ms, _, k in prof["rows"] if names[0] in k)
        stats = sum(ms for ms, _, k in prof["rows"]
                    if any(n in k for n in names[1:]))
        out[tag] = dict(wall_ms=wall, conv_ms=conv, stats_ms=stats)
        print(f"profile probe layers, {tag}: conv kernel {conv:.3f} ms, "
              f"statistics reduction {stats:.3f} ms a sweep of nine layers "
              f"[{card}]", flush=True)
    # kernel 1's split per layer: its conv kernel against its statistics
    # reduction (torch.profiler, over 3 calls of each layer), and, by CUDA
    # events, the launch step with statistics against the same without
    # (the epilogue's column sums plus the reduction)
    out["kernel 1 by layer"] = {}
    for (shape, co, kernel, stride, pad), L in zip(probe.LAYERS, layers):
        name = f"{shape[1]}x{shape[2]}.{shape[3]}-{co}.k{kernel[0]}"
        w_ohwi = fcb.weight_ohwi(L[1])
        ms = {st: graph_ms(lambda st=st: fcb._launch(
            L[0], w_ohwi, *L[3:6], kernel, stride, pad, True, st))
            for st in (True, False)}
        with contextlib.redirect_stdout(None):
            prof = profile_device(lambda: runs[0][2](L), name, "call", card,
                                  1.0, iters=3, top=0)
        conv = stats = None
        if prof is not None:
            conv = sum(t for t, _, k in prof["rows"] if KERNEL1_NAMES[0] in k)
            stats = sum(t for t, _, k in prof["rows"]
                        if KERNEL1_NAMES[1] in k)
        out["kernel 1 by layer"][name] = dict(
            conv_ms=conv, stats_ms=stats, with_stats_ms=ms[True],
            without_stats_ms=ms[False])
        split = "not measured" if conv is None else (
            f"conv {conv:.4f} ms, statistics reduction {stats:.4f} ms "
            f"({stats / max(conv + stats, 1e-9):.1%})")
        print(f"probe layer {name}, kernel 1: profiler {split}; CUDA events "
              f"{ms[True]:.4f} ms with statistics, {ms[False]:.4f} without "
              f"({(ms[True] - ms[False]) / ms[True]:.1%} for statistics) a "
              f"call [{card}]", flush=True)
    return out


def phase_probe(card):
    """The probe path: the probe's check mode and time mode through its
    main(argv) on cuda:0, with the launch counters of kernels 1 and 6 set
    to 0 just before and read just after."""
    from mxnet_tpu_torch.ops import convbn_tap as ct
    from mxnet_tpu_torch.ops import fused_convbn as fcb
    from mxnet_tpu_torch.tools import convbn_probe as probe

    calls, rcs = {}, {}
    per_call = probe.WARMUP + probe.ITERS
    want = {"check": {"candidate_tap": len(probe.CASES)},
            "time": {"candidate_tap": len(probe.LAYERS) * len(probe.TAP_NB)
                     * per_call,
                     "fused_conv_unit": len(probe.LAYERS) * per_call}}
    print(f"probe: python -m mxnet_tpu_torch.tools.convbn_probe [--time] "
          f"--device cuda:0 [{card}]", flush=True)
    t0 = time.perf_counter()
    ct.reset_launch_count()
    fcb.reset_launch_count()
    try:
        for mode, argv in (("check", ["--device", "cuda:0"]),
                           ("time", ["--time", "--device", "cuda:0"])):
            report = {}
            rcs[mode] = probe.main(argv, report)
            calls[mode] = report["calls"]
            if mode == "check":
                check_launches = ct.launch_count()
    except Exception as e:  # noqa: BLE001 — the phase fails, the run goes on
        fail(f"probe: {type(e).__name__}: {e}")
        return {"launches": {"tap": 0, "fused": 0}}
    launches = {"tap": ct.launch_count(), "fused": fcb.launch_count()}
    dt = time.perf_counter() - t0
    print(f"probe: rc check {rcs['check']} time {rcs['time']}; calls "
          f"{calls}; launches kernel 6 {launches['tap']} (check "
          f"{check_launches}), kernel 1 {launches['fused']}; {dt:.1f} s",
          flush=True)
    if rcs != {"check": 0, "time": 0}:
        fail(f"probe: main returned {rcs}")
    if calls != want:
        fail(f"probe: calls {calls} != {want}")
    if check_launches != calls["check"].get("candidate_tap") \
            or launches["tap"] != sum(c.get("candidate_tap", 0)
                                      for c in calls.values()) \
            or launches["fused"] != calls["time"].get("fused_conv_unit"):
        fail(f"probe: launches {launches} (check {check_launches}) do not "
             f"match the calls {calls}")
    records = report["records"]
    print(f"probe per-layer, batch {TRAIN_BATCH}, bf16 [{card}]:", flush=True)
    print(f"  {'layer':<20} {'fused/lib':>9} {'fused/bnd':>9} "
          f"{'tap1/tap256':>11} {'tap16/fused':>11} {'comp/lib':>8}",
          flush=True)
    for r in records:
        print(f"  {r['layer']:<20} {r['fused_ms'] / r['library_ms']:9.2f} "
              f"{r['fused_ms'] / r['bound_ms']:9.2f} "
              f"{r['tap_ms'][1] / r['tap_ms'][256]:11.2f} "
              f"{r['tap_ms'][16] / r['fused_ms']:11.2f} "
              f"{r['composed_ms'] / r['library_ms']:8.2f}", flush=True)
    return {"launches": launches, "calls": calls, "records": records,
            "seconds": dt}


def tap_summary(recs, launches):
    """The `kernels` record of kernel 6 on the probe path: times and
    bounds summed over the 27 configurations of one time sweep of the
    probe (nine layers x TAP_NB), from phase 7's checks at those shapes;
    `ms_by_nb` splits the kernel's time by batch tile."""
    rec = kernel_summary(KERNEL_TAP, recs, "probe", launches)
    rec["ms_by_nb"] = {}
    for r in recs:
        if r["path"] == "probe":
            rec["ms_by_nb"][r["nb"]] = rec["ms_by_nb"].get(r["nb"], 0.0) \
                + r["kernel_ms"]
    return rec


def attention_summary(recs, launches):
    """The `kernels` record of the attention kernel on the BERT serving
    path: times and bound of the packed check at the path's shapes, summed
    over the BERT_LAYERS launches of one served batch of BATCH."""
    r = recs["bert.packed"]
    return dict(KERNEL_ATT, path="serve_bert", batch=BATCH,
                launches=launches, max_abs_err=r["max_abs_err"],
                ms=r["kernel_ms"] * BERT_LAYERS,
                op_ms=r["op_ms"] * BERT_LAYERS,
                plain_ms=r["ref_ms"] * BERT_LAYERS,
                bound_ms=r["bound_ms"] * BERT_LAYERS, bound_by=r["bound_by"],
                library_ms=r["library_ms"] * BERT_LAYERS)


def main():
    if "--dp-rank" in sys.argv:
        import argparse

        ap = argparse.ArgumentParser()
        ap.add_argument("--dp-rank", type=int, required=True)
        ap.add_argument("--dp-dir", required=True)
        ap.add_argument("--dp-backend", required=True)
        ap.add_argument("--dp-devices", required=True)
        a = ap.parse_args()
        return dp_rank(a.dp_rank, a.dp_dir, a.dp_backend,
                       a.dp_devices.split(","))
    card = phase_device()
    phase_build()
    recs = phase_kernels()
    recs_bwd = phase_kernels_bwd(card)
    recs_att = phase_kernels_attention(card)
    main_res = phase_main(card, REQUESTS, THREADS)
    bert_res = phase_bert(card, REQUESTS, THREADS)
    train_res, train_refs = phase_train(card)
    recs_dp, recs_bwd_dp = phase_kernels_dp()
    dp_res = phase_dp(card, train_refs)
    recs_tap = phase_kernels_tap()
    probe_res = phase_probe(card)
    profile_probe_layers(card)
    dp_keys = dict(backend=dp_res.get("backend"), ranks=DP)
    # kernel 1 once for each main path (its shapes and launches), kernel 2
    # for each training path
    summaries = [
        kernel_summary(KERNEL, recs, "serve", main_res.get("launches", 0)),
        kernel_summary(dict(KERNEL, name="fused_conv_unit/train"), recs,
                       "train", train_res["launches"]["fwd"]),
        kernel_summary(KERNEL_BWD, recs_bwd, "train",
                       train_res["launches"]["bwd"]),
        attention_summary(recs_att, bert_res.get("launches", 0)),
        dict(kernel_summary(KERNEL_DP, recs_dp, "train_dp",
                            dp_res["launches"]["fwd"]), **dp_keys),
        dict(kernel_summary(KERNEL_BWD_DP, recs_bwd_dp, "train_dp",
                            dp_res["launches"]["bwd"]), **dp_keys),
        tap_summary(recs_tap, probe_res["launches"]["tap"])]
    if FAILURES:
        print(f"chip_smoke: {len(FAILURES)} failure(s)", flush=True)
        return 1
    print(f"card: {card}", flush=True)
    print(json.dumps({"kernels": summaries}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
