"""The host-side plan of the attention kernel (kernel 5): which shapes
take one pass over the keys and which two, its work at BERT-base, the
head widths it takes, and its source, a wgmma kernel with P kept in
registers.  All on the CPU: nothing here builds or launches a kernel."""
import ast
import re
import subprocess
import sys
from fractions import Fraction

import numpy as np
import pytest
import torch

from mxnet_tpu_torch import _kernels
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.ops import attention as att

SRC = _kernels._SRC_DIR
BF16, FP32 = torch.bfloat16, torch.float32


@pytest.mark.parametrize("sk,passes", [
    (1, 1), (72, 1), (77, 1), (128, 1), (129, 2), (200, 2), (512, 2)])
def test_bf16_takes_one_pass_while_one_key_tile_holds_every_key(sk, passes):
    plan = att.launch_plan(2, 12, 128, sk, 64, BF16)
    assert plan.passes == passes
    assert plan.tile == 128


@pytest.mark.parametrize("sk", [1, 128, 200])
def test_fp32_always_takes_two_passes(sk):
    plan = att.launch_plan(2, 12, 128, sk, 64, FP32)
    assert (plan.passes, plan.tile) == (2, 64)


def test_work_units_at_bert_base():
    # B*H = 32*12 units of 128 query rows: K and V cross from device
    # memory once per (b, h)
    plan = att.launch_plan(32, 12, 128, 128, 64, BF16)
    assert plan == att.AttentionPlan(tile=128, passes=1, head_cols=64,
                                     units=384)
    # S = 200 takes two query tiles per (b, h)
    assert att.launch_plan(2, 1, 200, 200, 64, BF16).units == 4
    assert att.launch_plan(2, 1, 200, 200, 64, FP32).units == 8


@pytest.mark.parametrize("d,cols", [(8, 64), (64, 64), (72, 128),
                                    (128, 128)])
def test_head_dims_the_kernel_takes(d, cols):
    q = torch.zeros(2, 3, 40, d, dtype=BF16)
    k = torch.zeros(2, 3, 72, d, dtype=BF16)
    att.check_kernel_args(q, k, k, torch.ones(2, 72, dtype=BF16))
    assert att.launch_plan(2, 3, 40, 72, d, BF16).head_cols == cols


@pytest.mark.parametrize("d", [136, 12, 4])
def test_head_dims_the_kernel_refuses(d):
    q = torch.zeros(2, 3, 40, d, dtype=BF16)
    with pytest.raises(MXNetError, match="head dim"):
        att.check_kernel_args(q, q, q, None)


def test_grid_too_large_is_refused():
    # expanded views: shapes only, no memory
    q = torch.zeros(1, 1, 1, 8, dtype=BF16).expand(2 ** 20, 2 ** 11, 128, 8)
    assert att.launch_plan(2 ** 20, 2 ** 11, 128, 128, 8, BF16).units \
        == 2 ** 31
    with pytest.raises(MXNetError, match="grid too large"):
        att.check_kernel_args(q, q, q, None)


def test_zero_strides_are_not_aligned_for_tma():
    base = torch.zeros(1, 1, 16, 64, dtype=BF16)
    assert att._aligned(torch.zeros(2, 3, 16, 64, dtype=BF16))
    assert not att._aligned(base.expand(2, 3, 16, 64))  # stride 0, n > 1
    assert att._aligned(base)  # n == 1: its stride is never used


def _constant(text, name):
    m = re.search(rf"constexpr int {name} = (\d+);", text)
    return int(m.group(1))


def test_plan_matches_the_kernel_source():
    src = (SRC / "attention.cu").read_text()
    assert _constant(src, "W_BQ") == _constant(src, "W_KT") \
        == att._TILE[BF16] == 128
    assert _constant(src, "F_BQ") == _constant(src, "F_BKV") \
        == att._TILE[FP32] == 64
    assert "p.one_pass && Sk > W_KT" in src


def test_kernel_source_is_the_hopper_design():
    src = (SRC / "attention.cu").read_text()
    assert "nvcuda::wmma" not in src and "<mma.h>" not in src
    for piece in ("wgmma_ss(sacc", "wgmma_rs<1>(oacc, pf[t]", "tma_load_4d",
                  "encode_4d_b128", "cvt.rn.bf16x2.f32", "__frcp_rn",
                  "__fmaf_rn(__fmaf_rn(-q, l, p), r, q)",
                  "__grid_constant__ CUtensorMap"):
        assert piece in src, piece
    # P goes from the score accumulators into A fragments, never to shared
    # memory: the bf16 kernel stages nothing but its output tile
    body = src[src.index("attention_wgmma_kernel("):
               src.index("bool encode_qkv(")]
    assert "Ps" not in body and "Ss" not in body
    header = (SRC / "conv_mainloop.cuh").read_text()
    assert "cp.async.bulk.tensor.4d" in header


def _imports(path):
    tree = ast.parse(path.read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module)
    return names


def test_the_port_modules_import_no_jax():
    pkg = SRC.parent
    for rel in ("ops/attention.py", "ops/convbn_tap.py", "_kernels.py",
                "ops/optimizer_ops.py", "optimizer/optimizer.py",
                "parallel/spmd.py", "gluon/model_zoo/transformer.py",
                "examples/bench_steps.py", "optimizer/fused.py",
                "optimizer/__init__.py", "gluon/block.py",
                "gluon/trainer.py", "random.py", "util/env.py",
                "parallel/sharding.py", "ops/nn.py", "ops/fused_convbn.py",
                "examples/mnist.py", "contrib/deploy.py", "_graphs.py",
                "ops/contrib.py", "gluon/model_zoo/detection.py",
                "gluon/model_zoo/vision/mobilenet.py",
                "examples/ssd_train.py", "ops/registry.py",
                "ndarray/register.py", "symbol/__init__.py",
                "symbol/symbol.py", "symbol/executor.py",
                "module/__init__.py", "module/base_module.py",
                "module/executor_group.py", "module/module.py",
                "io/__init__.py", "io/io.py", "lr_scheduler.py",
                "initializer.py", "callback.py", "model.py", "name.py",
                "attribute.py", "gluon/parameter.py", "gluon/loss.py",
                "gluon/nn/basic_layers.py", "gluon/nn/conv_layers.py",
                "gluon/contrib/__init__.py", "gluon/contrib/nn.py",
                "gluon/contrib/estimator.py", "ops/tensor.py",
                "ops/__init__.py", "gluon/model_zoo/bert.py",
                "gluon/model_zoo/vision/resnet.py", "ops/random_ops.py",
                "ndarray/random.py", "ndarray/__init__.py",
                "ndarray/ndarray.py", "autograd.py", "tools/op_sweep.py",
                "ops/rnn.py", "gluon/rnn/__init__.py",
                "gluon/rnn/rnn_cell.py", "gluon/rnn/rnn_layer.py",
                "rnn/__init__.py", "rnn/rnn_cell.py", "rnn/io.py",
                "module/bucketing_module.py", "contrib/__init__.py",
                "contrib/amp.py", "examples/rnn_bucketing.py",
                "context.py", "engine.py", "resource.py", "ops/linalg.py",
                "ndarray/sparse.py", "kvstore.py", "serialization.py",
                "gluon/model_zoo/vision/__init__.py",
                "gluon/model_zoo/vision/alexnet.py",
                "gluon/model_zoo/vision/vgg.py",
                "gluon/model_zoo/vision/squeezenet.py",
                "gluon/model_zoo/vision/densenet.py",
                "gluon/model_zoo/vision/inception.py",
                "parallel/checkpoint.py", "parallel/dist.py",
                "gluon/data/dataloader.py", "gluon/data/vision/transforms.py",
                "gluon/data/vision/datasets.py", "gluon/data/dataset.py",
                "lib.py", "recordio.py", "image/__init__.py",
                "ops/image_ops.py", "ndarray/image.py", "tools/im2rec.py",
                "tools/bench_pipeline.py", "examples/imagenet_train.py"):
        for name in _imports(pkg / rel):
            assert not name.startswith(("jax", "mxnet_tpu.")) \
                and name != "mxnet_tpu", (rel, name)
    for path in SRC.iterdir():
        assert "jax" not in path.read_text().lower(), path.name
    code = ("import sys; import mxnet_tpu_torch.ops.attention, "
            "mxnet_tpu_torch.ops.convbn_tap, "
            "mxnet_tpu_torch.optimizer.fused, mxnet_tpu_torch._graphs, "
            "mxnet_tpu_torch.gluon.model_zoo.transformer, "
            "mxnet_tpu_torch.examples.bench_steps, "
            "mxnet_tpu_torch.ops.contrib, "
            "mxnet_tpu_torch.gluon.model_zoo.detection, "
            "mxnet_tpu_torch.examples.ssd_train, "
            "mxnet_tpu_torch.symbol, mxnet_tpu_torch.module, "
            "mxnet_tpu_torch.io, mxnet_tpu_torch.lr_scheduler, "
            "mxnet_tpu_torch.callback, mxnet_tpu_torch.model, "
            "mxnet_tpu_torch.gluon.contrib.estimator, "
            "mxnet_tpu_torch.gluon.contrib.nn, mxnet_tpu_torch.gluon.loss, "
            "mxnet_tpu_torch.ops.random_ops, mxnet_tpu_torch.ndarray.random, "
            "mxnet_tpu_torch.tools.op_sweep, mxnet_tpu_torch.ops.rnn, "
            "mxnet_tpu_torch.gluon.rnn, mxnet_tpu_torch.rnn, "
            "mxnet_tpu_torch.module.bucketing_module, "
            "mxnet_tpu_torch.contrib.amp, "
            "mxnet_tpu_torch.examples.rnn_bucketing, "
            "mxnet_tpu_torch.context, mxnet_tpu_torch.engine, "
            "mxnet_tpu_torch.resource, mxnet_tpu_torch.ops.linalg, "
            "mxnet_tpu_torch.ndarray.sparse, mxnet_tpu_torch.kvstore, "
            "mxnet_tpu_torch.serialization, mxnet_tpu_torch.util.env, "
            "mxnet_tpu_torch.gluon.model_zoo.vision, "
            "mxnet_tpu_torch.parallel.checkpoint, "
            "mxnet_tpu_torch.gluon.data.vision.transforms, "
            "mxnet_tpu_torch.lib, mxnet_tpu_torch.recordio, "
            "mxnet_tpu_torch.image, mxnet_tpu_torch.ops.image_ops, "
            "mxnet_tpu_torch.ndarray.image, mxnet_tpu_torch.tools.im2rec, "
            "mxnet_tpu_torch.tools.bench_pipeline, "
            "mxnet_tpu_torch.examples.imagenet_train; "
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith(('jax.', 'mxnet_tpu.')) or m == 'mxnet_tpu']; "
            "print(bad); sys.exit(1 if bad else 0)")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=str(pkg.parent), timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


def _round32(x):
    """The float32 nearest to the exact rational x (ties to even), for x
    whose float32 is normal."""
    if x == 0:
        return Fraction(0)
    sign, x = (-1, -x) if x < 0 else (1, x)
    e = x.numerator.bit_length() - x.denominator.bit_length()
    while x >= Fraction(2) ** (e + 1):
        e += 1
    while x < Fraction(2) ** e:
        e -= 1
    unit = Fraction(2) ** (e - 23)
    n, rest = divmod(x, unit)
    if rest > unit / 2 or (rest == unit / 2 and n % 2):
        n += 1
    return sign * n * unit


def test_row_reciprocal_division_is_correctly_rounded():
    """The bf16 kernel divides e by the row sum l as q = RN(e·r) with
    r = RN(1/l) (``__frcp_rn``), then q' = RN(q + RN(e − q·l)·r) (two
    FMAs): the correctly rounded quotient that ``__fdiv_rn`` gives, held
    here exactly in rational arithmetic where the quotient and the
    residual are normal, over the kernel's range (e in (0, 1], l in
    [1, 128], significands of all ones among them)."""
    rng = np.random.RandomState(8)
    ls = np.concatenate([rng.uniform(1, 128, 300),
                         np.nextafter(2.0 ** np.arange(1, 8), 0)])
    es = np.concatenate([rng.uniform(1e-28, 1, 150),
                         np.exp(rng.uniform(-60, 0, 150))])
    for l32, e32 in zip(ls.astype(np.float32),
                        np.resize(es, ls.size).astype(np.float32)):
        l, e = Fraction(float(l32)), Fraction(float(e32))
        r = _round32(1 / l)
        q = _round32(e * r)
        q = _round32(_round32(e - q * l) * r + q)
        assert q == _round32(e / l), (float(e32), float(l32))
