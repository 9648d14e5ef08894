"""The host-side plan of the fused Conv+BN kernel (kernel 1): its weight
layout against the JAX package's ``_weight_taps``, its tile choice at the
shapes of ResNet-50 v1 and the probe, its statistics scratch, the shapes
it refuses, and the build hash that covers the headers.  All on the CPU:
nothing here builds or launches a kernel."""
import math
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mxnet_tpu.ops import pallas_convbn as pcb
from mxnet_tpu_torch import _kernels
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.ops import fused_convbn as fcb
from mxnet_tpu_torch.tools import convbn_probe as probe


def resnet50_units(n):
    """(x shape, Co, kernel, stride, pad) of the 20 distinct fused units of
    ResNet-50 v1 at 224x224 and batch n."""
    units = []
    in_c, hw = 64, 56
    for stage, c in enumerate([256, 512, 1024, 2048], 1):
        s = 1 if stage == 1 else 2
        ho = (hw - 1) // s + 1
        mid = c // 4
        units += [((n, hw, hw, in_c), mid, (1, 1), (s, s), (0, 0)),
                  ((n, hw, hw, in_c), c, (1, 1), (s, s), (0, 0)),
                  ((n, ho, ho, mid), mid, (3, 3), (1, 1), (1, 1)),
                  ((n, ho, ho, mid), c, (1, 1), (1, 1), (0, 0)),
                  ((n, ho, ho, c), mid, (1, 1), (1, 1), (0, 0))]
        in_c, hw = c, ho
    return units


def _blocks(shape, co, kernel, stride, pad, tile):
    n, h, w, _ = shape
    ho, wo = fcb._out_hw(h, w, kernel, stride, pad)
    return math.ceil(n * ho * wo / tile[0]) * math.ceil(co / tile[1])


@pytest.mark.parametrize("k", [1, 3])
def test_weight_ohwi_is_the_jax_weight_taps_transposed(k):
    w = np.random.RandomState(k).randn(24, 16, k, k).astype(np.float32)
    got = fcb.weight_ohwi(torch.from_numpy(w))
    want = np.transpose(np.asarray(pcb._weight_taps(jnp.asarray(w))),
                        (3, 0, 1, 2))
    assert got.is_contiguous()
    np.testing.assert_array_equal(got.numpy(), want)


def test_weight_ohwi_of_a_1x1_conv_is_a_view():
    w = torch.randn(64, 32, 1, 1)
    assert fcb.weight_ohwi(w).data_ptr() == w.data_ptr()


@pytest.mark.parametrize("where", ["resnet50_n256", "probe"])
def test_tile_gives_two_blocks_a_sm(where):
    units = resnet50_units(256) if where == "resnet50_n256" else probe.LAYERS
    assert len(units) == (20 if where == "resnet50_n256" else 9)
    for shape, co, kernel, stride, pad in units:
        bm, bn, _ = fcb.launch_plan(shape, co, kernel, stride, pad,
                                    torch.bfloat16)
        assert (bm, bn) in fcb.TILES_BF16
        assert _blocks(shape, co, kernel, stride, pad, (bm, bn)) \
            >= fcb.MIN_BLOCKS == 2 * 132, (shape, co, kernel)


def test_tile_falls_back_to_the_small_tile():
    big, small = fcb.TILES_BF16
    for shape, co, kernel, stride, pad in resnet50_units(32):
        tile = fcb.launch_plan(shape, co, kernel, stride, pad,
                               torch.bfloat16)[:2]
        enough = _blocks(shape, co, kernel, stride, pad, big) \
            >= fcb.MIN_BLOCKS
        assert tile == (big if co >= 128 and enough else small)
        # the small tile never gives fewer blocks than the big one
        assert _blocks(shape, co, kernel, stride, pad, small) \
            >= _blocks(shape, co, kernel, stride, pad, big)
    # Co below 128 always takes the small tile, however large M
    assert fcb.tile_for(10 ** 7, 64, torch.bfloat16) == small


def test_fp32_has_one_tile():
    assert fcb.tile_for(10 ** 6, 2048, torch.float32) == fcb.TILE_FP32


@pytest.mark.parametrize("tiles,rows", [
    (1, 1), (128, 128), (129, 129 + 2), (6272, 6272 + 49),
    (20000, 20000 + 157 + 2)])
def test_scratch_rows_holds_every_reduction_pass(tiles, rows):
    assert fcb.scratch_rows(tiles) == rows


@pytest.mark.parametrize("ci", [12, 36, 3])
def test_bf16_plan_refuses_ci_not_a_multiple_of_8(ci):
    with pytest.raises(MXNetError, match="Ci % 8 == 0"):
        fcb.launch_plan((2, 8, 8, ci), 64, (3, 3), (1, 1), (1, 1),
                        torch.bfloat16)
    # fp32 takes it, and so do the plain version's CPU tensors
    assert fcb.launch_plan((2, 8, 8, ci), 64, (3, 3), (1, 1), (1, 1),
                           torch.float32)[:2] == fcb.TILE_FP32
    x = torch.randn(2, 8, 8, ci).to(torch.bfloat16)
    w = torch.randn(64, ci, 3, 3).to(torch.bfloat16)
    y, _, _ = fcb.fused_conv_unit(x, w, kernel=(3, 3), pad=(1, 1))
    assert y.shape == (2, 8, 8, 64)


def test_build_hash_covers_headers(tmp_path, monkeypatch):
    src = tmp_path / "csrc"
    shutil.copytree(_kernels._SRC_DIR, src)
    monkeypatch.setattr(_kernels, "_SRC_DIR", src)
    before = _kernels._lib_path()
    header = src / "conv_mainloop.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    after = _kernels._lib_path()
    assert after != before
    (src / "attention.cu").write_text((src / "attention.cu").read_text()
                                      + "\n")
    assert _kernels._lib_path() not in (before, after)


def test_only_cu_sources_are_compiled_and_all_of_them():
    cu = sorted(p.name for p in _kernels._SRC_DIR.glob("*.cu"))
    assert sorted(_kernels._SOURCES) == cu
    assert (_kernels._SRC_DIR / "conv_mainloop.cuh").exists()


def test_kernel_source_is_the_hopper_design():
    text = (_kernels._SRC_DIR / "fused_convbn.cu").read_text() \
        + (_kernels._SRC_DIR / "conv_mainloop.cuh").read_text()
    assert "nvcuda::wmma" not in text and "<mma.h>" not in text
    for piece in ("wgmma.mma_async", "cp.async.bulk.tensor",
                  "cp.async.mbarrier.arrive", "mbarrier.try_wait",
                  "stats_reduce_kernel"):
        assert piece in text, piece
    assert "reduce_stats_kernel" not in text
