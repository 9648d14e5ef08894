"""The host-side plan of the tap-accumulation unit's kernel (kernel 6):
its tiles against kernel 1's at every batch tile nb, the shapes the bf16
kernel refuses (while CPU tensors still run the plain version), its
statistics scratch, and its source, which runs kernel 1's main loop from
``conv_mainloop.cuh`` with the weights in tap layout.  All on the CPU:
nothing here builds or launches a kernel."""
import math
import shutil

import pytest
import torch

from mxnet_tpu_torch import _kernels
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.ops import convbn_tap as ct
from mxnet_tpu_torch.ops import fused_convbn as fcb
from mxnet_tpu_torch.tools import convbn_probe as probe

import chip_smoke

SRC = _kernels._SRC_DIR


def _layers():
    """(x shape, Co, kernel, stride, pad, nb) of the probe's nine time-mode
    layers at each nb it times, and of its four check cases at CHECK_NB."""
    return ([(*layer, nb) for layer in probe.LAYERS for nb in probe.TAP_NB]
            + [(*case, probe.CHECK_NB) for case in probe.CASES])


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("layer", _layers(),
                         ids=lambda t: f"{t[0][1]}x{t[0][2]}.{t[0][3]}-{t[1]}"
                         f".k{t[2][0]}s{t[3][0]}.nb{t[5]}")
def test_tile_plan_is_kernel_1s_at_every_nb(layer, dtype):
    shape, co, kernel, stride, pad, nb = layer
    plan = ct.launch_plan(shape, co, kernel, stride, pad, dtype, nb)
    assert plan == fcb.launch_plan(shape, co, kernel, stride, pad, dtype)
    if dtype == torch.bfloat16:
        assert plan[:2] in fcb.TILES_BF16
    else:
        assert plan[:2] == fcb.TILE_FP32


def test_co_off_64_is_taken():
    # Co = 72 is a whole number of 16-byte TMA rows: two 64-column tiles,
    # the second zero past 72
    assert ct.launch_plan((4, 14, 14, 64), 72, (3, 3), (1, 1), (1, 1),
                          torch.bfloat16, 2)[:2] == (64, 64)


def test_m_tiling_does_not_depend_on_nb():
    shape, co, kernel, stride, pad = probe.LAYERS[-2]  # 7x7 3x3, 512->512
    plans = {ct.launch_plan(shape, co, kernel, stride, pad, torch.bfloat16,
                            nb) for nb in (1, 2, 16, 64, 256)}
    assert len(plans) == 1
    bm, bn, rows = plans.pop()
    # at nb=1 the first design's m-blocks held 49 of 128 rows; now every
    # tile but the last is full
    m = shape[0] * 7 * 7
    assert (bm, bn) == (128, 128) and -(-m // bm) == 98 and m % bm == 0


@pytest.mark.parametrize("ci,co", [(12, 64), (64, 76), (40, 20), (3, 64)])
def test_bf16_plan_refuses_ci_or_co_not_a_multiple_of_8(ci, co):
    with pytest.raises(MXNetError, match=r"Ci % 8 == 0 and Co % 8 == 0"):
        ct.launch_plan((2, 8, 8, ci), co, (3, 3), (1, 1), (1, 1),
                       torch.bfloat16, 2)
    # fp32 takes it, and so do the plain version's CPU tensors
    assert ct.launch_plan((2, 8, 8, ci), co, (3, 3), (1, 1), (1, 1),
                          torch.float32, 2)[:2] == fcb.TILE_FP32
    x = torch.randn(2, 8, 8, ci).to(torch.bfloat16)
    w = ct.weight_taps(torch.randn(co, ci, 3, 3).to(torch.bfloat16))
    ones, zeros = torch.ones(ci), torch.zeros(co)
    ct.reset_launch_count()
    y, s1, s2 = ct.candidate_tap(x, w, ones, torch.zeros(ci), zeros,
                                 kernel=(3, 3), stride=(1, 1), pad=(1, 1),
                                 act_in=True, want_stats=True, nb=2)
    assert y.shape == (2, 8, 8, co) and s1.shape == s2.shape == (1, co)
    assert ct.launch_count() == 0


def test_refused_shape_raises_before_the_library_loads(monkeypatch):
    """The launch step plans first, so a refused shape raises its own
    error and never reaches the kernel library (or the counter)."""
    def no_load():
        raise AssertionError("the library was loaded")
    monkeypatch.setattr(_kernels, "load", no_load)
    x = torch.zeros(4, 14, 14, 64, dtype=torch.bfloat16)
    w = torch.zeros(3, 3, 64, 20, dtype=torch.bfloat16)
    ct.reset_launch_count()
    with pytest.raises(MXNetError, match="Co=20"):
        ct._launch(x, w, torch.ones(64), torch.zeros(64), torch.zeros(20),
                   (3, 3), (1, 1), (1, 1), True, True, 2)
    with pytest.raises(MXNetError, match="nb=4 must divide N=6"):
        ct._launch(torch.zeros(6, 14, 14, 64, dtype=torch.bfloat16),
                   torch.zeros(1, 1, 64, 64, dtype=torch.bfloat16),
                   torch.ones(64), torch.zeros(64), torch.zeros(64),
                   (1, 1), (1, 1), (0, 0), True, True, 4)
    assert ct.launch_count() == 0


@pytest.mark.parametrize("nb", [0, 3, 5])
def test_plan_refuses_nb_that_does_not_divide_n(nb):
    with pytest.raises(MXNetError, match="must divide"):
        ct.launch_plan((4, 8, 8, 16), 16, (1, 1), (1, 1), (0, 0),
                       torch.bfloat16, nb)


@pytest.mark.parametrize("layer,rows", [
    (0, 12544 + 98),       # 56x56 64->64 3x3: 64x64 tiles, one extra pass
    (3, 1568 + 13),        # 28x28 128->128 3x3: 128x128 tiles
    (7, 98),               # 7x7 512->512 3x3: one reduction pass
])
def test_statistics_scratch_holds_every_reduction_pass(layer, rows):
    shape, co, kernel, stride, pad = probe.LAYERS[layer]
    bm, _, got = ct.launch_plan(shape, co, kernel, stride, pad,
                                torch.bfloat16, 1)
    ho, wo = fcb._out_hw(shape[1], shape[2], kernel, stride, pad)
    tiles = math.ceil(shape[0] * ho * wo / bm)
    assert got == fcb.scratch_rows(tiles) == rows


def test_tap_source_runs_kernel_1s_main_loop():
    tap = (SRC / "convbn_tap.cu").read_text()
    fused = (SRC / "fused_convbn.cu").read_text()
    header = (SRC / "conv_mainloop.cuh").read_text()
    assert '#include "conv_mainloop.cuh"' in tap
    for text in (tap, fused, header):
        assert "nvcuda::wmma" not in text and "<mma.h>" not in text
    # one main loop: both kernels instantiate the header's bodies, and
    # neither source holds a wgmma of its own
    assert "wgmma_body<BM, BN, W_TAPS>" in tap and "fma_body<W_TAPS>" in tap
    assert "wgmma_body<BM, BN, W_OHWI>" in fused and "fma_body<W_OHWI>" in fused
    for text in (tap, fused):
        assert "wgmma_rs" not in text and "mbar_wait" not in text
    # the tap layout is read MN-major, two 64-column boxes at BN = 128
    assert "wgmma_rs<1>(acc, a[kk], b128_mn_desc(sb + kk * 16 * ROW_BYTES, " \
        "64 * ROW_BYTES), 1)" in header
    assert "encode_rows_b128(&map, w, (long long)KH * KW * Ci, Co, 64)" in tap
    # its statistics reduce in its own instance, in a fixed order
    assert "reduce_stats<2>" in tap
    assert "tap_reduce_tiles_kernel" not in tap


def test_profile_names_tell_kernel_6_from_kernel_1():
    tap = (SRC / "convbn_tap.cu").read_text()
    fused = (SRC / "fused_convbn.cu").read_text()
    for name in chip_smoke.KERNEL6_NAMES:
        assert name.strip(":(") not in fused
    assert "tap_unit_wgmma_kernel" in tap
    assert chip_smoke.KERNEL6_NAMES[0] == "::tap_unit_wgmma_kernel<"
    assert "reduce_stats<2>" in tap and "<2>(" in chip_smoke.KERNEL6_NAMES[1]
    for name in chip_smoke.KERNEL1_NAMES:
        assert name.strip(":(") not in tap


@pytest.mark.parametrize("edited", ["conv_mainloop.cuh", "convbn_tap.cu"])
def test_build_hash_covers_the_tap_kernel_and_its_header(tmp_path,
                                                         monkeypatch,
                                                         edited):
    src = tmp_path / "csrc"
    shutil.copytree(SRC, src)
    monkeypatch.setattr(_kernels, "_SRC_DIR", src)
    before = _kernels._lib_path()
    path = src / edited
    path.write_text(path.read_text() + "\n// edited\n")
    assert _kernels._lib_path() != before
