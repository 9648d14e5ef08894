// Tap-accumulation fused unit with an explicit batch tile, for Hopper.
//
// Replaces the TPU kernel `candidate_tap` (tools/scratch_convbn_probe.py:17),
// the probe of the fused Conv+BN unit in tap-accumulation form.  For NHWC x
// (N,H,W,Ci), weights in tap layout w_taps (KH,KW,Ci,Co) and a batch tile nb
// that divides N, it computes:
//
//   u  = act_in ? relu(x * in_scale + in_bias) cast to x's type : x
//        (zero padding AFTER the affine: taps outside the image read 0)
//   y  = sum over taps (ky,kx) of u[n, oh*SH-PH+ky, ow*SW-PW+kx, :] @
//        w_taps[ky,kx], accumulated in fp32, stored in x's type
//   s1 = sum y, s2 = sum (y - shift)^2, in fp32 from the STORED (cast) y:
//        per m-tile partial rows summed by reduce_stats in a fixed order,
//        so two launches give the same bits.  Without want_stats the
//        wrapper returns zeros.
//
// That is kernel 1's function (fused_convbn.cu) with the weights in another
// layout, so this kernel runs kernel 1's bodies from conv_mainloop.cuh
// (unit::wgmma_body, unit::fma_body) with WL = W_TAPS and names its own
// instances (tap_unit_wgmma_kernel, tap_unit_fma_kernel, and
// stats_reduce_kernel<2>), so a profile tells kernels 1 and 6 apart.
//
// Design (bf16): the persistent, warp-specialised wgmma implicit GEMM of
// kernel 1 over the output rows M = N*Ho*Wo, with kernel 1's tiles (128 x
// 128 or 64 x 64, chosen by the wrapper from the shape by kernel 1's rule):
// a producer warpgroup fills a 4-stage ring (x rows by cp.async with zero
// fill, weight boxes by TMA in the 128-byte swizzle), the consumers apply
// the affine in registers and run wgmma with A from registers.  The
// weights come straight from the tap layout: w_taps is the row-major
// (KH*KW*Ci) x Co matrix, K x N with N contiguous, so each stage loads
// BN / 64 TMA boxes of 64 K rows x 64 Co and wgmma reads B MN-major (its
// transpose-B form, as kernel 2's wgrad reads dy); no permute to OHWI.
// The M tiling does not depend on nb: nb sized the TPU kernel's VMEM
// batch tile, and here keeps only its contract (N % nb == 0, else the
// wrapper raises before any launch).
//
// Bound on one H100 SXM (3.35 TB/s, 989 TFLOP/s dense bf16): kernel 1's.
// At ResNet-50's batch-256 layers the 1x1 convs are memory-bound (56x56,
// 64->256: 26 GFLOP, ~27 us of tensor-core time against ~0.51 GB of x+y,
// ~153 us of bytes) and the 3x3 convs at 28x28 and below compute-bound
// (28x28, 128->128: 59 GFLOP, ~60 us, against ~0.10 GB, ~31 us).
//
// fp32 stays on the FMA units (tensor cores would round it to TF32):
// kernel 1's 128 x 64 FMA tiles with the tap layout's B loads, the same
// partials and reduction.
//
// Takes: bf16 Ci % 8 == 0 (16-byte cp.async rows) and Co % 8 == 0 (the TMA
// row stride), 16-byte aligned x and w_taps; N % nb == 0.
#include "conv_mainloop.cuh"

namespace {

using namespace mxconv;
using namespace mxconv::unit;

template <int BM, int BN>
__global__ void __launch_bounds__(WgmmaTile<BM, BN>::THREADS, BM == 64 ? 2 : 1)
    tap_unit_wgmma_kernel(const __grid_constant__ CUtensorMap wmap,
                          const Params p, long long tiles) {
  extern __shared__ unsigned char smem_raw[];
  wgmma_body<BM, BN, W_TAPS>(wmap, p, tiles, smem_raw);
}

__global__ void __launch_bounds__(F_THREADS) tap_unit_fma_kernel(Params p) {
  fma_body<W_TAPS>(p);
}

template <int BM, int BN>
cudaError_t launch_wgmma(const CUtensorMap& map, const Params& p, long long tiles, cudaStream_t s) {
  static bool attr = false;
  return launch_wgmma_unit<BM, BN>(tap_unit_wgmma_kernel<BM, BN>, attr, map, p, tiles, s);
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16.  w is w_taps (KH, KW, Ci, Co),
// contiguous.  (bm, bn) is the output tile, as for mx_fused_conv_unit:
// bf16 takes (64, 64) or (128, 128) with Ci % 8 == 0, Co % 8 == 0 and
// 16-byte aligned x and w; fp32 takes (128, 64).  nb must divide N.
// part1/part2 are (scratch_rows, Co) fp32 scratch and s1/s2 (Co) fp32
// outputs; all four are ignored when want_stats is 0.  Launches on
// `stream`, never synchronises, and returns cudaGetLastError() after the
// launches (0 = success; cudaErrorInvalidValue for a shape, tile or
// alignment it does not take, before any launch).
int mx_convbn_tap(int dtype, const void* x, const void* w, const void* in_scale,
                  const void* in_bias, const void* shift, void* y, void* part1, void* part2,
                  void* s1, void* s2, int N, int H, int W, int Ci, int Co, int KH, int KW, int SH,
                  int SW, int PH, int PW, int nb, int act_in, int want_stats, int bm, int bn,
                  long long scratch_rows, void* stream) {
  if (nb < 1 || N % nb != 0) return (int)cudaErrorInvalidValue;
  Params p;
  const long long tiles = fill_params(p, x, w, in_scale, in_bias, shift, y, part1, part2, N, H, W,
                                      Ci, Co, KH, KW, SH, SW, PH, PW, act_in, want_stats, bm, bn);
  if (tiles == 0) return (int)cudaErrorInvalidValue;
  if (want_stats && scratch_rows < scratch_rows_for(tiles)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 1) {
    const bool tile_ok = (bm == 64 && bn == 64) || (bm == 128 && bn == 128);
    if (!tile_ok || Ci % 8 != 0 || Co % 8 != 0 || (uintptr_t)x % 16 != 0 ||
        (uintptr_t)w % 16 != 0) {
      return (int)cudaErrorInvalidValue;
    }
    CUtensorMap map;
    if (!encode_rows_b128(&map, w, (long long)KH * KW * Ci, Co, 64)) {
      return (int)cudaErrorInvalidValue;
    }
    err = bm == 128 ? launch_wgmma<128, 128>(map, p, tiles, s) : launch_wgmma<64, 64>(map, p, tiles, s);
  } else if (dtype == 0) {
    if (bm != F_BM || bn != F_BN || tiles > 0x7fffffffLL || p.n_tiles > 65535) {
      return (int)cudaErrorInvalidValue;
    }
    tap_unit_fma_kernel<<<dim3((unsigned)tiles, (unsigned)p.n_tiles), F_THREADS, 0, s>>>(p);
    err = cudaGetLastError();
  } else {
    return (int)cudaErrorInvalidValue;
  }
  if (err != cudaSuccess || !want_stats) return (int)err;
  return (int)reduce_stats<2>(p.part1, p.part2, tiles, Co, static_cast<float*>(s1),
                              static_cast<float*>(s2), s);
}

}  // extern "C"
