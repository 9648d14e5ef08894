// Fused (input affine + ReLU) -> conv -> (BN statistics) unit for Hopper.
//
// Replaces the TPU kernel `_pallas_unit` (mxnet_tpu/ops/pallas_convbn.py:156).
// It computes, for NHWC x (N,H,W,Ci) and w in OHWI order (Co,KH,KW,Ci):
//
//   u  = act_in ? relu(x * in_scale + in_bias) cast to x's type : x
//        (multiply, then add, no FMA contraction; zero padding is applied
//        AFTER the affine: taps outside the image read exactly 0, never
//        relu(in_bias))
//   y  = conv(u, w), accumulated in fp32, stored in x's type
//   s1 = sum_{n,h,w} y,  s2 = sum_{n,h,w} (y - shift)^2, in fp32, taken
//        from the STORED (cast) y; the wrapper returns zeros when
//        want_stats is off.  Deterministic from run to run.
//
// What bounds it on one H100 SXM (3.35 TB/s, 989 TFLOP/s dense bf16; the
// probe's unit_bound): ResNet-50's 1x1 layers and the 56x56 3x3 layer by
// bytes (x, w and y each moved once), the 3x3 layers from 28x28 down (and
// the 7x7 1x1 expansion) by tensor-core operations.
//
// Design (bf16): an implicit GEMM.  The output is the matrix
// (M = N*Ho*Wo) x Co, cut into BM x BN tiles (128 x 128, or 64 x 64 where
// Co < 128 or the big tile would leave an SM fewer than two; the wrapper
// chooses from the shape); each tile walks K = KH*KW*Ci in steps of one tap and
// 64 input channels.  The kernel is persistent: as many blocks as fit on
// the card, each walking the tiles b, b + grid, ...  In a block one
// producer warpgroup fills a 4-stage ring of shared-memory tiles and one
// or two consumer warpgroups (64 rows each) multiply them with wgmma.
// What it does about the first design's faults:
//   - pipeline: the producer keeps up to 4 K steps in flight, and runs on
//     into the next tile while the consumers store the last one; each
//     stage completes on an mbarrier (full) and is handed back on another
//     (empty), so no load waits on the tensor cores or the other way;
//   - wgmma: the consumers issue wgmma.mma_async m64nBNk16 (fp32
//     accumulators in registers), no WMMA;
//   - weights as K-major rows: w arrives in OHWI order (a view of the
//     checkpoint for 1x1 convs, one permute a call for 3x3), seen as the
//     row-major matrix (Co, KH*KW*Ci); each stage's BN x 64 box is one TMA
//     load with the 128-byte swizzle, zero-filled past Co and K;
//   - A (x rows) is a row gather a tiled TMA box cannot express: 16-byte
//     cp.async copies into the same swizzle, zero-filled (src-size 0) for
//     rows past M, taps outside the image and channels past Ci, completing
//     on the stage's mbarrier (cp.async.mbarrier.arrive.noinc);
//   - the affine in registers: a consumer reads its raw x fragment with
//     ldmatrix, applies x*scale+bias in fp32 (per-channel scale and bias
//     staged once in shared memory, zeros past Ci), rounds to bf16 with a
//     relu cvt, masks rows whose tap falls outside the image to exact
//     zeros (padding after the affine) and feeds wgmma with A from
//     registers (the RS form); u never exists in device memory;
//   - statistics in parallel: the epilogue rounds the accumulators to bf16
//     and stages the tile in its own shared memory, for 16-byte stores of
//     y and for the column sums: every consumer thread sums s1/s2 of the
//     rounded values over a run of one column's rows in row order, then
//     the runs are added in order into one fp32 partial per (m-tile,
//     channel) (shift staged once in shared memory); stats_reduce_kernel
//     sums 128 partials a block
//     (8 warps x 16 rows in order, then the warps in order) and repeats on
//     its own output until one row is left: the same grid and order every
//     run, so s1/s2 are bit-identical from run to run.
// The shared pieces (PTX wrappers, the TMA map, the reduction) and the
// kernel bodies themselves (unit::wgmma_body, unit::fma_body) live in
// conv_mainloop.cuh: kernel 6 (convbn_tap.cu) runs the same bodies on
// weights in tap layout.  This file names kernel 1's instances and launches
// them.
//
// fp32 stays on the FMA units (tensor cores would round it to TF32): a
// 128 x 64 tile a block, loads into padded shared memory, the same partials
// and reduction.
#include "conv_mainloop.cuh"

namespace {

using namespace mxconv;
using namespace mxconv::unit;

template <int BM, int BN>
__global__ void __launch_bounds__(WgmmaTile<BM, BN>::THREADS, BM == 64 ? 2 : 1)
    conv_unit_wgmma_kernel(const __grid_constant__ CUtensorMap wmap,
                           const Params p, long long tiles) {
  extern __shared__ unsigned char smem_raw[];
  wgmma_body<BM, BN, W_OHWI>(wmap, p, tiles, smem_raw);
}

__global__ void __launch_bounds__(F_THREADS) conv_unit_fma_kernel(Params p) {
  fma_body<W_OHWI>(p);
}

template <int BM, int BN>
cudaError_t launch_wgmma(const CUtensorMap& map, const Params& p, long long tiles, cudaStream_t s) {
  static bool attr = false;
  return launch_wgmma_unit<BM, BN>(conv_unit_wgmma_kernel<BM, BN>, attr, map, p, tiles, s);
}

}  // namespace

extern "C" {

const char* mx_cuda_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

// dtype: 0 = float32, 1 = bfloat16.  w is OHWI (Co, KH, KW, Ci),
// contiguous.  (bm, bn) is the output tile: bf16 takes (64, 64) or (128, 128),
// Ci % 8 == 0 and 16-byte aligned x and w; fp32 takes (128, 64).
// part1/part2 are (scratch_rows, Co) fp32 scratch and s1/s2 (Co) fp32
// outputs; all four are ignored when want_stats is 0.  Launches on
// `stream`, never synchronises, and returns cudaGetLastError() after the
// launches (0 = success; cudaErrorInvalidValue for a shape, tile or
// alignment it does not take, before any launch).
int mx_fused_conv_unit(int dtype, const void* x, const void* w, const void* in_scale,
                       const void* in_bias, const void* shift, void* y, void* part1, void* part2,
                       void* s1, void* s2, int N, int H, int W, int Ci, int Co, int KH, int KW,
                       int SH, int SW, int PH, int PW, int act_in, int want_stats, int bm, int bn,
                       long long scratch_rows, void* stream) {
  Params p;
  const long long tiles = fill_params(p, x, w, in_scale, in_bias, shift, y, part1, part2, N, H, W,
                                      Ci, Co, KH, KW, SH, SW, PH, PW, act_in, want_stats, bm, bn);
  if (tiles == 0) return (int)cudaErrorInvalidValue;
  if (want_stats && scratch_rows < scratch_rows_for(tiles)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 1) {
    const bool tile_ok = (bm == 64 && bn == 64) || (bm == 128 && bn == 128);
    if (!tile_ok || Ci % 8 != 0 || (uintptr_t)x % 16 != 0 || (uintptr_t)w % 16 != 0) {
      return (int)cudaErrorInvalidValue;
    }
    CUtensorMap map;
    if (!encode_rows_b128(&map, w, Co, (long long)KH * KW * Ci, bn)) return (int)cudaErrorInvalidValue;
    err = bm == 128 ? launch_wgmma<128, 128>(map, p, tiles, s) : launch_wgmma<64, 64>(map, p, tiles, s);
  } else if (dtype == 0) {
    if (bm != F_BM || bn != F_BN || tiles > 0x7fffffffLL || p.n_tiles > 65535) {
      return (int)cudaErrorInvalidValue;
    }
    conv_unit_fma_kernel<<<dim3((unsigned)tiles, (unsigned)p.n_tiles), F_THREADS, 0, s>>>(p);
    err = cudaGetLastError();
  } else {
    return (int)cudaErrorInvalidValue;
  }
  if (err != cudaSuccess || !want_stats) return (int)err;
  return (int)reduce_stats<0>(p.part1, p.part2, tiles, Co, static_cast<float*>(s1),
                              static_cast<float*>(s2), s);
}

}  // extern "C"
