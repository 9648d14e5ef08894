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
//   s1 = sum y, s2 = sum (y - shift)^2, in fp32 from the STORED (cast) y,
//        over the N/nb tiles of nb images in tile order (the TPU kernel's
//        `+=` across its sequential grid).  Without want_stats the wrapper
//        returns zeros.
//
// Design: an implicit GEMM over the rows M = N*Ho*Wo, cut into tiles of
// nb*Ho*Wo rows.  Grid: x = (N/nb tiles) x (m-blocks of BM rows inside a
// tile), y = Co blocks of BN; an m-block never crosses a tile boundary, so
// a tile's last block may hold idle rows (nb=1 at 7x7: 49 of 128 rows
// busy).  The reduction K = KH*KW*Ci runs as a loop over taps and BK-wide
// Ci chunks.  The A tile is u, made from x while it is loaded into shared
// memory (affine+ReLU in fp32, cast, exact zeros outside the window); the
// B tile is w_taps[ky,kx,ci0:ci0+BK,co0:co0+BN], already row-major K x N
// with Co contiguous, so it loads with 16-byte vectors.  bf16 multiplies on
// the tensor cores through WMMA (16x16x16, fp32 accumulators); fp32 runs on
// the FMA units (tensor cores would round fp32 to TF32).
//
// Statistics, two levels and deterministic: the epilogue of each (tile,
// m-block) writes per-channel partials of its rows, taken by all 256
// threads (four row groups of 32 rows per channel, each summed in row order,
// then the groups in order); tap_reduce_tiles_kernel sums a tile's m-blocks
// in block order, in parallel over tiles and channels; tap_reduce_total_
// kernel sums the tiles in tile order.
//
// Bound on one H100 SXM (3.35 TB/s, 989 TFLOP/s dense bf16): the same
// function as fused_convbn.cu, so the same bound: at ResNet-50's batch-256
// layers the 1x1 convs are memory-bound (56x56, 64->256: 26 GFLOP, ~27 us
// of tensor-core time against ~0.51 GB of x+y, ~153 us of bytes) and the
// 3x3 convs at 28x28 and below compute-bound (28x28, 128->128: 59 GFLOP,
// ~60 us, against ~0.10 GB, ~31 us).  This first version has no
// TMA/wgmma pipeline and no double buffering: it is written to be right.
//
// Limits: N % nb == 0; (N/nb) * (m-blocks a tile) < 2^31; Co/BN blocks
// <= 65535; N/nb tiles <= 65535 (the tile reduction's grid); element
// offsets are 64-bit.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace {

constexpr int BM = 128;        // output rows (pixels) per block
constexpr int BN = 64;         // output channels per block
constexpr int BK = 32;         // input channels per reduction step
constexpr int THREADS = 256;   // 8 warps
constexpr int A_LD = BK + 8;   // smem row pitches (elements), padded
constexpr int B_LD = BN + 8;
constexpr int C_LD = BN + 4;
constexpr int GROUPS = THREADS / BN;   // statistics: threads per channel
constexpr int GROUP_ROWS = BM / GROUPS;

struct TapParams {
  const void* x;
  const void* w;
  const float* in_scale;
  const float* in_bias;
  const float* shift;
  void* y;
  float* part1;
  float* part2;
  long long tile_rows;  // nb * Ho * Wo
  int m_per_tile;       // m-blocks a tile
  int H, W, Ci, Co, KH, KW, SH, SW, PH, PW, Ho, Wo;
  int act_in, want_stats, vec_x, vec_w;
};

template <typename T> __device__ __forceinline__ float to_f(T v);
template <> __device__ __forceinline__ float to_f<float>(float v) { return v; }
template <> __device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// eight consecutive elements, 16-byte aligned, as floats
template <typename T> __device__ __forceinline__ void load8(const T* src, float* v);
template <> __device__ __forceinline__ void load8<float>(const float* src, float* v) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(src));
  const float4 b = __ldg(reinterpret_cast<const float4*>(src) + 1);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}
template <> __device__ __forceinline__ void load8<__nv_bfloat16>(const __nv_bfloat16* src, float* v) {
  const uint4 raw = __ldg(reinterpret_cast<const uint4*>(src));
  const __nv_bfloat16* h = reinterpret_cast<const __nv_bfloat16*>(&raw);
#pragma unroll
  for (int j = 0; j < 8; ++j) v[j] = __bfloat162float(h[j]);
}

// eight consecutive elements copied as they are; both ends 16-byte aligned
template <typename T> __device__ __forceinline__ void copy8(const T* src, T* dst);
template <> __device__ __forceinline__ void copy8<float>(const float* src, float* dst) {
  reinterpret_cast<float4*>(dst)[0] = __ldg(reinterpret_cast<const float4*>(src));
  reinterpret_cast<float4*>(dst)[1] = __ldg(reinterpret_cast<const float4*>(src) + 1);
}
template <> __device__ __forceinline__ void copy8<__nv_bfloat16>(const __nv_bfloat16* src,
                                                                 __nv_bfloat16* dst) {
  *reinterpret_cast<uint4*>(dst) = __ldg(reinterpret_cast<const uint4*>(src));
}

template <typename T, bool TENSOR_CORES>
__global__ void __launch_bounds__(THREADS) convbn_tap_kernel(TapParams p) {
  constexpr int A_BYTES = BM * A_LD * (int)sizeof(T);
  constexpr int B_BYTES = BK * B_LD * (int)sizeof(T);
  constexpr int C_BYTES = BM * C_LD * (int)sizeof(float);
  constexpr int SMEM = (A_BYTES + B_BYTES > C_BYTES) ? (A_BYTES + B_BYTES) : C_BYTES;
  // the fp32 C tile reuses the A/B staging space after the K loop
  __shared__ __align__(128) unsigned char smem[SMEM];
  __shared__ long long row_base[BM];  // element offset of the row's image in x
  __shared__ int row_ih0[BM];         // top-left input coordinate of the window
  __shared__ int row_iw0[BM];
  __shared__ float red1[GROUPS][BN];  // statistics of each row group
  __shared__ float red2[GROUPS][BN];

  T* sA = reinterpret_cast<T*>(smem);
  T* sB = reinterpret_cast<T*>(smem + A_BYTES);
  float* sC = reinterpret_cast<float*>(smem);

  const int tid = threadIdx.x;
  const int tile = blockIdx.x / p.m_per_tile;
  const int mb = blockIdx.x - tile * p.m_per_tile;
  const long long r0 = (long long)mb * BM;               // first row in the tile
  const long long m0 = (long long)tile * p.tile_rows + r0;
  const long long left = p.tile_rows - r0;
  const int rows = left < BM ? (int)left : BM;           // busy rows of the block
  const int co0 = blockIdx.y * BN;
  const T* x = static_cast<const T*>(p.x);
  const T* w = static_cast<const T*>(p.w);

  if (tid < BM) {
    if (tid < rows) {
      const long long m = m0 + tid;
      const int hw = p.Ho * p.Wo;
      const long long n = m / hw;
      const int rem = (int)(m - n * hw);
      const int oh = rem / p.Wo;
      const int ow = rem - oh * p.Wo;
      row_base[tid] = n * (long long)p.H * p.W * p.Ci;
      row_ih0[tid] = oh * p.SH - p.PH;
      row_iw0[tid] = ow * p.SW - p.PW;
    } else {  // idle rows: every tap falls outside, the row stays 0
      row_base[tid] = 0;
      row_ih0[tid] = -(1 << 29);
      row_iw0[tid] = -(1 << 29);
    }
  }
  __syncthreads();

  const int warp = tid >> 5;
  const int wm = warp >> 1;  // tensor-core path: warp tile rows wm*32..+32
  const int wn = warp & 1;   //                   warp tile cols wn*32..+32
  const int ty = tid >> 4;   // FMA path: rows ty*8..+8
  const int tx = tid & 15;   //           cols tx*4..+4

  nvcuda::wmma::fragment<nvcuda::wmma::accumulator, 16, 16, 16, float> acc[2][2];
  float facc[8][4];
  if constexpr (TENSOR_CORES) {
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) nvcuda::wmma::fill_fragment(acc[i][j], 0.0f);
  } else {
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) facc[i][j] = 0.0f;
  }

  for (int ky = 0; ky < p.KH; ++ky) {
    for (int kx = 0; kx < p.KW; ++kx) {
      const T* w_tap = w + (long long)(ky * p.KW + kx) * p.Ci * p.Co;
      for (int ci0 = 0; ci0 < p.Ci; ci0 += BK) {
        // ---- A tile (BM x BK): u for this tap, 2 rows x 8 channels a thread
        {
          const int c = (tid & 3) * 8;
#pragma unroll
          for (int rr = 0; rr < 2; ++rr) {
            const int r = (tid >> 2) + rr * 64;
            const int ih = row_ih0[r] + ky;
            const int iw = row_iw0[r] + kx;
            T* dst = sA + r * A_LD + c;
            float v[8];
            if (ih >= 0 && ih < p.H && iw >= 0 && iw < p.W) {
              const T* src = x + row_base[r] + ((long long)ih * p.W + iw) * p.Ci + ci0 + c;
              if (p.vec_x && ci0 + c + 8 <= p.Ci) {
                load8<T>(src, v);
              } else {
#pragma unroll
                for (int j = 0; j < 8; ++j) v[j] = (ci0 + c + j < p.Ci) ? to_f<T>(src[j]) : 0.0f;
              }
#pragma unroll
              for (int j = 0; j < 8; ++j) {
                const int ci = ci0 + c + j;
                if (ci < p.Ci) {
                  if (p.act_in) {
                    // multiply, then add: no FMA contraction, so u rounds
                    // exactly as the plain version's two separate ops
                    v[j] = fmaxf(__fadd_rn(__fmul_rn(v[j], p.in_scale[ci]), p.in_bias[ci]), 0.0f);
                  }
                } else {
                  v[j] = 0.0f;
                }
              }
            } else {
#pragma unroll
              for (int j = 0; j < 8; ++j) v[j] = 0.0f;  // padding: exact zeros
            }
#pragma unroll
            for (int j = 0; j < 8; ++j) dst[j] = from_f<T>(v[j]);
          }
        }
        // ---- B tile (BK x BN): w_taps[ky, kx, ci, co], 8 channels a thread
        {
          const int k = tid >> 3;
          const int n8 = (tid & 7) * 8;
          const int ci = ci0 + k;
          const int co = co0 + n8;
          T* dst = sB + k * B_LD + n8;
          if (ci < p.Ci && p.vec_w && co + 8 <= p.Co) {
            copy8<T>(w_tap + (long long)ci * p.Co + co, dst);
          } else {
#pragma unroll
            for (int j = 0; j < 8; ++j)
              dst[j] = (ci < p.Ci && co + j < p.Co) ? w_tap[(long long)ci * p.Co + co + j]
                                                    : from_f<T>(0.0f);
          }
        }
        __syncthreads();

        if constexpr (TENSOR_CORES) {
#pragma unroll
          for (int kk = 0; kk < BK; kk += 16) {
            nvcuda::wmma::fragment<nvcuda::wmma::matrix_a, 16, 16, 16, T, nvcuda::wmma::row_major> a[2];
            nvcuda::wmma::fragment<nvcuda::wmma::matrix_b, 16, 16, 16, T, nvcuda::wmma::row_major> b[2];
#pragma unroll
            for (int i = 0; i < 2; ++i)
              nvcuda::wmma::load_matrix_sync(a[i], sA + (wm * 32 + i * 16) * A_LD + kk, A_LD);
#pragma unroll
            for (int j = 0; j < 2; ++j)
              nvcuda::wmma::load_matrix_sync(b[j], sB + kk * B_LD + wn * 32 + j * 16, B_LD);
#pragma unroll
            for (int i = 0; i < 2; ++i)
#pragma unroll
              for (int j = 0; j < 2; ++j) nvcuda::wmma::mma_sync(acc[i][j], a[i], b[j], acc[i][j]);
          }
        } else {
#pragma unroll 4
          for (int kk = 0; kk < BK; ++kk) {
            float a[8], b[4];
#pragma unroll
            for (int i = 0; i < 8; ++i) a[i] = to_f<T>(sA[(ty * 8 + i) * A_LD + kk]);
#pragma unroll
            for (int j = 0; j < 4; ++j) b[j] = to_f<T>(sB[kk * B_LD + tx * 4 + j]);
#pragma unroll
            for (int i = 0; i < 8; ++i)
#pragma unroll
              for (int j = 0; j < 4; ++j) facc[i][j] = fmaf(a[i], b[j], facc[i][j]);
          }
        }
        __syncthreads();
      }
    }
  }

  // ---- epilogue: fp32 tile -> smem, cast, store y, stats of the cast y
  if constexpr (TENSOR_CORES) {
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j)
        nvcuda::wmma::store_matrix_sync(sC + (wm * 32 + i * 16) * C_LD + wn * 32 + j * 16, acc[i][j],
                                        C_LD, nvcuda::wmma::mem_row_major);
  } else {
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sC[(ty * 8 + i) * C_LD + tx * 4 + j] = facc[i][j];
  }
  __syncthreads();

  T* y = static_cast<T*>(p.y);
  for (int e = tid; e < BM * BN; e += THREADS) {
    const int r = e / BN;
    const int c = e - r * BN;
    const int co = co0 + c;
    const T yc = from_f<T>(sC[r * C_LD + c]);
    if (r < rows && co < p.Co) y[(m0 + r) * p.Co + co] = yc;
    sC[r * C_LD + c] = to_f<T>(yc);
  }
  if (!p.want_stats) return;
  __syncthreads();
  {
    const int c = tid % BN;
    const int g = tid / BN;
    const int co = co0 + c;
    const float sh = co < p.Co ? p.shift[co] : 0.0f;
    const int r_end = min(rows, (g + 1) * GROUP_ROWS);
    float a1 = 0.0f, a2 = 0.0f;
    for (int r = g * GROUP_ROWS; r < r_end; ++r) {
      const float v = sC[r * C_LD + c];
      const float d = v - sh;
      a1 += v;
      a2 = fmaf(d, d, a2);
    }
    red1[g][c] = a1;
    red2[g][c] = a2;
  }
  __syncthreads();
  if (tid < BN && co0 + tid < p.Co) {
    float a1 = 0.0f, a2 = 0.0f;
#pragma unroll
    for (int g = 0; g < GROUPS; ++g) {
      a1 += red1[g][tid];
      a2 += red2[g][tid];
    }
    p.part1[(long long)blockIdx.x * p.Co + co0 + tid] = a1;
    p.part2[(long long)blockIdx.x * p.Co + co0 + tid] = a2;
  }
}

// (tiles, Co) <- the sum of each tile's m-block partials, in block order
__global__ void tap_reduce_tiles_kernel(const float* part1, const float* part2, int m_per_tile,
                                        int co_n, float* tile1, float* tile2) {
  const int co = blockIdx.x * blockDim.x + threadIdx.x;
  const int tile = blockIdx.y;
  if (co >= co_n) return;
  const long long base = (long long)tile * m_per_tile * co_n + co;
  float a1 = 0.0f, a2 = 0.0f;
  for (int b = 0; b < m_per_tile; ++b) {
    a1 += part1[base + (long long)b * co_n];
    a2 += part2[base + (long long)b * co_n];
  }
  tile1[(long long)tile * co_n + co] = a1;
  tile2[(long long)tile * co_n + co] = a2;
}

// s1/s2[co] <- the sum of the tiles, in tile order
__global__ void tap_reduce_total_kernel(const float* tile1, const float* tile2, int tiles,
                                        int co_n, float* s1, float* s2) {
  const int co = blockIdx.x * blockDim.x + threadIdx.x;
  if (co >= co_n) return;
  float a1 = 0.0f, a2 = 0.0f;
  for (int t = 0; t < tiles; ++t) {
    a1 += tile1[(long long)t * co_n + co];
    a2 += tile2[(long long)t * co_n + co];
  }
  s1[co] = a1;
  s2[co] = a2;
}

}  // namespace

extern "C" {

// rows per m-block: the wrapper sizes the (tiles * m-blocks, Co) scratch
int mx_convbn_tap_block_m(void) { return BM; }

// dtype: 0 = float32, 1 = bfloat16.  part1/part2 are (N/nb * m-blocks a
// tile, Co) fp32 scratch, tile1/tile2 (N/nb, Co) fp32 scratch and s1/s2
// (Co) fp32 outputs; all six are ignored when want_stats is 0.  Launches on
// `stream`, never synchronises, and returns cudaGetLastError() after the
// launches (0 = success).
int mx_convbn_tap(int dtype, const void* x, const void* w, const void* in_scale,
                  const void* in_bias, const void* shift, void* y, void* part1, void* part2,
                  void* tile1, void* tile2, void* s1, void* s2, int N, int H, int W, int Ci,
                  int Co, int KH, int KW, int SH, int SW, int PH, int PW, int nb, int act_in,
                  int want_stats, int vec_x, int vec_w, void* stream) {
  TapParams p;
  p.x = x;
  p.w = w;
  p.in_scale = static_cast<const float*>(in_scale);
  p.in_bias = static_cast<const float*>(in_bias);
  p.shift = static_cast<const float*>(shift);
  p.y = y;
  p.part1 = static_cast<float*>(part1);
  p.part2 = static_cast<float*>(part2);
  p.H = H; p.W = W; p.Ci = Ci; p.Co = Co;
  p.KH = KH; p.KW = KW; p.SH = SH; p.SW = SW; p.PH = PH; p.PW = PW;
  p.Ho = (H + 2 * PH - KH) / SH + 1;
  p.Wo = (W + 2 * PW - KW) / SW + 1;
  p.act_in = act_in;
  p.want_stats = want_stats;
  p.vec_x = vec_x;
  p.vec_w = vec_w;
  if (nb < 1 || N % nb != 0 || Co <= 0 || p.Ho <= 0 || p.Wo <= 0)
    return (int)cudaErrorInvalidValue;
  const int tiles = N / nb;
  p.tile_rows = (long long)nb * p.Ho * p.Wo;
  const long long m_per_tile = (p.tile_rows + BM - 1) / BM;
  const long long blocks = (long long)tiles * m_per_tile;
  const int n_blocks = (Co + BN - 1) / BN;
  if (blocks > 0x7fffffffLL || n_blocks > 65535 || tiles > 65535)
    return (int)cudaErrorInvalidConfiguration;
  p.m_per_tile = (int)m_per_tile;
  const dim3 grid((unsigned)blocks, (unsigned)n_blocks);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    convbn_tap_kernel<__nv_bfloat16, true><<<grid, THREADS, 0, s>>>(p);
  } else if (dtype == 0) {
    convbn_tap_kernel<float, false><<<grid, THREADS, 0, s>>>(p);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || !want_stats) return (int)err;
  const dim3 rgrid((unsigned)((Co + 127) / 128), (unsigned)tiles);
  tap_reduce_tiles_kernel<<<rgrid, 128, 0, s>>>(p.part1, p.part2, p.m_per_tile, Co,
                                                static_cast<float*>(tile1),
                                                static_cast<float*>(tile2));
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  tap_reduce_total_kernel<<<(Co + 255) / 256, 256, 0, s>>>(
      static_cast<const float*>(tile1), static_cast<const float*>(tile2), tiles, Co,
      static_cast<float*>(s1), static_cast<float*>(s2));
  return (int)cudaGetLastError();
}

}  // extern "C"
