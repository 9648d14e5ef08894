// Fused (input affine + ReLU) -> conv -> (BN statistics) unit for Hopper.
//
// Replaces the TPU kernel `_pallas_unit` (mxnet_tpu/ops/pallas_convbn.py:156).
// It computes, for NHWC x (N,H,W,Ci) and w (Co,Ci,KH,KW):
//
//   u  = act_in ? relu(x * in_scale + in_bias) cast to x's type : x
//        (zero padding is applied AFTER the affine: taps outside the image
//        read exactly 0, never relu(in_bias))
//   y  = conv(u, w), accumulated in fp32, stored in x's type
//   s1 = sum_{n,h,w} y,  s2 = sum_{n,h,w} (y - shift)^2, in fp32, taken
//        from the STORED (cast) y; the wrapper returns zeros when
//        want_stats is off.
//
// Design: an implicit GEMM.  The output is the matrix (M = N*Ho*Wo) x Co;
// one block computes a BM x BN tile of it and walks the reduction
// K = KH*KW*Ci as a loop over taps and BK-wide Ci chunks.  The affine+ReLU
// is applied while the x tile is loaded into shared memory, so the
// normalised activation never exists in device memory (the point of the
// TPU kernel too).  bf16 multiplies on the tensor cores through WMMA
// (mma.sync, 16x16x16, fp32 accumulators); fp32 runs on the FMA units
// (tensor cores would round fp32 to TF32).
//
// Statistics: the TPU kernel carries s1/s2 across a sequential grid in
// VMEM.  Hopper blocks run in no fixed order, so each block writes its
// per-channel partial sums over its rows (summed in row order) into an
// fp32 scratch of shape (m_blocks, Co), and a second small kernel sums
// those partials over m-blocks in ascending order.  The result is
// deterministic from run to run.
//
// Bound on one H100 SXM (3.35 TB/s, 989 TFLOP/s dense bf16): at ResNet-50's
// stage-1 shapes the 1x1 convs are memory-bound (64->256 at N=32, 56x56:
// 3.3 GFLOP against ~64 MB of x+y, ~19 us of bytes vs ~3.3 us of tensor-core
// time); the 3x3 convs are compute-bound (256->256 at 14x14, N=32:
// 7.4 GFLOP, ~7.5 us at 989 TFLOP/s).  This first version has no
// TMA/wgmma pipeline and no double buffering: it is written to be right,
// and its measured times stand beside these bounds in PERF.md.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace {

constexpr int BM = 128;        // output pixels per block
constexpr int BN = 64;         // output channels per block
constexpr int BK = 32;         // input channels per reduction step
constexpr int THREADS = 256;   // 8 warps
constexpr int A_LD = BK + 8;   // smem row pitches (elements), padded
constexpr int B_LD = BN + 8;
constexpr int C_LD = BN + 4;

struct Params {
  const void* x;
  const void* w;
  const float* in_scale;
  const float* in_bias;
  const float* shift;
  void* y;
  float* part1;
  float* part2;
  long long M;
  int H, W, Ci, Co, KH, KW, SH, SW, PH, PW, Ho, Wo;
  int act_in, want_stats, vec;
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

// eight consecutive elements, 16-byte aligned
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

template <typename T, bool TENSOR_CORES>
__global__ void __launch_bounds__(THREADS) fused_conv_unit_kernel(Params p) {
  constexpr int A_BYTES = BM * A_LD * (int)sizeof(T);
  constexpr int B_BYTES = BK * B_LD * (int)sizeof(T);
  constexpr int C_BYTES = BM * C_LD * (int)sizeof(float);
  constexpr int SMEM = (A_BYTES + B_BYTES > C_BYTES) ? (A_BYTES + B_BYTES) : C_BYTES;
  // the fp32 C tile reuses the A/B staging space after the K loop
  __shared__ __align__(128) unsigned char smem[SMEM];
  __shared__ long long row_base[BM];  // element offset of the row's image in x
  __shared__ int row_ih0[BM];         // top-left input coordinate of the window
  __shared__ int row_iw0[BM];

  T* sA = reinterpret_cast<T*>(smem);
  T* sB = reinterpret_cast<T*>(smem + A_BYTES);
  float* sC = reinterpret_cast<float*>(smem);

  const int tid = threadIdx.x;
  const long long m0 = (long long)blockIdx.x * BM;
  const int co0 = blockIdx.y * BN;
  const T* x = static_cast<const T*>(p.x);
  const T* w = static_cast<const T*>(p.w);

  if (tid < BM) {
    const long long m = m0 + tid;
    if (m < p.M) {
      const int hw = p.Ho * p.Wo;
      const long long n = m / hw;
      const int rem = (int)(m - n * hw);
      const int oh = rem / p.Wo;
      const int ow = rem - oh * p.Wo;
      row_base[tid] = n * (long long)p.H * p.W * p.Ci;
      row_ih0[tid] = oh * p.SH - p.PH;
      row_iw0[tid] = ow * p.SW - p.PW;
    } else {  // rows past M: every tap falls outside, the row stays 0
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

  const int khw = p.KH * p.KW;
  for (int ky = 0; ky < p.KH; ++ky) {
    for (int kx = 0; kx < p.KW; ++kx) {
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
              if (p.vec && ci0 + c + 8 <= p.Ci) {
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
        // ---- B tile (BK x BN): w[co, ci, ky, kx], ci fastest across a warp
        {
          const int k = tid & 31;
          const int ci = ci0 + k;
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const int n = (tid >> 5) + 8 * j;
            const int co = co0 + n;
            T v = from_f<T>(0.0f);
            if (ci < p.Ci && co < p.Co) v = w[((long long)co * p.Ci + ci) * khw + ky * p.KW + kx];
            sB[k * B_LD + n] = v;
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
    const long long m = m0 + r;
    const int co = co0 + c;
    const T yc = from_f<T>(sC[r * C_LD + c]);
    if (m < p.M && co < p.Co) y[m * p.Co + co] = yc;
    sC[r * C_LD + c] = to_f<T>(yc);
  }
  if (!p.want_stats) return;
  __syncthreads();
  if (tid < BN) {
    const int co = co0 + tid;
    if (co < p.Co) {
      const float sh = p.shift[co];
      const long long left = p.M - m0;
      const int rows = left < BM ? (int)left : BM;
      float a1 = 0.0f, a2 = 0.0f;
      for (int r = 0; r < rows; ++r) {
        const float v = sC[r * C_LD + tid];
        const float d = v - sh;
        a1 += v;
        a2 = fmaf(d, d, a2);
      }
      p.part1[(long long)blockIdx.x * p.Co + co] = a1;
      p.part2[(long long)blockIdx.x * p.Co + co] = a2;
    }
  }
}

// s1/s2[co] = sum over m-blocks, in ascending block order
__global__ void reduce_stats_kernel(const float* part1, const float* part2, int m_blocks, int co_n,
                                    float* s1, float* s2) {
  const int co = blockIdx.x * blockDim.x + threadIdx.x;
  if (co >= co_n) return;
  float a1 = 0.0f, a2 = 0.0f;
  for (int b = 0; b < m_blocks; ++b) {
    a1 += part1[(long long)b * co_n + co];
    a2 += part2[(long long)b * co_n + co];
  }
  s1[co] = a1;
  s2[co] = a2;
}

}  // namespace

extern "C" {

// rows of M per block: the wrapper sizes the (m_blocks, Co) scratch with it
int mx_fused_conv_unit_block_m(void) { return BM; }

const char* mx_cuda_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

// dtype: 0 = float32, 1 = bfloat16.  part1/part2 are (ceil(M/BM), Co) fp32
// scratch and s1/s2 (Co) fp32 outputs; all four are ignored when
// want_stats is 0.  Launches on `stream`, never synchronises, and returns
// cudaGetLastError() after the launches (0 = success).
int mx_fused_conv_unit(int dtype, const void* x, const void* w, const void* in_scale,
                       const void* in_bias, const void* shift, void* y, void* part1, void* part2,
                       void* s1, void* s2, int N, int H, int W, int Ci, int Co, int KH, int KW,
                       int SH, int SW, int PH, int PW, int act_in, int want_stats, int vec,
                       void* stream) {
  Params p;
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
  p.M = (long long)N * p.Ho * p.Wo;
  p.act_in = act_in;
  p.want_stats = want_stats;
  p.vec = vec;
  if (p.M <= 0 || Co <= 0 || p.Ho <= 0 || p.Wo <= 0) return (int)cudaErrorInvalidValue;
  const long long m_blocks = (p.M + BM - 1) / BM;
  const int n_blocks = (Co + BN - 1) / BN;
  if (m_blocks > 0x7fffffffLL || n_blocks > 65535) return (int)cudaErrorInvalidConfiguration;
  const dim3 grid((unsigned)m_blocks, (unsigned)n_blocks);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    fused_conv_unit_kernel<__nv_bfloat16, true><<<grid, THREADS, 0, s>>>(p);
  } else if (dtype == 0) {
    fused_conv_unit_kernel<float, false><<<grid, THREADS, 0, s>>>(p);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || !want_stats) return (int)err;
  reduce_stats_kernel<<<(Co + 255) / 256, 256, 0, s>>>(p.part1, p.part2, (int)m_blocks, Co,
                                                        static_cast<float*>(s1),
                                                        static_cast<float*>(s2));
  return (int)cudaGetLastError();
}

}  // extern "C"
