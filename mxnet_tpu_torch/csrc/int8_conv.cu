// int8 x int8 -> int32 convolution (implicit GEMM) for Hopper.
//
// Replaces no TPU kernel: the reference package computes `quantized_conv`
// and `quantized_fully_connected` with the lax convolution and dot at an
// int32 accumulator type, which the TPU's matrix unit runs natively, and
// PyTorch has no int8 convolution on CUDA.  So this kernel was written for
// the port's quantized inference path (`contrib.quantization` rewrites
// every Convolution and FullyConnected into it).
//
// It computes, for x NHWC int8 (N, H, W, C) and w int8 laid out by the
// wrapper as (G, Cog, Kpad) with K = KH*KW*Cig ordered (kh, kw, ci) and
// zero-padded to Kpad (a multiple of 64):
//
//   y[n, g*Cog + co, ho, wo] = sum_{kh, kw, ci} x[n, hi, wi, g*Cig + ci]
//                                               * w[g, co, (kh, kw, ci)]
//   hi = ho*sh - ph + kh*dh,  wi = wo*sw - pw + kw*dw  (outside: 0)
//
// every product exact and summed exactly in int32 (mma.sync s8 with s32
// accumulation), so any order gives the same bits.  y is written through
// four strides, so the wrapper gets NCHW or NHWC without a transpose.
//
// What bounds it on one H100 SXM (1979 TOP/s dense int8, 3.35 TB/s): the
// 3x3 layers of ResNet-50 from 28x28 down by operations, its 1x1 layers and
// the stem by bytes (the int32 output is 4 bytes an element).  This first
// version uses the pre-Hopper tensor-core path (mma.sync m16n8k32), which
// reaches about half of the int8 peak at best; wgmma and TMA come later.
//
// Design: the output is the matrix (M = N*Ho*Wo) x Cog for each group, cut
// into 128 x 64 tiles, one block of 4 warps a tile (each warp 64 x 32: 4 x 4
// mma tiles, 64 int32 accumulators a thread).  K is walked in steps of 64
// bytes through a 3-stage ring of shared-memory tiles.  Where Cig and C are
// multiples of 16 (every layer of ResNet-50 but the stem) a 16-byte chunk of
// K lies inside one tap, and the A tile is filled by cp.async with zero fill
// for padding taps and ragged rows; otherwise (the stem's Ci = 3, grouped
// and depthwise layers with few channels a group) each thread gathers its
// row byte by byte, zero for K's padding.  Shared tiles are XOR-swizzled by
// 16-byte chunk so that ldmatrix reads them without bank conflicts.  It
// launches on the caller's stream and never synchronises.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 128;
constexpr int BN = 64;
constexpr int BK = 64;       // bytes of K a stage
constexpr int STAGES = 3;
constexpr int THREADS = 128;

struct Params {
  const int8_t* x;
  const int8_t* w;
  int32_t* y;
  int N, H, W, C, Ho, Wo, G, Cig, Cog, kh, kw, sh, sw, ph, pw, dh, dw, K,
      Kpad, M;
  long long ysN, ysC, ysH, ysW;
};

// byte offset of 16-byte chunk `c` (0..3) of row `r` in a [rows][64] tile
__device__ __forceinline__ int swz(int r, int c) {
  return r * BK + ((c ^ ((r >> 1) & 3)) << 4);
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool pred) {
  unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  int n = pred ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(n));
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldsm_x4(unsigned* r, const void* p) {
  unsigned s = (unsigned)__cvta_generic_to_shared(p);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s));
}

__device__ __forceinline__ void mma_s8(int* c, const unsigned* a,
                                       const unsigned* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

template <bool VEC>
__global__ void __launch_bounds__(THREADS)
int8_conv_kernel(const Params p) {
  __shared__ __align__(128) int8_t As[STAGES][BM * BK];
  __shared__ __align__(128) int8_t Bs[STAGES][BN * BK];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int warp_m = warp & 1;   // 64 rows each
  const int warp_n = warp >> 1;  // 32 columns each
  const int g = blockIdx.z;
  const int m_tile = blockIdx.x * BM;
  const int n_tile = blockIdx.y * BN;
  const int hw_out = p.Ho * p.Wo;
  const long long cbase = (long long)g * p.Cig;

  // A rows this thread fills: VEC: rows (tid >> 2) + 32 i, chunk tid & 3;
  // bytewise: row tid, all 64 bytes
  constexpr int AROWS = VEC ? 4 : 1;
  int a_h[AROWS], a_w[AROWS];
  long long a_base[AROWS];
#pragma unroll
  for (int i = 0; i < AROWS; ++i) {
    const int r = VEC ? (tid >> 2) + 32 * i : tid;
    const int m = m_tile + r;
    if (m < p.M) {
      const int n = m / hw_out;
      const int rem = m - n * hw_out;
      const int ho = rem / p.Wo;
      const int wo = rem - ho * p.Wo;
      a_h[i] = ho * p.sh - p.ph;
      a_w[i] = wo * p.sw - p.pw;
      a_base[i] = (long long)n * p.H * p.W * p.C + cbase;
    } else {
      a_h[i] = -(1 << 28);  // every tap lands outside the image
      a_w[i] = 0;
      a_base[i] = 0;
    }
  }
  const int a_chunk = tid & 3;
  const int b_chunk = tid & 3;
  const int8_t* wg = p.w + (long long)g * p.Cog * p.Kpad;

  auto load_stage = [&](int stage, int kb) {
    int8_t* as = As[stage];
    int8_t* bs = Bs[stage];
    const int k0 = kb * BK;
    if constexpr (VEC) {
      const int k = k0 + a_chunk * 16;
      int tap = k / p.Cig;
      const int ci = k - tap * p.Cig;
      const int r_ = tap / p.kw;
      const int s_ = tap - r_ * p.kw;
      const bool kin = k < p.K;
#pragma unroll
      for (int i = 0; i < AROWS; ++i) {
        const int r = (tid >> 2) + 32 * i;
        const int hi = a_h[i] + r_ * p.dh;
        const int wi = a_w[i] + s_ * p.dw;
        const bool ok = kin && hi >= 0 && hi < p.H && wi >= 0 && wi < p.W;
        const int8_t* src =
            ok ? p.x + a_base[i] + ((long long)hi * p.W + wi) * p.C + ci : p.x;
        cp_async16(as + swz(r, a_chunk), src, ok);
      }
    } else {
      // decompose k0 once, then step through the 64 bytes
      int tap = k0 / p.Cig;
      int ci = k0 - tap * p.Cig;
      int r_ = tap / p.kw;
      int s_ = tap - r_ * p.kw;
      const int r = tid;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        unsigned words[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          unsigned word = 0;
#pragma unroll
          for (int b = 0; b < 4; ++b) {
            const int k = k0 + c * 16 + q * 4 + b;
            int v = 0;
            if (k < p.K) {
              const int hi = a_h[0] + r_ * p.dh;
              const int wi = a_w[0] + s_ * p.dw;
              if (hi >= 0 && hi < p.H && wi >= 0 && wi < p.W)
                v = (int)__ldg(p.x + a_base[0] +
                               ((long long)hi * p.W + wi) * p.C + ci);
            }
            word |= ((unsigned)v & 0xffu) << (8 * b);
            if (++ci == p.Cig) {
              ci = 0;
              if (++s_ == p.kw) {
                s_ = 0;
                ++r_;
              }
            }
          }
          words[q] = word;
        }
        *reinterpret_cast<uint4*>(as + swz(r, c)) =
            make_uint4(words[0], words[1], words[2], words[3]);
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = (tid >> 2) + 32 * i;
      const int co = n_tile + r;
      const bool ok = co < p.Cog;
      const int8_t* src =
          ok ? wg + (long long)co * p.Kpad + k0 + b_chunk * 16 : p.w;
      cp_async16(bs + swz(r, b_chunk), src, ok);
    }
  };

  int acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[i][j][q] = 0;

  const int kblocks = p.Kpad / BK;
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < kblocks) load_stage(s, s);
    cp_commit();
  }

  for (int kb = 0; kb < kblocks; ++kb) {
    cp_wait<STAGES - 2>();
    __syncthreads();
    {
      const int nk = kb + STAGES - 1;
      if (nk < kblocks) load_stage(nk % STAGES, nk);
      cp_commit();
    }
    const int8_t* as = As[kb % STAGES];
    const int8_t* bs = Bs[kb % STAGES];
#pragma unroll
    for (int kk = 0; kk < 2; ++kk) {  // two k32 steps a stage
      unsigned af[4][4];
      unsigned bf[4][2];
#pragma unroll
      for (int mi = 0; mi < 4; ++mi) {
        const int r = warp_m * 64 + mi * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
        const int c = kk * 2 + (lane >> 4);
        ldsm_x4(af[mi], as + swz(r, c));
      }
#pragma unroll
      for (int nj = 0; nj < 2; ++nj) {
        const int r = warp_n * 32 + nj * 16 + (lane & 7) + (lane >> 4) * 8;
        const int c = kk * 2 + ((lane >> 3) & 1);
        unsigned t[4];
        ldsm_x4(t, bs + swz(r, c));
        bf[nj * 2][0] = t[0];
        bf[nj * 2][1] = t[1];
        bf[nj * 2 + 1][0] = t[2];
        bf[nj * 2 + 1][1] = t[3];
      }
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) mma_s8(acc[mi][ni], af[mi], bf[ni]);
    }
  }
  cp_wait<0>();

  // epilogue: c0, c1 at (row lane/4, cols 2(lane%4) + {0, 1}); c2, c3 eight
  // rows below
  const int gid = lane >> 2;
  const int tig = lane & 3;
#pragma unroll
  for (int mi = 0; mi < 4; ++mi) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int m = m_tile + warp_m * 64 + mi * 16 + gid + half * 8;
      if (m >= p.M) continue;
      const int n = m / hw_out;
      const int rem = m - n * hw_out;
      const int ho = rem / p.Wo;
      const int wo = rem - ho * p.Wo;
      int32_t* yrow = p.y + n * p.ysN + ho * p.ysH + wo * p.ysW;
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int co = n_tile + warp_n * 32 + ni * 8 + tig * 2 + e;
          if (co < p.Cog)
            yrow[((long long)g * p.Cog + co) * p.ysC] =
                acc[mi][ni][half * 2 + e];
        }
      }
    }
  }
}

}  // namespace

extern "C" {

// x: NHWC int8 (N, H, W, C), contiguous, 16-byte aligned.  w: int8 (G, Cog,
// Kpad), contiguous, K ordered (kh, kw, ci) and zero past K = kh*kw*Cig;
// Kpad % 64 == 0.  y: int32, element (n, co, ho, wo) at n*ysN + co*ysC +
// ho*ysH + wo*ysW.  Launches on `stream`; returns cudaGetLastError() after
// the launch (cudaErrorInvalidValue for a shape it does not take).
int mx_int8_conv(const void* x, const void* w, void* y, int N, int H, int W,
                 int C, int Ho, int Wo, int Co, int G, int kh, int kw, int sh,
                 int sw, int ph, int pw, int dh, int dw, int Kpad,
                 long long ysN, long long ysC, long long ysH, long long ysW,
                 void* stream) {
  if (G <= 0 || C % G != 0 || Co % G != 0 || Kpad % BK != 0 || N <= 0 ||
      Ho <= 0 || Wo <= 0 || G > 65535)
    return (int)cudaErrorInvalidValue;
  Params p;
  p.x = (const int8_t*)x;
  p.w = (const int8_t*)w;
  p.y = (int32_t*)y;
  p.N = N; p.H = H; p.W = W; p.C = C; p.Ho = Ho; p.Wo = Wo; p.G = G;
  p.Cig = C / G; p.Cog = Co / G; p.kh = kh; p.kw = kw; p.sh = sh; p.sw = sw;
  p.ph = ph; p.pw = pw; p.dh = dh; p.dw = dw;
  p.K = kh * kw * p.Cig; p.Kpad = Kpad;
  long long m = (long long)N * Ho * Wo;
  if (m > 0x7fffffffLL || p.K > Kpad || (long long)N * H * W * C > (1LL << 40))
    return (int)cudaErrorInvalidValue;
  p.M = (int)m;
  p.ysN = ysN; p.ysC = ysC; p.ysH = ysH; p.ysW = ysW;
  long long gy = (p.Cog + BN - 1) / BN;
  if (gy > 65535) return (int)cudaErrorInvalidValue;
  dim3 grid((unsigned)((m + BM - 1) / BM), (unsigned)gy, (unsigned)G);
  cudaStream_t s = (cudaStream_t)stream;
  const bool vec = p.Cig % 16 == 0 && C % 16 == 0 &&
                   ((uintptr_t)x & 15) == 0 && ((uintptr_t)w & 15) == 0;
  if (vec)
    int8_conv_kernel<true><<<grid, THREADS, 0, s>>>(p);
  else
    int8_conv_kernel<false><<<grid, THREADS, 0, s>>>(p);
  return (int)cudaGetLastError();
}

}  // extern "C"
