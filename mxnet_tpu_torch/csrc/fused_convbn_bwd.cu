// Backward of the fused (input affine + ReLU) -> conv -> (BN statistics)
// unit, for Hopper, stride 1 only.
//
// Replaces the TPU kernel `_pallas_unit_bwd` (mxnet_tpu/ops/pallas_convbn.py:283).
// Given the forward's inputs x (N,H,W,Ci), w (Co,Ci,KH,KW), in_scale,
// in_bias, shift, its output y (N,Ho,Wo,Co) and the cotangents gy (like y),
// gs1, gs2 (Co), it computes:
//
//   dy  = want_stats ? gy + gs1 + 2(y - shift)·gs2 (fp32, op by op) : gy,
//         CAST TO gy's TYPE before it enters either product
//   u   = act_in ? relu(x·in_scale + in_bias) cast to x's type : x, with
//         exact zeros for padding taps (the padding comes AFTER the affine)
//   du  = dgrad: du[n,ih,iw,ci] = Σ_{ky,kx,co} dy[n,ih+PH-ky,iw+PW-kx,co]·w[co,ci,ky,kx]
//   dw  = wgrad: dw[co,ci,ky,kx] = Σ_{n,oh,ow} u[n,oh+ky-PH,ow+kx-PW,ci]·dy[n,oh,ow,co]
//   act_in:  gu = du where (x·in_scale + in_bias) > 0 else 0,
//            gx = gu·in_scale, gscale = Σ gu·x, gbias = Σ gu  (x in fp32)
//   !act_in: gx = du, gscale = gbias = 0 (the wrapper's zeros)
//
// du and dw accumulate in fp32; gx leaves in x's type, dw in w's type,
// gscale and gbias in fp32.
//
// Design: two implicit GEMMs and two deterministic reduction passes.
//  * dgrad is a GEMM over (M_in = N·H·W) x Ci with K = KH·KW·Co: a stride-1
//    transpose convolution, where each input pixel gathers dy from the
//    output pixels its taps reach (taps that leave the output are skipped).
//    dy is folded on the fly in the A-tile load, so dy_tot never exists in
//    device memory.  The epilogue recomputes the pre-ReLU affine (with
//    __fmul_rn/__fadd_rn, as the forward kernel), masks, writes gx, and
//    writes per-block fp32 partial sums of gscale and gbias over its rows.
//  * wgrad is a GEMM over (KH·KW·Ci) x Co with K = N·Ho·Wo, a reduction
//    over the whole batch.  The TPU kernel carries dw in VMEM across a
//    sequential grid; Hopper blocks run in no order, so K is split across
//    blocks (grid.z) into fp32 partials that a second pass sums in split
//    order and writes transposed to (Co,Ci,KH,KW).  No atomics: the bits
//    are the same on every run.  u is recomputed from x in the A-tile load.
//  bf16 multiplies on the tensor cores (WMMA 16x16x16, fp32 accumulators);
//  fp32 runs on the FMA units (tensor cores would round it to TF32).
//
// Bound on one H100 SXM: the backward does twice the forward's FLOPs
// (2·M·Co·K each for dgrad and wgrad) and moves x, y, gy, gx, w and dw.
// ResNet-50's 3x3 units are bound by operations (e.g. 256->256 at 14x14,
// N=32: 14.8 GFLOP, ~15 us at 989 TFLOP/s), its 1x1 units by bytes.  This
// first version has no TMA, no wgmma and no double buffering; its times
// stand beside these bounds in PERF.md.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace {

// dgrad tile: BM input pixels x BN input channels, K steps of BK output channels
constexpr int BM = 128;
constexpr int BN = 64;
constexpr int BK = 32;
constexpr int THREADS = 256;
constexpr int A_LD = BK + 8;
constexpr int B_LD = BN + 8;
constexpr int C_LD = BN + 4;
// wgrad tile: WM input channels x WN output channels, K steps of WK pixels
constexpr int WM = 64;
constexpr int WN = 64;
constexpr int WK = 32;
constexpr int WTHREADS = 128;
constexpr int WA_LD = WM + 8;  // A stored column-major: sA[k * WA_LD + i]
constexpr int WB_LD = WN + 8;
constexpr int WC_LD = WN + 4;
constexpr int TARGET_BLOCKS = 4 * 132;  // wgrad blocks to aim for (132 SMs)

struct Params {
  const void* x;
  const void* w;
  const float* in_scale;
  const float* in_bias;
  const float* shift;
  const void* y;
  const void* gy;
  const float* gs1;
  const float* gs2;
  void* gx;
  float* gpart;   // (2, m_blocks, Ci): gscale partials, then gbias partials
  float* wpart;   // (splits, KH*KW*Ci, Co)
  long long M_in, M_out, chunks_per_split;
  int H, W, Ci, Co, KH, KW, PH, PW, Ho, Wo;
  int act_in, want_stats, vec_ci, vec_co;
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

// up to eight elements src[0..8) of a row of `len` starting at `c`; zeros past it
template <typename T>
__device__ __forceinline__ void load_row8(const T* src, int c, int len, int vec, float* v) {
  if (vec && c + 8 <= len) {
    load8<T>(src, v);
  } else {
#pragma unroll
    for (int j = 0; j < 8; ++j) v[j] = (c + j < len) ? to_f<T>(src[j]) : 0.0f;
  }
}

// dy of output pixel `pix` (-1: outside the output, zeros), channels co..co+8,
// folded in fp32 op by op and rounded to T, as the plain version rounds it
template <typename T>
__device__ __forceinline__ void load_dy8(const Params& p, long long pix, int co, T* dst) {
  float g[8];
  if (pix < 0) {
#pragma unroll
    for (int j = 0; j < 8; ++j) dst[j] = from_f<T>(0.0f);
    return;
  }
  const long long off = pix * p.Co + co;
  load_row8<T>(static_cast<const T*>(p.gy) + off, co, p.Co, p.vec_co, g);
  if (p.want_stats) {
    float yv[8];
    load_row8<T>(static_cast<const T*>(p.y) + off, co, p.Co, p.vec_co, yv);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c = co + j;
      if (c < p.Co) {
        const float t1 = __fadd_rn(g[j], p.gs1[c]);
        const float t2 = __fmul_rn(__fmul_rn(2.0f, __fsub_rn(yv[j], p.shift[c])), p.gs2[c]);
        g[j] = __fadd_rn(t1, t2);
      }
    }
  }
#pragma unroll
  for (int j = 0; j < 8; ++j) dst[j] = from_f<T>(g[j]);
}

// ---------------------------------------------------------------------------
// dgrad: du over (M_in x Ci), epilogue gx + gscale/gbias partials
// ---------------------------------------------------------------------------
template <typename T, bool TENSOR_CORES>
__global__ void __launch_bounds__(THREADS) dgrad_kernel(Params p) {
  constexpr int A_BYTES = BM * A_LD * (int)sizeof(T);
  constexpr int B_BYTES = BK * B_LD * (int)sizeof(T);
  constexpr int C_BYTES = BM * C_LD * (int)sizeof(float);
  constexpr int SMEM = (A_BYTES + B_BYTES > C_BYTES) ? (A_BYTES + B_BYTES) : C_BYTES;
  __shared__ __align__(128) unsigned char smem[SMEM];
  __shared__ long long row_obase[BM];  // output-pixel index of the row's image
  __shared__ int row_ih[BM];
  __shared__ int row_iw[BM];

  T* sA = reinterpret_cast<T*>(smem);
  T* sB = reinterpret_cast<T*>(smem + A_BYTES);
  float* sC = reinterpret_cast<float*>(smem);

  const int tid = threadIdx.x;
  const long long m0 = (long long)blockIdx.x * BM;
  const int ci0 = blockIdx.y * BN;
  const T* w = static_cast<const T*>(p.w);
  const int khw = p.KH * p.KW;

  if (tid < BM) {
    const long long m = m0 + tid;
    if (m < p.M_in) {
      const int hw = p.H * p.W;
      const long long n = m / hw;
      const int rem = (int)(m - n * hw);
      row_ih[tid] = rem / p.W;
      row_iw[tid] = rem - row_ih[tid] * p.W;
      row_obase[tid] = n * (long long)p.Ho * p.Wo;
    } else {  // rows past M_in reach no output pixel
      row_ih[tid] = -(1 << 29);
      row_iw[tid] = -(1 << 29);
      row_obase[tid] = 0;
    }
  }
  __syncthreads();

  const int warp = tid >> 5;
  const int wm = warp >> 1;  // tensor cores: warp tile rows wm*32..+32
  const int wn = warp & 1;   //               warp tile cols wn*32..+32
  const int ty = tid >> 4;   // FMA: rows ty*8..+8
  const int tx = tid & 15;   //      cols tx*4..+4

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
      for (int co0 = 0; co0 < p.Co; co0 += BK) {
        // ---- A tile (BM x BK): dy at the output pixel this tap reaches
        {
          const int c = (tid & 3) * 8;
#pragma unroll
          for (int rr = 0; rr < 2; ++rr) {
            const int r = (tid >> 2) + rr * 64;
            const int oh = row_ih[r] + p.PH - ky;
            const int ow = row_iw[r] + p.PW - kx;
            const long long pix = (oh >= 0 && oh < p.Ho && ow >= 0 && ow < p.Wo)
                                      ? row_obase[r] + (long long)oh * p.Wo + ow
                                      : -1;
            load_dy8<T>(p, pix, co0 + c, sA + r * A_LD + c);
          }
        }
        // ---- B tile (BK x BN): w[co0+k, ci0+j, ky, kx], ci fastest across threads
        {
          const int j = tid & 63;
          const int ci = ci0 + j;
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            const int k = (tid >> 6) + 4 * i;
            const int co = co0 + k;
            T v = from_f<T>(0.0f);
            if (ci < p.Ci && co < p.Co) v = w[((long long)co * p.Ci + ci) * khw + ky * p.KW + kx];
            sB[k * B_LD + j] = v;
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

  // ---- epilogue: du -> smem; gx; gu kept in smem for the channel sums
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

  const T* x = static_cast<const T*>(p.x);
  T* gx = static_cast<T*>(p.gx);
  for (int e = tid; e < BM * BN; e += THREADS) {
    const int r = e / BN;
    const int c = e - r * BN;
    const long long m = m0 + r;
    const int ci = ci0 + c;
    if (m >= p.M_in || ci >= p.Ci) continue;
    const float du = sC[r * C_LD + c];
    if (p.act_in) {
      const float sc = p.in_scale[ci];
      const float uf = __fadd_rn(__fmul_rn(to_f<T>(x[m * p.Ci + ci]), sc), p.in_bias[ci]);
      const float gu = uf > 0.0f ? du : 0.0f;
      gx[m * p.Ci + ci] = from_f<T>(__fmul_rn(gu, sc));
      sC[r * C_LD + c] = gu;
    } else {
      gx[m * p.Ci + ci] = from_f<T>(du);
    }
  }
  if (!p.act_in) return;
  __syncthreads();
  if (tid < BN) {
    const int ci = ci0 + tid;
    if (ci < p.Ci) {
      const long long left = p.M_in - m0;
      const int rows = left < BM ? (int)left : BM;
      float a1 = 0.0f, a2 = 0.0f;
      for (int r = 0; r < rows; ++r) {
        const float gu = sC[r * C_LD + tid];
        a1 += __fmul_rn(gu, to_f<T>(x[(m0 + r) * p.Ci + ci]));
        a2 += gu;
      }
      const long long mb = gridDim.x;
      p.gpart[(long long)blockIdx.x * p.Ci + ci] = a1;
      p.gpart[(mb + blockIdx.x) * p.Ci + ci] = a2;
    }
  }
}

// ---------------------------------------------------------------------------
// wgrad: fp32 partials of dw over (KH*KW*Ci x Co), one K range per grid.z
// ---------------------------------------------------------------------------
template <typename T, bool TENSOR_CORES>
__global__ void __launch_bounds__(WTHREADS) wgrad_kernel(Params p) {
  constexpr int A_BYTES = WK * WA_LD * (int)sizeof(T);
  constexpr int B_BYTES = WK * WB_LD * (int)sizeof(T);
  constexpr int C_BYTES = WM * WC_LD * (int)sizeof(float);
  constexpr int SMEM = (A_BYTES + B_BYTES > C_BYTES) ? (A_BYTES + B_BYTES) : C_BYTES;
  __shared__ __align__(128) unsigned char smem[SMEM];
  T* sA = reinterpret_cast<T*>(smem);  // column-major A: sA[k * WA_LD + i]
  T* sB = reinterpret_cast<T*>(smem + A_BYTES);
  float* sC = reinterpret_cast<float*>(smem);

  const int tid = threadIdx.x;
  const int ci_blocks = (p.Ci + WM - 1) / WM;
  const int tap = blockIdx.x / ci_blocks;
  const int ci0 = (blockIdx.x - tap * ci_blocks) * WM;
  const int ky = tap / p.KW;
  const int kx = tap - ky * p.KW;
  const int co0 = blockIdx.y * WN;
  const long long chunks = (p.M_out + WK - 1) / WK;
  const long long c_begin = (long long)blockIdx.z * p.chunks_per_split;
  long long c_end = c_begin + p.chunks_per_split;
  if (c_end > chunks) c_end = chunks;
  const T* x = static_cast<const T*>(p.x);
  const int hwo = p.Ho * p.Wo;

  const int warp = tid >> 5;
  const int wm = warp >> 1;
  const int wn = warp & 1;
  const int ty = tid >> 4;  // FMA: rows ty*8..+8
  const int tx = tid & 15;  //      cols tx*4..+4

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

  const int c8 = (tid & 7) * 8;
  for (long long chunk = c_begin; chunk < c_end; ++chunk) {
    const long long q0 = chunk * WK;
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const int k = (tid >> 3) + 16 * rr;
      const long long q = q0 + k;
      long long pix = -1;      // output pixel for the dy row
      long long xoff = -1;     // x offset of the input pixel this tap reads
      if (q < p.M_out) {
        pix = q;
        const long long n = q / hwo;
        const int rem = (int)(q - n * hwo);
        const int oh = rem / p.Wo;
        const int ow = rem - oh * p.Wo;
        const int ih = oh + ky - p.PH;
        const int iw = ow + kx - p.PW;
        if (ih >= 0 && ih < p.H && iw >= 0 && iw < p.W)
          xoff = ((n * p.H + ih) * (long long)p.W + iw) * p.Ci;
      }
      // ---- A: u[q, ci0+c8..+8] (padding taps and rows past M_out: exact zeros)
      float v[8];
      if (xoff >= 0) {
        const int ci = ci0 + c8;
        load_row8<T>(x + xoff + ci, ci, p.Ci, p.vec_ci, v);
        if (p.act_in) {
#pragma unroll
          for (int j = 0; j < 8; ++j)
            if (ci + j < p.Ci)
              v[j] = fmaxf(__fadd_rn(__fmul_rn(v[j], p.in_scale[ci + j]), p.in_bias[ci + j]), 0.0f);
        }
      } else {
#pragma unroll
        for (int j = 0; j < 8; ++j) v[j] = 0.0f;
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) sA[k * WA_LD + c8 + j] = from_f<T>(v[j]);
      // ---- B: dy[q, co0+c8..+8]
      load_dy8<T>(p, pix, co0 + c8, sB + k * WB_LD + c8);
    }
    __syncthreads();

    if constexpr (TENSOR_CORES) {
#pragma unroll
      for (int kk = 0; kk < WK; kk += 16) {
        nvcuda::wmma::fragment<nvcuda::wmma::matrix_a, 16, 16, 16, T, nvcuda::wmma::col_major> a[2];
        nvcuda::wmma::fragment<nvcuda::wmma::matrix_b, 16, 16, 16, T, nvcuda::wmma::row_major> b[2];
#pragma unroll
        for (int i = 0; i < 2; ++i)
          nvcuda::wmma::load_matrix_sync(a[i], sA + kk * WA_LD + wm * 32 + i * 16, WA_LD);
#pragma unroll
        for (int j = 0; j < 2; ++j)
          nvcuda::wmma::load_matrix_sync(b[j], sB + kk * WB_LD + wn * 32 + j * 16, WB_LD);
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int j = 0; j < 2; ++j) nvcuda::wmma::mma_sync(acc[i][j], a[i], b[j], acc[i][j]);
      }
    } else {
#pragma unroll 4
      for (int kk = 0; kk < WK; ++kk) {
        float a[8], b[4];
#pragma unroll
        for (int i = 0; i < 8; ++i) a[i] = to_f<T>(sA[kk * WA_LD + ty * 8 + i]);
#pragma unroll
        for (int j = 0; j < 4; ++j) b[j] = to_f<T>(sB[kk * WB_LD + tx * 4 + j]);
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) facc[i][j] = fmaf(a[i], b[j], facc[i][j]);
      }
    }
    __syncthreads();
  }

  if constexpr (TENSOR_CORES) {
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j)
        nvcuda::wmma::store_matrix_sync(sC + (wm * 32 + i * 16) * WC_LD + wn * 32 + j * 16, acc[i][j],
                                        WC_LD, nvcuda::wmma::mem_row_major);
  } else {
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sC[(ty * 8 + i) * WC_LD + tx * 4 + j] = facc[i][j];
  }
  __syncthreads();
  // every split writes its partial, an empty K range included (zeros)
  const long long rows_total = (long long)p.KH * p.KW * p.Ci;
  float* dst = p.wpart + (long long)blockIdx.z * rows_total * p.Co;
  for (int e = tid; e < WM * WN; e += WTHREADS) {
    const int r = e / WN;
    const int c = e - r * WN;
    const int ci = ci0 + r;
    const int co = co0 + c;
    if (ci < p.Ci && co < p.Co)
      dst[((long long)tap * p.Ci + ci) * p.Co + co] = sC[r * WC_LD + c];
  }
}

// dw[co,ci,ky,kx] = sum over splits, in split order, of wpart[s, tap, ci, co]
template <typename T>
__global__ void wgrad_reduce_kernel(const float* wpart, int splits, int khw, int ci_n, int co_n, T* dw) {
  const long long total = (long long)khw * ci_n * co_n;
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= total) return;
  float a = 0.0f;
  for (int s = 0; s < splits; ++s) a += wpart[(long long)s * total + e];
  const int co = (int)(e % co_n);
  const long long rest = e / co_n;
  const int ci = (int)(rest % ci_n);
  const int tap = (int)(rest / ci_n);
  dw[((long long)co * ci_n + ci) * khw + tap] = from_f<T>(a);
}

// gscale/gbias[ci] = sum over m-blocks, in ascending block order
__global__ void channel_reduce_kernel(const float* gpart, int m_blocks, int ci_n, float* gscale,
                                      float* gbias) {
  const int ci = blockIdx.x * blockDim.x + threadIdx.x;
  if (ci >= ci_n) return;
  float a1 = 0.0f, a2 = 0.0f;
  const long long second = (long long)m_blocks * ci_n;
  for (int b = 0; b < m_blocks; ++b) {
    a1 += gpart[(long long)b * ci_n + ci];
    a2 += gpart[second + (long long)b * ci_n + ci];
  }
  gscale[ci] = a1;
  gbias[ci] = a2;
}

template <typename T, bool TC>
int launch_all(const Params& p, long long m_blocks, int splits, void* dw, void* gscale, void* gbias,
               cudaStream_t s) {
  const dim3 dgrid((unsigned)m_blocks, (unsigned)((p.Ci + BN - 1) / BN));
  dgrad_kernel<T, TC><<<dgrid, THREADS, 0, s>>>(p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  if (p.act_in) {
    channel_reduce_kernel<<<(p.Ci + 255) / 256, 256, 0, s>>>(p.gpart, (int)m_blocks, p.Ci,
                                                             static_cast<float*>(gscale),
                                                             static_cast<float*>(gbias));
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  const int khw = p.KH * p.KW;
  const dim3 wgrid((unsigned)(khw * ((p.Ci + WM - 1) / WM)), (unsigned)((p.Co + WN - 1) / WN),
                   (unsigned)splits);
  wgrad_kernel<T, TC><<<wgrid, WTHREADS, 0, s>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const long long total = (long long)khw * p.Ci * p.Co;
  wgrad_reduce_kernel<T><<<(unsigned)((total + 255) / 256), 256, 0, s>>>(p.wpart, splits, khw, p.Ci,
                                                                        p.Co, static_cast<T*>(dw));
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// rows of M_in per dgrad block: the wrapper sizes the (2, m_blocks, Ci)
// gscale/gbias scratch with it
int mx_fused_conv_unit_bwd_block_m(void) { return BM; }

// how many K ranges wgrad splits N*Ho*Wo into: enough blocks to fill the
// card, each range at least four WK-pixel chunks long
int mx_fused_conv_unit_bwd_splits(int KH, int KW, int Ci, int Co, long long M_out) {
  const long long tiles = (long long)KH * KW * ((Ci + WM - 1) / WM) * ((Co + WN - 1) / WN);
  const long long chunks = (M_out + WK - 1) / WK;
  long long s = (TARGET_BLOCKS + tiles - 1) / tiles;
  const long long most = chunks / 4 > 1 ? chunks / 4 : 1;
  if (s > most) s = most;
  if (s > 1024) s = 1024;
  return s < 1 ? 1 : (int)s;
}

// dtype: 0 = float32, 1 = bfloat16.  Stride 1 only.  gpart is (2,
// ceil(N*H*W/BM), Ci) fp32 scratch (ignored without act_in, when gscale
// and gbias are left untouched); wpart is (splits, KH*KW*Ci, Co) fp32
// scratch.  y, shift, gs1 and gs2 are read only with want_stats.
// Launches on `stream`, never synchronises, and returns cudaGetLastError()
// after the launches (0 = success).
int mx_fused_conv_unit_bwd(int dtype, const void* x, const void* w, const void* in_scale,
                           const void* in_bias, const void* shift, const void* y, const void* gy,
                           const void* gs1, const void* gs2, void* gx, void* dw, void* gscale,
                           void* gbias, void* gpart, void* wpart, int N, int H, int W, int Ci,
                           int Co, int KH, int KW, int PH, int PW, int act_in, int want_stats,
                           int splits, int vec_ci, int vec_co, void* stream) {
  Params p;
  p.x = x;
  p.w = w;
  p.in_scale = static_cast<const float*>(in_scale);
  p.in_bias = static_cast<const float*>(in_bias);
  p.shift = static_cast<const float*>(shift);
  p.y = y;
  p.gy = gy;
  p.gs1 = static_cast<const float*>(gs1);
  p.gs2 = static_cast<const float*>(gs2);
  p.gx = gx;
  p.gpart = static_cast<float*>(gpart);
  p.wpart = static_cast<float*>(wpart);
  p.H = H; p.W = W; p.Ci = Ci; p.Co = Co;
  p.KH = KH; p.KW = KW; p.PH = PH; p.PW = PW;
  p.Ho = H + 2 * PH - KH + 1;
  p.Wo = W + 2 * PW - KW + 1;
  p.M_in = (long long)N * H * W;
  p.M_out = (long long)N * p.Ho * p.Wo;
  p.act_in = act_in;
  p.want_stats = want_stats;
  p.vec_ci = vec_ci;
  p.vec_co = vec_co;
  if (p.M_in <= 0 || p.M_out <= 0 || Ci <= 0 || Co <= 0 || splits < 1)
    return (int)cudaErrorInvalidValue;
  const long long chunks = (p.M_out + WK - 1) / WK;
  p.chunks_per_split = (chunks + splits - 1) / splits;
  const long long m_blocks = (p.M_in + BM - 1) / BM;
  if (m_blocks > 0x7fffffffLL || (Ci + BN - 1) / BN > 65535 || (Co + WN - 1) / WN > 65535 ||
      splits > 65535)
    return (int)cudaErrorInvalidConfiguration;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) return launch_all<__nv_bfloat16, true>(p, m_blocks, splits, dw, gscale, gbias, s);
  if (dtype == 0) return launch_all<float, false>(p, m_blocks, splits, dw, gscale, gbias, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
