// Fused scaled-dot-product attention forward for Hopper.
//
// Replaces the TPU kernel `_attention_pallas`
// (mxnet_tpu/ops/pallas_attention.py:102).  For each (batch b, head h) it
// computes, with q (S,D), k and v (Sk,D) and the key mask (Sk):
//
//   s   = (q . k^T) * scale                 fp32 scores
//   s   = -1e30 where mask <= 0             finite, never -inf, so a row whose
//   s   = -1e30 where i + (Sk - S) < j      keys are all masked gets uniform
//                                           weights (causal: the last query
//                                           sees the last key)
//   p   = softmax(s) in fp32, then rounded to v's type
//   out = p . v accumulated in fp32, stored in q's type
//
// Layout: q, k, v and out are read and written through (batch, head, row)
// strides with unit stride along D, so the packed (B,S,H*D) layout and the
// head-split (B,H,S,D) one both run without a transpose.  The mask is
// (B,Sk) in q's type, shared by the heads of a batch row, or absent.
//
// Design: one block of 128 threads per (b*H + h, 64 query rows); each warp
// owns 16 query rows for the products, and in the softmax each row belongs
// to a pair of threads of that warp, with the row's running max and sum in
// registers.  The keys are walked in tiles of 64 in two passes:
//   pass 1: scores of each tile -> the running row max m and the sum of
//           exponentials l (rescaled when the max grows);
//   pass 2: scores again -> p = exp(s - m) / l rounded to v's type (the TPU
//           kernel's rounding point: P is rounded after normalisation, not
//           an unnormalised exponential divided at the end) -> out += p . v.
// The second product of q and k is the price of keeping those rounding
// points for any Sk.  Keys past Sk and query rows past S are bounded by the
// loops (zero rows in shared memory), never padded in device memory.
// bf16 multiplies on the tensor cores through WMMA (mma.sync 16x16x16, fp32
// accumulators): the products of bf16 values are exact in fp32, so the
// scores differ from the plain version only in summation order.  fp32 runs
// on the FMA units (tensor cores would round fp32 to TF32).
//
// Bound on one H100 SXM at BERT-base serving shapes (B*H = 384, S = Sk = 128,
// D = 64, bf16): 4*BH*S*Sk*D = 1.61 GFLOP (1.6 us at 989 TFLOP/s) against
// 25.3 MB of q, k, v, out and mask (7.5 us at 3.35 TB/s): bound by bytes.
// This first version has no TMA/wgmma pipeline and no double buffering: it is
// written to be right, and its measured time stands beside the bound in
// PERF.md.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace {

using namespace nvcuda;

constexpr int BQ = 64;          // query rows per block, 16 per warp
constexpr int BKV = 64;         // keys per tile
constexpr int THREADS = 128;    // 4 warps
constexpr int MAX_DF = 8;       // head dim up to 8 x 16 = 128
constexpr float MASKED = -1e30f;

struct Strides {
  long long b, h, s;
};

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const void* mask;  // (B, Sk) in q's type, or null: every key valid
  void* o;
  Strides qs, ks, vs, os;
  int B, H, S, Sk, D, Dp;  // Dp: D rounded up to 16 (zero columns in smem)
  float scale;
  int causal;
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

__host__ __device__ inline size_t align128(size_t x) { return (x + 127) & ~size_t(127); }

// Shared-memory layout (byte offsets), the same on host and device.  Row
// pitches keep every row 16-byte aligned for the vector loads, satisfy
// WMMA's ldm rules and shift consecutive rows across banks.  bf16 stages
// the output tile in the K/V region once the last tile is done; fp32
// accumulates it in its own region.
template <typename T>
struct Layout {
  static constexpr bool kBf16 = sizeof(T) == 2;
  int ld, lds, ldp, ldo;
  size_t q, k, v, s, p, o, valid, total;
  __host__ __device__ explicit Layout(int Dp) {
    ld = Dp + (kBf16 ? 8 : 4);
    lds = BKV + 4;
    ldp = BKV + (kBf16 ? 8 : 4);
    ldo = Dp + 4;
    size_t off = 0;
    q = off; off = align128(off + (size_t)BQ * ld * sizeof(T));
    k = off; off = align128(off + (size_t)BKV * ld * sizeof(T));
    v = off; off = align128(off + (size_t)BKV * ld * sizeof(T));
    s = off; off = align128(off + (size_t)BQ * lds * sizeof(float));
    p = off; off = align128(off + (size_t)BQ * ldp * sizeof(T));
    if (kBf16) {
      o = k;  // 2 * BKV * (Dp + 8) * 2 bytes >= BQ * (Dp + 4) * 4 bytes
    } else {
      o = off; off = align128(off + (size_t)BQ * ldo * sizeof(float));
    }
    valid = off; off = align128(off + BKV * sizeof(float));
    total = off;
  }
};

// rows x Dp tile from rows of `src` (unit stride along D, `row_stride`
// between rows); rows >= nvalid and columns >= D are zero.  16-byte loads:
// the wrapper guarantees aligned bases and strides.
template <typename T>
__device__ void load_rows(T* dst, int ld, const T* src, long long row_stride, int rows,
                          int nvalid, int D, int Dp) {
  constexpr int EPC = 16 / sizeof(T);  // elements per 16-byte chunk
  const int cpr = D / EPC;
  for (int i = threadIdx.x; i < rows * cpr; i += THREADS) {
    const int r = i / cpr, c = i - r * cpr;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r < nvalid) val = *reinterpret_cast<const uint4*>(src + r * row_stride + c * EPC);
    *reinterpret_cast<uint4*>(dst + r * ld + c * EPC) = val;
  }
  const int extra = Dp - D;
  if (extra > 0) {
    for (int i = threadIdx.x; i < rows * extra; i += THREADS) {
      const int r = i / extra;
      dst[r * ld + D + (i - r * extra)] = from_f<T>(0.f);
    }
  }
}

// Ss (BQ x BKV, fp32) = Qs . Ks^T, raw (unscaled) products.
template <typename T>
__device__ void tile_scores(const T* Qs, const T* Ks, float* Ss, const Layout<T>& L, int D,
                            int Dp) {
  if constexpr (Layout<T>::kBf16) {
    const int w = threadIdx.x >> 5;
    const int nd = Dp / 16;
#pragma unroll
    for (int n = 0; n < BKV / 16; ++n) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::fill_fragment(acc, 0.f);
      for (int kk = 0; kk < nd; ++kk) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major> b;
        wmma::load_matrix_sync(a, Qs + (w * 16) * L.ld + kk * 16, L.ld);
        // K row-major (keys x D) is K^T column-major
        wmma::load_matrix_sync(b, Ks + (n * 16) * L.ld + kk * 16, L.ld);
        wmma::mma_sync(acc, a, b, acc);
      }
      wmma::store_matrix_sync(Ss + (w * 16) * L.lds + n * 16, acc, L.lds, wmma::mem_row_major);
    }
  } else {
    const int r = threadIdx.x >> 1;
    const float* qrow = Qs + r * L.ld;
    for (int c = threadIdx.x & 1; c < BKV; c += 2) {
      const float* krow = Ks + c * L.ld;
      float acc = 0.f;
      for (int d = 0; d < D; ++d) acc = fmaf(qrow[d], krow[d], acc);
      Ss[r * L.lds + c] = acc;
    }
  }
}

// The finished score of key column c of the tile for query row qi: scaled,
// then key-masked and causally masked with the finite -1e30; -inf for
// columns past the last key (they take no part in max or sum).
__device__ __forceinline__ float finish_score(float raw, int c, int nk, int qi, int kj,
                                              const float* valid, const Params& p) {
  if (c >= nk) return __int_as_float(0xff800000);
  float s = __fmul_rn(raw, p.scale);
  if (!(valid[c] > 0.f)) s = MASKED;
  if (p.causal && qi + (p.Sk - p.S) < kj) s = MASKED;
  return s;
}

template <typename T>
__global__ void __launch_bounds__(THREADS) attention_fwd_kernel(const Params p) {
  extern __shared__ __align__(128) unsigned char smem[];
  const Layout<T> L(p.Dp);
  T* Qs = reinterpret_cast<T*>(smem + L.q);
  T* Ks = reinterpret_cast<T*>(smem + L.k);
  T* Vs = reinterpret_cast<T*>(smem + L.v);
  float* Ss = reinterpret_cast<float*>(smem + L.s);
  T* Ps = reinterpret_cast<T*>(smem + L.p);
  float* Os = reinterpret_cast<float*>(smem + L.o);
  float* valid = reinterpret_cast<float*>(smem + L.valid);

  const int tid = threadIdx.x, w = tid >> 5;
  const int bh = blockIdx.x;
  const int b = bh / p.H, h = bh - b * p.H;
  const int q0 = blockIdx.y * BQ;
  const int nq = min(BQ, p.S - q0);
  const T* q = static_cast<const T*>(p.q) + b * p.qs.b + h * p.qs.h + (long long)q0 * p.qs.s;
  const T* k = static_cast<const T*>(p.k) + b * p.ks.b + h * p.ks.h;
  const T* v = static_cast<const T*>(p.v) + b * p.vs.b + h * p.vs.h;
  T* o = static_cast<T*>(p.o) + b * p.os.b + h * p.os.h + (long long)q0 * p.os.s;
  const T* mask = p.mask ? static_cast<const T*>(p.mask) + (long long)b * p.Sk : nullptr;

  load_rows<T>(Qs, L.ld, q, p.qs.s, BQ, nq, p.D, p.Dp);
  // the row's running max and sum of exponentials (both threads of a
  // row's pair hold the same values)
  float m_run = __int_as_float(0xff800000), l_run = 0.f;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> oacc[MAX_DF];
  if constexpr (Layout<T>::kBf16) {
#pragma unroll
    for (int n = 0; n < MAX_DF; ++n) wmma::fill_fragment(oacc[n], 0.f);
  } else {
    for (int i = tid; i < BQ * L.ldo; i += THREADS) Os[i] = 0.f;
  }

  for (int pass = 0; pass < 2; ++pass) {
    for (int k0 = 0; k0 < p.Sk; k0 += BKV) {
      const int nk = min(BKV, p.Sk - k0);
      __syncthreads();  // the previous tile's readers are done
      load_rows<T>(Ks, L.ld, k + (long long)k0 * p.ks.s, p.ks.s, BKV, nk, p.D, p.Dp);
      if (pass == 1) load_rows<T>(Vs, L.ld, v + (long long)k0 * p.vs.s, p.vs.s, BKV, nk, p.D, p.Dp);
      for (int c = tid; c < BKV; c += THREADS)
        valid[c] = c < nk ? (mask ? to_f<T>(mask[k0 + c]) : 1.f) : 0.f;
      __syncthreads();
      tile_scores<T>(Qs, Ks, Ss, L, p.D, p.Dp);
      __syncthreads();
      // two threads per query row (the pair that WMMA's warp owns), each
      // over 32 of the tile's columns, interleaved: c = 2j + half
      {
        const int r = tid >> 1, half = tid & 1, qi = q0 + r;
        float sv[BKV / 2];
        float tmax = __int_as_float(0xff800000);
#pragma unroll
        for (int j = 0; j < BKV / 2; ++j) {
          const int c = 2 * j + half;
          sv[j] = finish_score(Ss[r * L.lds + c], c, nk, qi, k0 + c, valid, p);
          tmax = fmaxf(tmax, sv[j]);
        }
        if (pass == 0) {
          tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 1));
          const float m_new = fmaxf(m_run, tmax);
          float e = 0.f;
#pragma unroll
          for (int j = 0; j < BKV / 2; ++j) e += expf(sv[j] - m_new);
          e += __shfl_xor_sync(0xffffffffu, e, 1);
          l_run = l_run * expf(m_run - m_new) + e;
          m_run = m_new;
        } else {
#pragma unroll
          for (int j = 0; j < BKV / 2; ++j) {
            const int c = 2 * j + half;
            Ps[r * L.ldp + c] = from_f<T>(c < nk ? __fdiv_rn(expf(sv[j] - m_run), l_run) : 0.f);
          }
        }
      }
      if (pass == 0) continue;
      __syncthreads();
      // out += P . V (keys past nk: P = 0 and zero rows of V)
      if constexpr (Layout<T>::kBf16) {
        const int nd = p.Dp / 16;
#pragma unroll
        for (int kk = 0; kk < BKV / 16; ++kk) {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a;
          wmma::load_matrix_sync(a, Ps + (w * 16) * L.ldp + kk * 16, L.ldp);
#pragma unroll
          for (int n = 0; n < MAX_DF; ++n) {
            if (n < nd) {
              wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> bv;
              wmma::load_matrix_sync(bv, Vs + (kk * 16) * L.ld + n * 16, L.ld);
              wmma::mma_sync(oacc[n], a, bv, oacc[n]);
            }
          }
        }
      } else {
        const int r = tid >> 1;
        const float* prow = Ps + r * L.ldp;
        for (int d = tid & 1; d < p.D; d += 2) {
          float acc = Os[r * L.ldo + d];
          for (int c = 0; c < nk; ++c) acc = fmaf(prow[c], Vs[c * L.ld + d], acc);
          Os[r * L.ldo + d] = acc;
        }
      }
    }
  }

  __syncthreads();  // every reader of the K/V region is done
  if constexpr (Layout<T>::kBf16) {
    const int nd = p.Dp / 16;
#pragma unroll
    for (int n = 0; n < MAX_DF; ++n)
      if (n < nd)
        wmma::store_matrix_sync(Os + (w * 16) * L.ldo + n * 16, oacc[n], L.ldo,
                                wmma::mem_row_major);
    __syncthreads();
  }
  for (int i = tid; i < nq * p.D; i += THREADS) {
    const int r = i / p.D, d = i - r * p.D;
    o[r * p.os.s + d] = from_f<T>(Os[r * L.ldo + d]);
  }
}

template <typename T>
int launch(const Params& p, cudaStream_t s) {
  const Layout<T> L(p.Dp);
  // raise the dynamic shared-memory limit once per type and device, to the
  // most any head dim needs (a repeated call from another thread is
  // harmless)
  static unsigned long long raised = 0;  // bit d: done on device d
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev >= 64 || !((raised >> dev) & 1ull)) {
    e = cudaFuncSetAttribute(attention_fwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)Layout<T>(MAX_DF * 16).total);
    if (e != cudaSuccess) return (int)e;
    if (dev < 64) raised |= 1ull << dev;
  }
  const dim3 grid((unsigned)(p.B * p.H), (unsigned)((p.S + BQ - 1) / BQ));
  attention_fwd_kernel<T><<<grid, THREADS, L.total, s>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16, for q, k, v, mask and out alike.  q is
// (B,H,S,D), k and v (B,H,Sk,D), out (B,H,S,D), each given by its (batch,
// head, row) strides in elements with unit stride along D; bases and strides
// are 16-byte aligned.  mask is a contiguous (B,Sk) array or null.  The
// wrapper checks 1 <= D <= 128 with D % 8 == 0, S >= 1 and Sk >= 1.
// Launches on `stream`, never synchronises, and returns cudaGetLastError()
// after the launch (0 = success).
int mx_attention_fwd(int dtype, const void* q, const void* k, const void* v, const void* mask,
                     void* o, int B, int H, int S, int Sk, int D, long long q_sb, long long q_sh,
                     long long q_ss, long long k_sb, long long k_sh, long long k_ss,
                     long long v_sb, long long v_sh, long long v_ss, long long o_sb,
                     long long o_sh, long long o_ss, float scale, int causal, void* stream) {
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.mask = mask;
  p.o = o;
  p.qs = {q_sb, q_sh, q_ss};
  p.ks = {k_sb, k_sh, k_ss};
  p.vs = {v_sb, v_sh, v_ss};
  p.os = {o_sb, o_sh, o_ss};
  p.B = B;
  p.H = H;
  p.S = S;
  p.Sk = Sk;
  p.D = D;
  p.Dp = (D + 15) / 16 * 16;
  p.scale = scale;
  p.causal = causal;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dtype == 1 ? launch<__nv_bfloat16>(p, s) : launch<float>(p, s);
}

}  // extern "C"
