// Greedy non-maximum suppression's keep mask for Hopper.
//
// Replaces no TPU kernel: the reference package runs the greedy loop
// (`_greedy_nms_keep`, mxnet_tpu/ops/contrib.py:215) as one compiled
// `lax.fori_loop` on the device.  The port's plain version is a Python loop
// of about 20 device ops a candidate, over 100,000 launches for one image of
// Proposal's 6000 candidates; this kernel is its counterpart of the single
// on-device loop.
//
// It computes, for candidates sorted by score (boxes (B, K, 4) corner and
// scores (B, K) of one type T: float32, float16, bfloat16 or float64; class
// ids (B, K) of type I: float32 or float64, which hold every id of the
// other types exactly):
//
//   keep[i] = score[i] > 0 and no j < i with keep[j] suppresses i, where j
//   suppresses i when IoU(j, i) > thresh and (force or id[j] == id[i])
//
// bit for bit the plain version on the same tensors: the IoU in its
// operation order, iw = max(min(x2a, x2b) - max(x1a, x1b) + off, 0), the same
// for ih, inter = iw * ih, union = (area_a + area_b) - inter, iou = union > 0
// ? inter / union : 0, each operation rounded to T on its own as PyTorch's
// elementwise ops round it: float32 and float64 in their own type, float16
// and bfloat16 through float32 (PyTorch's compute type for them) with the
// result rounded back to T after every operation.  No FMA contraction, the
// division correctly rounded, thresh and off rounded to T as PyTorch rounds
// a Python scalar against a T tensor (through float32 for the half types);
// NaN propagates through min, max and the clamps as it does in PyTorch.
//
// What bounds it on one H100 SXM: operations, about 20 fp32 operations a
// pair of candidates (67 TFLOP/s outside the tensor cores), K^2 / 2 pairs an
// image; and the scan's serial chain, which no bound counts.
//
// Design, two launches on the caller's stream, never synchronising:
//   1. nms_mask_kernel: one 64-thread block a (row tile, column tile) pair on
//      or above the diagonal; each thread forms the 64-bit word of its row
//      against the tile's columns: bit j set when row i suppresses j > i.
//      Rows with score <= 0 never suppress, so their words are written 0.
//   2. nms_scan_kernel: one block an image walks the K / 64 words of the
//      row.  The removed mask and the valid mask live in shared memory.  For
//      word c, one thread resolves its 64 candidates in order against the
//      diagonal words (read into shared memory by the block first), which
//      gives the word's kept set; then every thread ORs the kept rows' later
//      words into the removed mask, eight independent loads at a time, so
//      only the 64-step resolution is serial.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int TB = 64;
constexpr int SCAN_THREADS = 256;
typedef unsigned long long u64;

// T's compute type C and the rounding of a C result back to T
template <class T> struct Num;
template <> struct Num<float> {
  typedef float C;
  static __device__ __forceinline__ float get(float v) { return v; }
  static __device__ __forceinline__ float rnd(float v) { return v; }
  static __device__ __forceinline__ float scalar(double v) {
    return (float)v;
  }
};
template <> struct Num<double> {
  typedef double C;
  static __device__ __forceinline__ double get(double v) { return v; }
  static __device__ __forceinline__ double rnd(double v) { return v; }
  static __device__ __forceinline__ double scalar(double v) { return v; }
};
template <> struct Num<__half> {
  typedef float C;
  static __device__ __forceinline__ float get(__half v) {
    return __half2float(v);
  }
  static __device__ __forceinline__ float rnd(float v) {
    return __half2float(__float2half_rn(v));
  }
  static __device__ __forceinline__ float scalar(double v) {
    return rnd((float)v);
  }
};
template <> struct Num<__nv_bfloat16> {
  typedef float C;
  static __device__ __forceinline__ float get(__nv_bfloat16 v) {
    return __bfloat162float(v);
  }
  static __device__ __forceinline__ float rnd(float v) {
    return __bfloat162float(__float2bfloat16_rn(v));
  }
  static __device__ __forceinline__ float scalar(double v) {
    return rnd((float)v);
  }
};

// correctly rounded, never contracted into an FMA
__device__ __forceinline__ float add_rn(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ double add_rn(double a, double b) {
  return __dadd_rn(a, b);
}
__device__ __forceinline__ float sub_rn(float a, float b) {
  return __fsub_rn(a, b);
}
__device__ __forceinline__ double sub_rn(double a, double b) {
  return __dsub_rn(a, b);
}
__device__ __forceinline__ float mul_rn(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ double mul_rn(double a, double b) {
  return __dmul_rn(a, b);
}
__device__ __forceinline__ float div_rn(float a, float b) {
  return __fdiv_rn(a, b);
}
__device__ __forceinline__ double div_rn(double a, double b) {
  return __ddiv_rn(a, b);
}

// PyTorch's minimum / maximum / clamp_min(0): NaN in, NaN out
template <class C>
__device__ __forceinline__ C tmin(C a, C b) {
  return (isnan(a) || isnan(b)) ? a + b : fmin(a, b);
}
template <class C>
__device__ __forceinline__ C tmax(C a, C b) {
  return (isnan(a) || isnan(b)) ? a + b : fmax(a, b);
}
template <class C>
__device__ __forceinline__ C clamp0(C a) {
  return isnan(a) ? a : (a < C(0) ? C(0) : a);
}

// (hi - lo) + off, each rounded to T, clamped at 0: one extent of a box or
// of an intersection
template <class T>
__device__ __forceinline__ typename Num<T>::C extent(typename Num<T>::C hi,
                                                     typename Num<T>::C lo,
                                                     typename Num<T>::C off) {
  return clamp0(Num<T>::rnd(add_rn(Num<T>::rnd(sub_rn(hi, lo)), off)));
}

template <class T, class I>
__global__ void nms_mask_kernel(const T* __restrict__ boxes,
                                const T* __restrict__ scores,
                                const I* __restrict__ ids, int K, int W,
                                double thresh_in, double off_in, int force,
                                u64* __restrict__ mask) {
  typedef typename Num<T>::C C;
  const int cb = blockIdx.x;
  const int rb = blockIdx.y;
  const int b = blockIdx.z;
  if (cb < rb) return;  // the scan reads only words at or past the diagonal
  __shared__ C cx1[TB], cy1[TB], cx2[TB], cy2[TB], carea[TB];
  __shared__ I cid[TB];
  const C thresh = Num<T>::scalar(thresh_in);
  const C off = Num<T>::scalar(off_in);
  const int t = threadIdx.x;
  const T* bb = boxes + (size_t)b * K * 4;
  const int ncol = min(K - cb * TB, TB);
  const int nrow = min(K - rb * TB, TB);
  if (t < ncol) {
    const int j = cb * TB + t;
    const C x1 = Num<T>::get(bb[j * 4 + 0]), y1 = Num<T>::get(bb[j * 4 + 1]);
    const C x2 = Num<T>::get(bb[j * 4 + 2]), y2 = Num<T>::get(bb[j * 4 + 3]);
    cx1[t] = x1; cy1[t] = y1; cx2[t] = x2; cy2[t] = y2;
    carea[t] = Num<T>::rnd(mul_rn(extent<T>(x2, x1, off),
                                  extent<T>(y2, y1, off)));
    cid[t] = force ? I(0) : ids[(size_t)b * K + j];
  }
  __syncthreads();
  if (t >= nrow) return;
  const int i = rb * TB + t;
  u64* out = mask + ((size_t)b * K + i) * W + cb;
  if (!(Num<T>::get(scores[(size_t)b * K + i]) > C(0))) {
    *out = 0ull;
    return;
  }
  const C ax1 = Num<T>::get(bb[i * 4 + 0]), ay1 = Num<T>::get(bb[i * 4 + 1]);
  const C ax2 = Num<T>::get(bb[i * 4 + 2]), ay2 = Num<T>::get(bb[i * 4 + 3]);
  const C area_a = Num<T>::rnd(mul_rn(extent<T>(ax2, ax1, off),
                                      extent<T>(ay2, ay1, off)));
  const I aid = force ? I(0) : ids[(size_t)b * K + i];
  u64 bits = 0ull;
  const int start = cb == rb ? t + 1 : 0;
  for (int j = start; j < ncol; ++j) {
    if (!force && !(cid[j] == aid)) continue;
    const C iw = extent<T>(tmin(ax2, cx2[j]), tmax(ax1, cx1[j]), off);
    const C ih = extent<T>(tmin(ay2, cy2[j]), tmax(ay1, cy1[j]), off);
    const C inter = Num<T>::rnd(mul_rn(iw, ih));
    const C uni = Num<T>::rnd(sub_rn(Num<T>::rnd(add_rn(area_a, carea[j])),
                                     inter));
    const C iou = uni > C(0) ? Num<T>::rnd(div_rn(inter, uni)) : C(0);
    if (iou > thresh) bits |= 1ull << j;
  }
  *out = bits;
}

template <class T>
__global__ void __launch_bounds__(SCAN_THREADS)
nms_scan_kernel(const u64* __restrict__ mask,
                const T* __restrict__ scores, int K, int W,
                bool* __restrict__ keep) {
  extern __shared__ u64 sm[];
  u64* removed = sm;          // W words
  u64* valid = sm + W;        // W words
  u64* diag = sm + 2 * W;     // TB words
  __shared__ u64 kept_word;
  const int b = blockIdx.x;
  const int t = threadIdx.x;
  const T* sc = scores + (size_t)b * K;
  const u64* mb = mask + (size_t)b * K * W;
  for (int w = t; w < W; w += SCAN_THREADS) {
    removed[w] = 0ull;
    u64 v = 0ull;
    for (int e = 0; e < TB; ++e) {
      const int i = w * TB + e;
      if (i < K && Num<T>::get(sc[i]) > 0) v |= 1ull << e;
    }
    valid[w] = v;
  }
  __syncthreads();
  for (int c = 0; c < W; ++c) {
    const int rows = min(K - c * TB, TB);
    if (t < rows) diag[t] = mb[(size_t)(c * TB + t) * W + c];
    __syncthreads();
    if (t == 0) {
      u64 rem = removed[c];
      const u64 vb = valid[c];
      u64 kept = 0ull;
      for (int e = 0; e < rows; ++e) {
        if (((vb & ~rem) >> e) & 1ull) {
          kept |= 1ull << e;
          rem |= diag[e];
        }
      }
      removed[c] = rem;
      kept_word = kept;
    }
    __syncthreads();
    const u64 kept = kept_word;
    if (kept) {
      for (int w = c + 1 + t; w < W; w += SCAN_THREADS) {
        u64 acc = 0ull;
        u64 left = kept;
        while (left) {
          int idx[8];
          int n = 0;
#pragma unroll
          for (int q = 0; q < 8; ++q) {
            if (left) {
              idx[q] = __ffsll((long long)left) - 1;
              left &= left - 1;
              ++n;
            } else {
              idx[q] = -1;
            }
          }
          u64 v[8];
#pragma unroll
          for (int q = 0; q < 8; ++q)
            v[q] = idx[q] >= 0 ? mb[(size_t)(c * TB + idx[q]) * W + w] : 0ull;
#pragma unroll
          for (int q = 0; q < 8; ++q) acc |= v[q];
        }
        removed[w] |= acc;
      }
    }
    __syncthreads();
  }
  bool* kb = keep + (size_t)b * K;
  for (int i = t; i < K; i += SCAN_THREADS)
    kb[i] = ((valid[i / TB] & ~removed[i / TB]) >> (i % TB)) & 1ull;
}

template <class T, class I>
int nms_keep(const void* boxes, const void* scores, const void* ids,
             void* mask, void* keep, int B, int K, int W, double thresh,
             double off, int force, cudaStream_t s) {
  dim3 grid(W, W, B);
  nms_mask_kernel<T, I><<<grid, TB, 0, s>>>(
      (const T*)boxes, (const T*)scores, (const I*)ids, K, W, thresh, off,
      force, (u64*)mask);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const size_t smem = (size_t)(2 * W + TB) * sizeof(u64);
  if (smem > 48 * 1024) {
    e = cudaFuncSetAttribute(nms_scan_kernel<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  nms_scan_kernel<T><<<B, SCAN_THREADS, smem, s>>>(
      (const u64*)mask, (const T*)scores, K, W, (bool*)keep);
  return (int)cudaGetLastError();
}

template <class T>
int nms_keep_ids(const void* boxes, const void* scores, const void* ids,
                 void* mask, void* keep, int B, int K, int W, int ids_f64,
                 double thresh, double off, int force, cudaStream_t s) {
  return ids_f64 ? nms_keep<T, double>(boxes, scores, ids, mask, keep, B, K,
                                       W, thresh, off, force, s)
                 : nms_keep<T, float>(boxes, scores, ids, mask, keep, B, K, W,
                                      thresh, off, force, s);
}

}  // namespace

extern "C" {

// boxes (B, K, 4) and scores (B, K) contiguous of the type `dtype` (0
// float32, 1 float16, 2 bfloat16, 3 float64), ids (B, K) contiguous float32
// or, with `ids_f64`, float64 (null under force); mask: scratch of B*K*W
// u64, W = ceil(K / 64); keep (B, K) bool.  Two launches on `stream`;
// returns cudaGetLastError() after them.
int mx_nms_keep(const void* boxes, const void* scores, const void* ids,
                void* mask, void* keep, int B, int K, int dtype, int ids_f64,
                double thresh, double off, int force, void* stream) {
  if (B <= 0 || K <= 0 || B > 65535 || (!force && ids == nullptr))
    return (int)cudaErrorInvalidValue;
  const int W = (K + TB - 1) / TB;
  if (W > 65535) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (dtype) {
    case 0:
      return nms_keep_ids<float>(boxes, scores, ids, mask, keep, B, K, W,
                                 ids_f64, thresh, off, force, s);
    case 1:
      return nms_keep_ids<__half>(boxes, scores, ids, mask, keep, B, K, W,
                                  ids_f64, thresh, off, force, s);
    case 2:
      return nms_keep_ids<__nv_bfloat16>(boxes, scores, ids, mask, keep, B, K,
                                         W, ids_f64, thresh, off, force, s);
    case 3:
      return nms_keep_ids<double>(boxes, scores, ids, mask, keep, B, K, W,
                                  ids_f64, thresh, off, force, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
