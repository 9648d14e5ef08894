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
// The shared pieces (PTX wrappers, the TMA map, the reduction) live in
// conv_mainloop.cuh.
//
// fp32 stays on the FMA units (tensor cores would round it to TF32): a
// 128 x 64 tile a block, loads into padded shared memory, the same partials
// and reduction.
#include "conv_mainloop.cuh"

namespace {

using namespace mxconv;

constexpr int MAX_SMEM = 232448;  // dynamic shared memory a block may take

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
  int n_tiles;  // tiles along Co; the bf16 grid is 1-D with the Co tile fastest
};

// where output row m reads x: its image's element offset and the top-left
// input coordinate of its window; rows past M never fall inside the image
struct RowInfo {
  long long base;
  int ih0;
  int iw0;
};

__device__ __forceinline__ RowInfo row_info(const Params& p, long long m) {
  RowInfo r;
  if (m < p.M) {
    const int hw = p.Ho * p.Wo;
    const long long n = m / hw;
    const int rem = (int)(m - n * hw);
    const int oh = rem / p.Wo;
    const int ow = rem - oh * p.Wo;
    r.base = n * (long long)p.H * p.W * p.Ci;
    r.ih0 = oh * p.SH - p.PH;
    r.iw0 = ow * p.SW - p.PW;
  } else {
    r.base = 0;
    r.ih0 = -(1 << 29);
    r.iw0 = -(1 << 29);
  }
  return r;
}

// relu(x * scale + bias) of a bf16 pair (low half first) in fp32, multiply
// then add, rounded to a bf16 pair by one cvt whose .relu clamps at 0
__device__ __forceinline__ uint32_t affine2(uint32_t v, float2 sc, float2 bi) {
  const float lo = __fadd_rn(__fmul_rn(__uint_as_float(v << 16), sc.x), bi.x);
  const float hi = __fadd_rn(__fmul_rn(__uint_as_float(v & 0xffff0000u), sc.y), bi.y);
  uint32_t out;
  asm("cvt.rn.relu.bf16x2.f32 %0, %1, %2;\n" : "=r"(out) : "f"(hi), "f"(lo));
  return out;
}

template <int BM, int BN>
struct WgmmaTile {
  static constexpr int NC = BM / 64;  // consumer warpgroups
  static constexpr int THREADS = 128 * (1 + NC);
  static constexpr int A_BYTES = BM * ROW_BYTES;
  static constexpr int B_BYTES = BN * ROW_BYTES;
  static constexpr int STAGE_BYTES = A_BYTES + B_BYTES;
  static constexpr int PITCH = BN * 2 + 16;  // bytes of a staged y row
  static constexpr int Y_BYTES = NC * 64 * PITCH;
  // the column sums of a staged y tile: 128 threads a warpgroup, so each
  // column takes SPLIT threads of 64 / SPLIT rows each
  static constexpr int SPLIT = 128 / BN;
  static constexpr int RED_FLOATS = 2 * NC * SPLIT * BN;
  // dynamic shared memory: alignment slack, ring, barriers, staged y,
  // producer rows, statistics, scale and bias padded to whole K steps,
  // then shift padded to whole Co tiles
  static size_t smem_bytes(int ci, int co) {
    return 1024 + (size_t)STAGES * STAGE_BYTES + 2 * STAGES * 8 + Y_BYTES + BM * sizeof(RowInfo) +
           RED_FLOATS * 4 + 2 * (size_t)ci_pad(ci) * 4 + (size_t)co_pad(co) * 4;
  }
  static __host__ __device__ int ci_pad(int ci) { return (ci + BK - 1) / BK * BK; }
  static __host__ __device__ int co_pad(int co) { return (co + BN - 1) / BN * BN; }
};

// A persistent kernel: block b computes tiles b, b + gridDim.x, ... (the Co
// tile fastest), and the ring runs on across tiles, so the producer loads
// the next tile while the consumers finish the last one.  One 384-thread
// block an SM at BM 128 (its consumers hold 64 fp32 accumulators a thread
// at BN 128); two 256-thread blocks at BM 64.
template <int BM, int BN>
__global__ void __launch_bounds__(WgmmaTile<BM, BN>::THREADS, BM == 64 ? 2 : 1)
    conv_unit_wgmma_kernel(const __grid_constant__ CUtensorMap wmap, const Params p,
                           long long tiles) {
  using T = WgmmaTile<BM, BN>;
  constexpr int NC = T::NC;
  constexpr int NACC = BN / 2;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* ring = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* bars = reinterpret_cast<uint64_t*>(ring + STAGES * T::STAGE_BYTES);
  unsigned char* ystage = reinterpret_cast<unsigned char*>(bars + 2 * STAGES);
  RowInfo* rows = reinterpret_cast<RowInfo*>(ystage + T::Y_BYTES);
  float* red = reinterpret_cast<float*>(rows + BM);  // [s1|s2][NC*SPLIT][BN]
  float* s_scale = red + T::RED_FLOATS;              // zeros past Ci
  const int ci_pad = T::ci_pad(p.Ci);
  float* s_bias = s_scale + ci_pad;
  float* s_shift = s_bias + ci_pad;                  // zeros past Co

  const int tid = threadIdx.x;
  if (p.act_in) {
    for (int c = tid; c < ci_pad; c += T::THREADS) {
      s_scale[c] = c < p.Ci ? p.in_scale[c] : 0.0f;
      s_bias[c] = c < p.Ci ? p.in_bias[c] : 0.0f;
    }
  }
  if (p.want_stats) {
    for (int c = tid; c < T::co_pad(p.Co); c += T::THREADS) s_shift[c] = c < p.Co ? p.shift[c] : 0.0f;
  }
  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(smem_u32(&bars[s]), 128 + 1);           // full: producer copies + TMA
      mbar_init(smem_u32(&bars[STAGES + s]), 4 * NC);   // empty: consumer warps
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int ci_steps = ci_pad / BK;
  const int nk = p.KH * p.KW * ci_steps;

  if (tid < 128) {
    // ---- producer warpgroup: x rows by cp.async, the weight box by TMA
    setmaxnreg_dec<40>();
    const __nv_bfloat16* x = static_cast<const __nv_bfloat16*>(p.x);
    const int c = tid & 7;  // this thread's 16-byte chunk of every row it copies
    int stage = 0;
    uint32_t phase = 0;
    for (long long t = blockIdx.x; t < tiles; t += gridDim.x) {
      const long long m0 = t / p.n_tiles * BM;
      const int co0 = (int)(t % p.n_tiles) * BN;
      named_bar(4, 128);  // the previous tile's copies are all issued
      for (int r = tid; r < BM; r += 128) rows[r] = row_info(p, m0 + r);
      named_bar(4, 128);
      for (int k = 0; k < nk; ++k) {
        const int tap = k / ci_steps;
        const int ci0 = (k - tap * ci_steps) * BK;
        const int ky = tap / p.KW;
        const int kx = tap - ky * p.KW;
        const uint32_t full = smem_u32(&bars[stage]);
        mbar_wait(smem_u32(&bars[STAGES + stage]), phase ^ 1);
        const uint32_t sa = smem_u32(ring + stage * T::STAGE_BYTES);
        if (tid == 0) {
          mbar_arrive_expect_tx(full, T::B_BYTES);
          tma_load_2d(sa + T::A_BYTES, &wmap, full, tap * p.Ci + ci0, co0);
        }
        const int ci = ci0 + c * 8;
#pragma unroll 4
        for (int r = tid >> 3; r < BM; r += 16) {
          const RowInfo ri = rows[r];
          const int ih = ri.ih0 + ky;
          const int iw = ri.iw0 + kx;
          const bool ok = ci < p.Ci && (unsigned)ih < (unsigned)p.H && (unsigned)iw < (unsigned)p.W;
          const __nv_bfloat16* src = ok ? x + ri.base + ((long long)ih * p.W + iw) * p.Ci + ci : x;
          cp_async16(sa + swz(r, c), src, ok ? 16u : 0u);
        }
        cp_async_arrive(full);
        if (++stage == STAGES) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
    cp_async_wait_all();
    return;
  }

  // ---- consumer warpgroups: 64 rows each
  const int ct = tid - 128;  // 0 .. 128*NC-1
  const int cw = ct >> 7;    // consumer warpgroup
  const int warp = (ct >> 5) & 3;
  const int lane = tid & 31;
  const int rw = warp * 16 + (lane >> 2);  // the thread's first D row in its warpgroup
  const int rl0 = cw * 64 + rw;            // ... in the tile (the second is rl0 + 8)
  const int lrow = cw * 64 + warp * 16 + (lane & 15);  // the row this lane points ldmatrix at
  const int lhalf = lane >> 4;
  const int cq = (lane & 3) * 2;  // the thread's channel pair in a k16 slice
  unsigned char* tile = ystage + cw * 64 * T::PITCH;
  // this thread's column and rows of the staged tile for the statistics
  const int scol = (ct & 127) % BN;
  const int spart = (ct & 127) / BN;
  constexpr int SROWS = 64 / T::SPLIT;
  __nv_bfloat16* y = static_cast<__nv_bfloat16*>(p.y);
  const bool vec = (p.Co & 7) == 0;

  int stage = 0;
  uint32_t phase = 0;
  for (long long t = blockIdx.x; t < tiles; t += gridDim.x) {
    const long long m_tile = t / p.n_tiles;
    const long long m0 = m_tile * BM;
    const int co0 = (int)(t % p.n_tiles) * BN;
    const RowInfo r0 = row_info(p, m0 + rl0);
    const RowInfo r1 = row_info(p, m0 + rl0 + 8);

    float acc[NACC];
#pragma unroll
    for (int i = 0; i < NACC; ++i) acc[i] = 0.0f;

    for (int k = 0; k < nk; ++k) {
      const int tap = k / ci_steps;
      const int ci0 = (k - tap * ci_steps) * BK;
      const int ky = tap / p.KW;
      const int kx = tap - ky * p.KW;
      mbar_wait(smem_u32(&bars[stage]), phase);
      const uint32_t sa = smem_u32(ring + stage * T::STAGE_BYTES);
      const uint32_t sb = sa + T::A_BYTES;
      uint32_t a[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) ldmatrix_x4(sa + swz(lrow, kk * 2 + lhalf), a[kk]);
      if (p.act_in) {
        // padding after the affine: rows whose tap falls outside the image
        // are masked to exact zeros; channels past Ci have scale = bias = 0
        const uint32_t m0k = ((unsigned)(r0.ih0 + ky) < (unsigned)p.H &&
                              (unsigned)(r0.iw0 + kx) < (unsigned)p.W) ? 0xffffffffu : 0u;
        const uint32_t m1k = ((unsigned)(r1.ih0 + ky) < (unsigned)p.H &&
                              (unsigned)(r1.iw0 + kx) < (unsigned)p.W) ? 0xffffffffu : 0u;
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {  // channels +0..7, +8..15 of the k16 slice
            const int ci = ci0 + kk * 16 + h * 8 + cq;
            const float2 sc = *reinterpret_cast<const float2*>(s_scale + ci);
            const float2 bi = *reinterpret_cast<const float2*>(s_bias + ci);
            a[kk][2 * h] = affine2(a[kk][2 * h], sc, bi) & m0k;
            a[kk][2 * h + 1] = affine2(a[kk][2 * h + 1], sc, bi) & m1k;
          }
        }
      }
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) wgmma_rs(acc, a[kk], b128_desc(sb + kk * 32), 1);
      wgmma_commit();
      wgmma_wait<0>();
      if (lane == 0) mbar_arrive(smem_u32(&bars[STAGES + stage]));
      if (++stage == STAGES) {
        stage = 0;
        phase ^= 1;
      }
    }

    // ---- epilogue: round, stage y for 16-byte stores, statistics
    named_bar(1, 128 * NC);  // the last tile's y stores and sums are done
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int col = j * 8 + cq;
      *reinterpret_cast<__nv_bfloat162*>(tile + rw * T::PITCH + col * 2) =
          __floats2bfloat162_rn(acc[4 * j], acc[4 * j + 1]);
      *reinterpret_cast<__nv_bfloat162*>(tile + (rw + 8) * T::PITCH + col * 2) =
          __floats2bfloat162_rn(acc[4 * j + 2], acc[4 * j + 3]);
    }
    named_bar(2 + cw, 128);  // this warpgroup's y tile is staged

    if (p.want_stats) {
      // s1/s2 of the rounded y: each thread sums SROWS rows of one column
      // of the staged tile in row order, skipping rows past M
      const long long first = m0 + cw * 64 + spart * SROWS;
      const long long left = p.M - first;
      const int n_rows = left < 0 ? 0 : (left < SROWS ? (int)left : SROWS);
      const float sh = s_shift[co0 + scol];
      const unsigned char* src = tile + spart * SROWS * T::PITCH + scol * 2;
      float a1 = 0.0f, a2 = 0.0f;
      for (int r = 0; r < n_rows; ++r) {
        const float v = __bfloat162float(*reinterpret_cast<const __nv_bfloat16*>(src + r * T::PITCH));
        const float d = v - sh;
        a1 += v;
        a2 = fmaf(d, d, a2);
      }
      red[(cw * T::SPLIT + spart) * BN + scol] = a1;
      red[(NC + cw) * T::SPLIT * BN + spart * BN + scol] = a2;
    }

    constexpr int CPR = BN / 8;  // 16-byte chunks of a staged row
    for (int i = ct & 127; i < 64 * CPR; i += 128) {
      const int row = i / CPR;
      const int ch = i - row * CPR;
      const long long m = m0 + cw * 64 + row;
      const int co = co0 + ch * 8;
      if (m >= p.M || co >= p.Co) continue;
      const unsigned char* src = tile + row * T::PITCH + ch * 16;
      if (vec) {
        *reinterpret_cast<uint4*>(y + m * p.Co + co) = *reinterpret_cast<const uint4*>(src);
      } else {
        const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(src);
        for (int q = 0; q < 8 && co + q < p.Co; ++q) y[m * p.Co + co + q] = e[q];
      }
    }
    if (p.want_stats) {
      named_bar(1, 128 * NC);  // every part's column sums are in `red`
      for (int j = ct; j < 2 * BN; j += 128 * NC) {
        const int which = j / BN;
        const int col = j - which * BN;
        const int co = co0 + col;
        if (co >= p.Co) continue;
        const float* src = red + which * NC * T::SPLIT * BN + col;
        float s = 0.0f;
        for (int w = 0; w < NC * T::SPLIT; ++w) s += src[w * BN];
        (which ? p.part2 : p.part1)[m_tile * p.Co + co] = s;
      }
    }
  }
}

// ---------------------------------------------------------------------------
// fp32: FMA units, 128 x 64 tiles, 32 channels a K step
// ---------------------------------------------------------------------------

constexpr int F_BM = 128;
constexpr int F_BN = 64;
constexpr int F_BK = 32;
constexpr int F_THREADS = 256;
constexpr int A_LD = F_BK + 8;  // smem row pitches (elements), padded
constexpr int B_LD = F_BN + 8;
constexpr int C_LD = F_BN + 4;

__global__ void __launch_bounds__(F_THREADS) conv_unit_fma_kernel(Params p) {
  constexpr int A_BYTES = F_BM * A_LD * 4;
  constexpr int B_BYTES = F_BK * B_LD * 4;
  constexpr int C_BYTES = F_BM * C_LD * 4;
  constexpr int SMEM = (A_BYTES + B_BYTES > C_BYTES) ? (A_BYTES + B_BYTES) : C_BYTES;
  // the C tile reuses the A/B staging space after the K loop
  __shared__ __align__(128) unsigned char smem[SMEM];
  __shared__ RowInfo rows[F_BM];

  float* sA = reinterpret_cast<float*>(smem);
  float* sB = reinterpret_cast<float*>(smem + A_BYTES);
  float* sC = reinterpret_cast<float*>(smem);

  const int tid = threadIdx.x;
  const long long m0 = (long long)blockIdx.x * F_BM;
  const int co0 = blockIdx.y * F_BN;
  const float* x = static_cast<const float*>(p.x);
  const float* w = static_cast<const float*>(p.w);

  if (tid < F_BM) rows[tid] = row_info(p, m0 + tid);
  __syncthreads();

  const int ty = tid >> 4;  // rows ty*8..+8
  const int tx = tid & 15;  // cols tx*4..+4
  float facc[8][4];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) facc[i][j] = 0.0f;

  const int khw = p.KH * p.KW;
  for (int ky = 0; ky < p.KH; ++ky) {
    for (int kx = 0; kx < p.KW; ++kx) {
      for (int ci0 = 0; ci0 < p.Ci; ci0 += F_BK) {
        // ---- A tile (BM x BK): u for this tap, 2 rows x 8 channels a thread
        {
          const int c = (tid & 3) * 8;
#pragma unroll
          for (int rr = 0; rr < 2; ++rr) {
            const int r = (tid >> 2) + rr * 64;
            const int ih = rows[r].ih0 + ky;
            const int iw = rows[r].iw0 + kx;
            float* dst = sA + r * A_LD + c;
            float v[8];
            if (ih >= 0 && ih < p.H && iw >= 0 && iw < p.W) {
              const float* src = x + rows[r].base + ((long long)ih * p.W + iw) * p.Ci + ci0 + c;
              if (p.vec && ci0 + c + 8 <= p.Ci) {
                const float4 a = __ldg(reinterpret_cast<const float4*>(src));
                const float4 b = __ldg(reinterpret_cast<const float4*>(src) + 1);
                v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
                v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
              } else {
#pragma unroll
                for (int j = 0; j < 8; ++j) v[j] = (ci0 + c + j < p.Ci) ? src[j] : 0.0f;
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
            for (int j = 0; j < 8; ++j) dst[j] = v[j];
          }
        }
        // ---- B tile (BK x BN): w[co, ky, kx, ci], ci fastest across a warp
        {
          const int k = tid & 31;
          const int ci = ci0 + k;
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const int n = (tid >> 5) + 8 * j;
            const int co = co0 + n;
            float v = 0.0f;
            if (ci < p.Ci && co < p.Co) v = w[((long long)co * khw + ky * p.KW + kx) * p.Ci + ci];
            sB[k * B_LD + n] = v;
          }
        }
        __syncthreads();
#pragma unroll 4
        for (int kk = 0; kk < F_BK; ++kk) {
          float a[8], b[4];
#pragma unroll
          for (int i = 0; i < 8; ++i) a[i] = sA[(ty * 8 + i) * A_LD + kk];
#pragma unroll
          for (int j = 0; j < 4; ++j) b[j] = sB[kk * B_LD + tx * 4 + j];
#pragma unroll
          for (int i = 0; i < 8; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) facc[i][j] = fmaf(a[i], b[j], facc[i][j]);
        }
        __syncthreads();
      }
    }
  }

  // ---- epilogue: tile -> smem, store y, per-block column sums
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) sC[(ty * 8 + i) * C_LD + tx * 4 + j] = facc[i][j];
  __syncthreads();

  float* y = static_cast<float*>(p.y);
  for (int e = tid; e < F_BM * F_BN; e += F_THREADS) {
    const int r = e / F_BN;
    const int c = e - r * F_BN;
    const long long m = m0 + r;
    const int co = co0 + c;
    if (m < p.M && co < p.Co) y[m * p.Co + co] = sC[r * C_LD + c];
  }
  if (!p.want_stats) return;
  if (tid < F_BN) {
    const int co = co0 + tid;
    if (co < p.Co) {
      const float sh = p.shift[co];
      const long long left = p.M - m0;
      const int n_rows = left < F_BM ? (int)left : F_BM;
      float a1 = 0.0f, a2 = 0.0f;
      for (int r = 0; r < n_rows; ++r) {
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

template <int BM, int BN>
cudaError_t launch_wgmma(const CUtensorMap& map, const Params& p, long long tiles, cudaStream_t s) {
  using T = WgmmaTile<BM, BN>;
  auto kern = conv_unit_wgmma_kernel<BM, BN>;
  const size_t smem = T::smem_bytes(p.Ci, p.Co);
  if (smem > (size_t)MAX_SMEM) return cudaErrorInvalidValue;
  static bool attr = false;  // idempotent: a race sets the same value twice
  if (!attr) {
    cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, MAX_SMEM);
    if (err != cudaSuccess) return err;
    attr = true;
  }
  // persistent: as many blocks as fit on the card at once, or one a tile
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, T::THREADS, smem);
  }
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const long long all = tiles * p.n_tiles;
  const long long blocks = all < (long long)sms * per_sm ? all : (long long)sms * per_sm;
  kern<<<(unsigned)blocks, T::THREADS, smem, s>>>(map, p, all);
  return cudaGetLastError();
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
  if (N <= 0 || Ci <= 0 || Co <= 0 || KH <= 0 || KW <= 0 || SH <= 0 || SW <= 0) {
    return (int)cudaErrorInvalidValue;
  }
  p.Ho = (H + 2 * PH - KH) / SH + 1;
  p.Wo = (W + 2 * PW - KW) / SW + 1;
  p.M = (long long)N * p.Ho * p.Wo;
  p.act_in = act_in;
  p.want_stats = want_stats;
  p.vec = (Ci % 8 == 0) && ((uintptr_t)x % 16 == 0);
  if (p.M <= 0 || p.Ho <= 0 || p.Wo <= 0 || bm <= 0 || bn <= 0) return (int)cudaErrorInvalidValue;
  const long long tiles = (p.M + bm - 1) / bm;
  p.n_tiles = (Co + bn - 1) / bn;
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
