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
// What bounds it on one H100 SXM (3.35 TB/s, 989 TFLOP/s dense bf16): the
// backward does twice the forward's FLOPs (2·M·Co·K each for dgrad and
// wgrad) and must move x, y, gy, gx, w and dw once.  ResNet-50's 3x3
// units from 28x28 down are bound by tensor-core operations, its 1x1 units
// and the 56x56 3x3 unit by bytes.
//
// Design (bf16), four steps on one stream, built from kernel 1's pieces in
// conv_mainloop.cuh (mbarrier ring, cp.async with zero fill, TMA with the
// 128-byte swizzle, wgmma, a persistent warp-specialised block):
//  1. fold_dy_kernel reads y and gy once and writes dy_tot (bf16, rounded
//     like the plain version: add, multiply, add with no FMA contraction)
//     into scratch with a row pitch of Co rounded up to 8, zeros past Co,
//     so both GEMMs read it in 16-byte runs and TMA boxes whatever Co is.
//     Without statistics, where gy already has that pitch, dy_tot is gy.
//  2. dgrad_wgmma_kernel is kernel 1's implicit GEMM run on dy_tot: the
//     forward convolution of dy_tot with the flipped weights and pad
//     KH-1-PH, an
//     output of (M_in = N·H·W) x Ci over K = KH·KW·Co_pad.  A (dy_tot rows
//     gathered per tap) comes by cp.async with zero fill, B (the weights as
//     (Ci, KH, KW, Co_pad) K-major rows, flipped) by TMA, both into the
//     4-stage ring; A needs no affine, so wgmma reads both operands from
//     shared memory (the SS form), and one wgmma group stays in flight
//     while the next stage is issued.  The epilogue keeps du in fp32: it
//     stages an x tile in shared memory, recomputes x·scale+bias > 0,
//     writes gx = gu·scale in bf16 with 16-byte stores and one fp32 partial
//     row of Σ gu·x and Σ gu per m-tile (warp shuffles in a fixed order,
//     then the warps in order), which reduce_stats<1> (conv_mainloop.cuh,
//     kernel 1's reduction) sums deterministically.
//  3. wgrad_wgmma_kernel is a split-K implicit GEMM: tiles of (tap, Ci
//     block) x Co block, 128 x 256 where Ci >= 128 and Co >= 256 (its
//     consumers then take the registers the producer gives up, for 128
//     accumulators a thread), else 128 or 64 along each; K = N·Ho·Wo
//     output pixels cut into `splits` ranges of whole 64-pixel stages,
//     chosen by the wrapper from the shape to fill the card.  The producer
//     gathers the x rows of the tap by cp.async (zero fill outside the
//     image) and writes each stage's 64-bit mask of rows inside the image;
//     B = dy_tot is a plain (M_out, Co_pad) matrix loaded by TMA,
//     MN-major, so wgmma runs its transpose-B form.  A consumer reads
//     its u fragment transposed (ldmatrix .trans), applies the affine in
//     fp32, rounds with a relu cvt, zeroes the taps outside the image (after
//     the affine) and feeds wgmma from registers.  Every split writes its
//     fp32 partial, an empty range included.
//  4. wgrad_reduce_kernel sums the partials in split order and writes dw in
//     (Co, Ci, KH, KW) through a shared-memory transpose, coalesced.
//  No atomics anywhere: two launches give the same bits.
//
// fp32 stays on the FMA units (tensor cores would round it to TF32): the
// first design's tiles (dy folded on the fly, 128 x 64 dgrad tiles, 64 x
// 64 wgrad tiles over 32-pixel K steps), with the same two reductions.
#include "conv_mainloop.cuh"

namespace {

using namespace mxconv;

constexpr int MAX_SMEM = 232448;  // dynamic shared memory a block may take

struct Params {
  const void* x;
  const void* w;  // fp32: (Co, Ci, KH, KW)
  const float* in_scale;
  const float* in_bias;
  const float* shift;
  const void* y;
  const void* gy;
  const float* gs1;
  const float* gs2;
  void* gx;
  float* part1;  // gscale partials: (part rows, Ci)
  float* part2;  // gbias partials
  float* wpart;  // (splits, KH*KW*Ci, Co)
  const void* dyt;  // bf16: dy_tot, (M_out, co_pad)
  long long M_in, M_out;
  int H, W, Ci, Co, co_pad, KH, KW, PH, PW, Ho, Wo;
  int act_in, want_stats;
  int n_tiles;    // dgrad: tiles along Ci (the fastest index of a tile)
  int splits;     // wgrad: K ranges
  int nst;        // wgrad: 64-pixel stages of K = M_out
  int ci_blocks;  // wgrad: tiles along Ci of one tap
  int co_blocks;  // wgrad: tiles along Co
};

// relu(x * scale + bias) of a bf16 pair (low half first) in fp32, multiply
// then add, rounded to a bf16 pair by one cvt whose .relu clamps at 0
__device__ __forceinline__ uint32_t affine2(uint32_t v, float sc, float bi) {
  const float lo = __fadd_rn(__fmul_rn(__uint_as_float(v << 16), sc), bi);
  const float hi = __fadd_rn(__fmul_rn(__uint_as_float(v & 0xffff0000u), sc), bi);
  uint32_t out;
  asm("cvt.rn.relu.bf16x2.f32 %0, %1, %2;\n" : "=r"(out) : "f"(hi), "f"(lo));
  return out;
}

// dy_tot of one element in fp32, op by op as the plain version rounds it
__device__ __forceinline__ float fold1(float g, float yv, float gs1, float sh, float gs2) {
  const float t1 = __fadd_rn(g, gs1);
  const float t2 = __fmul_rn(__fmul_rn(2.0f, __fsub_rn(yv, sh)), gs2);
  return __fadd_rn(t1, t2);
}

// ---------------------------------------------------------------------------
// 1. the fold: dy_tot (M_out, co_pad) bf16, 8 channels a thread
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(256) fold_dy_kernel(const Params p) {
  const int cpr = p.co_pad / 8;
  const long long items = p.M_out * cpr;
  const __nv_bfloat16* gy = static_cast<const __nv_bfloat16*>(p.gy);
  const __nv_bfloat16* y = static_cast<const __nv_bfloat16*>(p.y);
  __nv_bfloat16* out = static_cast<__nv_bfloat16*>(const_cast<void*>(p.dyt));
  const bool vec = (p.Co & 7) == 0 && ((uintptr_t)gy & 15) == 0 && ((uintptr_t)y & 15) == 0;
  // the per-channel vectors as 16-byte loads too, where they are aligned
  const bool vec_c = vec && (((uintptr_t)p.gs1 | (uintptr_t)p.gs2 | (uintptr_t)p.shift) & 15) == 0;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < items;
       i += (long long)gridDim.x * blockDim.x) {
    const long long q = i / cpr;
    const int co = (int)(i - q * cpr) * 8;
    const long long off = q * p.Co + co;
    float g[8], yv[8], a1[8], sh[8], a2[8];
    if (vec) {
      const uint4 rg = __ldg(reinterpret_cast<const uint4*>(gy + off));
      const __nv_bfloat16* hg = reinterpret_cast<const __nv_bfloat16*>(&rg);
#pragma unroll
      for (int j = 0; j < 8; ++j) g[j] = __bfloat162float(hg[j]);
      if (p.want_stats) {
        const uint4 ry = __ldg(reinterpret_cast<const uint4*>(y + off));
        const __nv_bfloat16* hy = reinterpret_cast<const __nv_bfloat16*>(&ry);
#pragma unroll
        for (int j = 0; j < 8; ++j) yv[j] = __bfloat162float(hy[j]);
      }
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const bool in = co + j < p.Co;
        g[j] = in ? __bfloat162float(gy[off + j]) : 0.0f;
        yv[j] = in && p.want_stats ? __bfloat162float(y[off + j]) : 0.0f;
      }
    }
    if (p.want_stats) {
      if (vec_c) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float4 v1 = __ldg(reinterpret_cast<const float4*>(p.gs1 + co) + h);
          const float4 vs = __ldg(reinterpret_cast<const float4*>(p.shift + co) + h);
          const float4 v2 = __ldg(reinterpret_cast<const float4*>(p.gs2 + co) + h);
          a1[4 * h] = v1.x; a1[4 * h + 1] = v1.y; a1[4 * h + 2] = v1.z; a1[4 * h + 3] = v1.w;
          sh[4 * h] = vs.x; sh[4 * h + 1] = vs.y; sh[4 * h + 2] = vs.z; sh[4 * h + 3] = vs.w;
          a2[4 * h] = v2.x; a2[4 * h + 1] = v2.y; a2[4 * h + 2] = v2.z; a2[4 * h + 3] = v2.w;
        }
      } else {
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const bool in = co + j < p.Co;
          a1[j] = in ? p.gs1[co + j] : 0.0f;
          sh[j] = in ? p.shift[co + j] : 0.0f;
          a2[j] = in ? p.gs2[co + j] : 0.0f;
        }
      }
    }
    alignas(16) __nv_bfloat16 o[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      float v = 0.0f;
      if (co + j < p.Co) v = p.want_stats ? fold1(g[j], yv[j], a1[j], sh[j], a2[j]) : g[j];
      o[j] = __float2bfloat16_rn(v);
    }
    *reinterpret_cast<uint4*>(out + q * p.co_pad + co) = *reinterpret_cast<const uint4*>(o);
  }
}

// ---------------------------------------------------------------------------
// 2. dgrad: du over (M_in x Ci) = conv(dy_tot, flipped w, pad KH-1-PH)
// ---------------------------------------------------------------------------

// where input row m reads dy_tot: its image's element offset in dy_tot and
// the top-left output coordinate its flipped window starts at; rows past
// M_in never fall inside the output
struct DRow {
  long long base;
  int oh0;
  int ow0;
};

__device__ __forceinline__ DRow drow(const Params& p, long long m) {
  DRow r;
  if (m < p.M_in) {
    const int hw = p.H * p.W;
    const long long n = m / hw;
    const int rem = (int)(m - n * hw);
    const int ih = rem / p.W;
    const int iw = rem - ih * p.W;
    r.base = n * (long long)p.Ho * p.Wo * p.co_pad;
    r.oh0 = ih - (p.KH - 1 - p.PH);
    r.ow0 = iw - (p.KW - 1 - p.PW);
  } else {
    r.base = 0;
    r.oh0 = -(1 << 29);
    r.ow0 = -(1 << 29);
  }
  return r;
}

template <int BM, int BN>
struct DgradTile {
  static constexpr int NC = BM / 64;  // consumer warpgroups
  static constexpr int THREADS = 128 * (1 + NC);
  static constexpr int A_BYTES = BM * ROW_BYTES;
  static constexpr int B_BYTES = BN * ROW_BYTES;
  static constexpr int STAGE_BYTES = A_BYTES + B_BYTES;
  static constexpr int PITCH = BN * 2 + 16;  // bytes of a staged x / gx row
  static constexpr int X_BYTES = NC * 64 * PITCH;
  static constexpr int RED_FLOATS = 2 * NC * 4 * BN;  // [gscale|gbias][warp][column]
  // alignment slack, ring, barriers, staged x/gx, producer rows, column
  // sums, then scale and bias padded to whole Ci tiles
  static size_t smem_bytes(int ci) {
    return 1024 + (size_t)STAGES * STAGE_BYTES + 2 * STAGES * 8 + X_BYTES + BM * sizeof(DRow) +
           RED_FLOATS * 4 + 2 * (size_t)ci_pad(ci) * 4;
  }
  static __host__ __device__ int ci_pad(int ci) { return (ci + BN - 1) / BN * BN; }
};

// Persistent: block b computes tiles b, b + gridDim.x, ... (the Ci tile
// fastest); the ring runs on across tiles.
template <int BM, int BN>
__global__ void __launch_bounds__(DgradTile<BM, BN>::THREADS, BM == 64 ? 2 : 1)
    dgrad_wgmma_kernel(const __grid_constant__ CUtensorMap wmap, const Params p, long long tiles) {
  using T = DgradTile<BM, BN>;
  constexpr int NC = T::NC;
  constexpr int NACC = BN / 2;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* ring = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* bars = reinterpret_cast<uint64_t*>(ring + STAGES * T::STAGE_BYTES);
  unsigned char* xstage = reinterpret_cast<unsigned char*>(bars + 2 * STAGES);
  DRow* rows = reinterpret_cast<DRow*>(xstage + T::X_BYTES);
  float* red = reinterpret_cast<float*>(rows + BM);
  float* s_scale = red + T::RED_FLOATS;  // zeros past Ci
  const int ci_pad = T::ci_pad(p.Ci);
  float* s_bias = s_scale + ci_pad;

  const int tid = threadIdx.x;
  if (p.act_in) {
    for (int c = tid; c < ci_pad; c += T::THREADS) {
      s_scale[c] = c < p.Ci ? p.in_scale[c] : 0.0f;
      s_bias[c] = c < p.Ci ? p.in_bias[c] : 0.0f;
    }
  }
  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(smem_u32(&bars[s]), 128 + 1);          // full: producer copies + TMA
      mbar_init(smem_u32(&bars[STAGES + s]), 4 * NC);  // empty: consumer warps
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int co_steps = (p.co_pad + BK - 1) / BK;
  const int nk = p.KH * p.KW * co_steps;

  if (tid < 128) {
    // ---- producer warpgroup: dy_tot rows by cp.async, the weight box by TMA
    setmaxnreg_dec<40>();
    const __nv_bfloat16* dyt = static_cast<const __nv_bfloat16*>(p.dyt);
    const int c = tid & 7;
    int stage = 0;
    uint32_t phase = 0;
    for (long long t = blockIdx.x; t < tiles; t += gridDim.x) {
      const long long m0 = t / p.n_tiles * BM;
      const int ci0 = (int)(t % p.n_tiles) * BN;
      named_bar(4, 128);  // the previous tile's copies are all issued
      for (int r = tid; r < BM; r += 128) rows[r] = drow(p, m0 + r);
      named_bar(4, 128);
      for (int k = 0; k < nk; ++k) {
        const int tap = k / co_steps;
        const int co0 = (k - tap * co_steps) * BK;
        const int ky = tap / p.KW;
        const int kx = tap - ky * p.KW;
        const uint32_t full = smem_u32(&bars[stage]);
        mbar_wait(smem_u32(&bars[STAGES + stage]), phase ^ 1);
        const uint32_t sa = smem_u32(ring + stage * T::STAGE_BYTES);
        if (tid == 0) {
          mbar_arrive_expect_tx(full, T::B_BYTES);
          tma_load_2d(sa + T::A_BYTES, &wmap, full, tap * p.co_pad + co0, ci0);
        }
        const int co = co0 + c * 8;
#pragma unroll 4
        for (int r = tid >> 3; r < BM; r += 16) {
          const DRow ri = rows[r];
          const int oh = ri.oh0 + ky;
          const int ow = ri.ow0 + kx;
          const bool ok = co < p.co_pad && (unsigned)oh < (unsigned)p.Ho && (unsigned)ow < (unsigned)p.Wo;
          const __nv_bfloat16* src = ok ? dyt + ri.base + ((long long)oh * p.Wo + ow) * p.co_pad + co : dyt;
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
  const int ct = tid - 128;
  const int cw = ct >> 7;
  const int warp = (ct >> 5) & 3;
  const int lane = tid & 31;
  const int rw = warp * 16 + (lane >> 2);  // the thread's first D row in its warpgroup
  const int cq = (lane & 3) * 2;           // the thread's column pair in an 8-column group
  unsigned char* tile = xstage + cw * 64 * T::PITCH;
  const __nv_bfloat16* x = static_cast<const __nv_bfloat16*>(p.x);
  __nv_bfloat16* gx = static_cast<__nv_bfloat16*>(p.gx);
  constexpr int CPR = BN / 8;  // 16-byte chunks of a staged row

  int stage = 0;
  uint32_t phase = 0;
  for (long long t = blockIdx.x; t < tiles; t += gridDim.x) {
    const long long m_tile = t / p.n_tiles;
    const long long m0 = m_tile * BM;
    const int ci0 = (int)(t % p.n_tiles) * BN;

    float acc[NACC];
#pragma unroll
    for (int i = 0; i < NACC; ++i) acc[i] = 0.0f;

    // one wgmma group stays in flight: a stage goes back to the producer
    // once the group after it has been issued and its own has completed
    int held = -1;
    for (int k = 0; k < nk; ++k) {
      mbar_wait(smem_u32(&bars[stage]), phase);
      const uint32_t sa = smem_u32(ring + stage * T::STAGE_BYTES) + cw * 64 * ROW_BYTES;
      const uint32_t sb = smem_u32(ring + stage * T::STAGE_BYTES) + T::A_BYTES;
      fence_proxy_async();  // A landed by cp.async; wgmma reads it from shared memory
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) wgmma_ss(acc, b128_desc(sa + kk * 32), b128_desc(sb + kk * 32), 1);
      wgmma_commit();
      wgmma_wait<1>();
      if (held >= 0 && lane == 0) mbar_arrive(smem_u32(&bars[STAGES + held]));
      held = stage;
      if (++stage == STAGES) {
        stage = 0;
        phase ^= 1;
      }
    }
    wgmma_wait<0>();
    if (held >= 0 && lane == 0) mbar_arrive(smem_u32(&bars[STAGES + held]));

    // ---- epilogue: du stays fp32 through the mask; gx staged for 16-byte
    // stores; the column sums of gu·x and gu
    named_bar(1, 128 * NC);  // the last tile's gx stores and sums are done
    const long long mw = m0 + cw * 64;  // this warpgroup's first row
    if (p.act_in) {
      // the x tile of this warpgroup's rows, zeros past M_in and Ci
      for (int i = ct & 127; i < 64 * CPR; i += 128) {
        const int row = i / CPR;
        const int ch = i - row * CPR;
        const long long m = mw + row;
        const int ci = ci0 + ch * 8;
        uint4 v = make_uint4(0u, 0u, 0u, 0u);
        if (m < p.M_in && ci < p.Ci) v = __ldg(reinterpret_cast<const uint4*>(x + m * p.Ci + ci));
        *reinterpret_cast<uint4*>(tile + row * T::PITCH + ch * 16) = v;
      }
      named_bar(2 + cw, 128);
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const int col = j * 8 + cq;
        const float2 sc = *reinterpret_cast<const float2*>(s_scale + ci0 + col);
        const float2 bi = *reinterpret_cast<const float2*>(s_bias + ci0 + col);
        float sx0 = 0.0f, sx1 = 0.0f, sg0 = 0.0f, sg1 = 0.0f;
#pragma unroll
        for (int h = 0; h < 2; ++h) {  // rows rw, rw + 8
          uint32_t* cell = reinterpret_cast<uint32_t*>(tile + (rw + 8 * h) * T::PITCH + col * 2);
          const uint32_t xv = *cell;
          const float x0 = __uint_as_float(xv << 16);
          const float x1 = __uint_as_float(xv & 0xffff0000u);
          const float u0 = __fadd_rn(__fmul_rn(x0, sc.x), bi.x);
          const float u1 = __fadd_rn(__fmul_rn(x1, sc.y), bi.y);
          const float g0 = u0 > 0.0f ? acc[4 * j + 2 * h] : 0.0f;
          const float g1 = u1 > 0.0f ? acc[4 * j + 2 * h + 1] : 0.0f;
          const __nv_bfloat162 o = __floats2bfloat162_rn(__fmul_rn(g0, sc.x), __fmul_rn(g1, sc.y));
          *cell = *reinterpret_cast<const uint32_t*>(&o);
          sx0 = __fadd_rn(sx0, __fmul_rn(g0, x0));
          sx1 = __fadd_rn(sx1, __fmul_rn(g1, x1));
          sg0 = __fadd_rn(sg0, g0);
          sg1 = __fadd_rn(sg1, g1);
        }
        // the warp's 16 rows: lanes with the same lane % 4 hold one column
        // pair, summed over lane bits 2, 3, 4 in that order
#pragma unroll
        for (int off = 4; off < 32; off <<= 1) {
          sx0 = __fadd_rn(sx0, __shfl_xor_sync(0xffffffffu, sx0, off));
          sx1 = __fadd_rn(sx1, __shfl_xor_sync(0xffffffffu, sx1, off));
          sg0 = __fadd_rn(sg0, __shfl_xor_sync(0xffffffffu, sg0, off));
          sg1 = __fadd_rn(sg1, __shfl_xor_sync(0xffffffffu, sg1, off));
        }
        if (lane < 4) {
          float* r1 = red + (cw * 4 + warp) * BN + col;
          float* r2 = red + (NC * 4 + cw * 4 + warp) * BN + col;
          r1[0] = sx0;
          r1[1] = sx1;
          r2[0] = sg0;
          r2[1] = sg1;
        }
      }
    } else {
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const int col = j * 8 + cq;
        *reinterpret_cast<__nv_bfloat162*>(tile + rw * T::PITCH + col * 2) =
            __floats2bfloat162_rn(acc[4 * j], acc[4 * j + 1]);
        *reinterpret_cast<__nv_bfloat162*>(tile + (rw + 8) * T::PITCH + col * 2) =
            __floats2bfloat162_rn(acc[4 * j + 2], acc[4 * j + 3]);
      }
    }
    named_bar(2 + cw, 128);  // this warpgroup's gx tile is staged
    for (int i = ct & 127; i < 64 * CPR; i += 128) {
      const int row = i / CPR;
      const int ch = i - row * CPR;
      const long long m = mw + row;
      const int ci = ci0 + ch * 8;
      if (m >= p.M_in || ci >= p.Ci) continue;
      *reinterpret_cast<uint4*>(gx + m * p.Ci + ci) =
          *reinterpret_cast<const uint4*>(tile + row * T::PITCH + ch * 16);
    }
    if (p.act_in) {
      named_bar(1, 128 * NC);  // every warp's column sums are in `red`
      for (int j = ct; j < 2 * BN; j += 128 * NC) {
        const int which = j / BN;
        const int col = j - which * BN;
        const int ci = ci0 + col;
        if (ci >= p.Ci) continue;
        const float* src = red + which * NC * 4 * BN + col;
        float s = 0.0f;
        for (int w = 0; w < NC * 4; ++w) s = __fadd_rn(s, src[w * BN]);
        (which ? p.part2 : p.part1)[m_tile * p.Ci + ci] = s;
      }
    }
  }
}

// ---------------------------------------------------------------------------
// 3. wgrad: split-K partials of dw over ((tap, Ci) x Co)
// ---------------------------------------------------------------------------

template <int BM, int BN>
struct WgradTile {
  static constexpr int NC = BM / 64;  // consumer warpgroups, 64 input channels each
  static constexpr int THREADS = 128 * (1 + NC);
  static constexpr int A_BYTES = NC * 64 * ROW_BYTES;  // [warpgroup][64 pixels][64 channels]
  static constexpr int B_BYTES = (BN / 64) * 64 * ROW_BYTES;  // [co box][64 pixels][64 co]
  static constexpr int STAGE_BYTES = A_BYTES + B_BYTES;
  // alignment slack, ring, barriers, stage masks, two buffers of pixel
  // offsets, then scale and bias padded to whole Ci tiles
  static size_t smem_bytes(int ci) {
    return 1024 + (size_t)STAGES * STAGE_BYTES + 2 * STAGES * 8 + STAGES * 8 + 2 * 64 * 8 +
           2 * (size_t)ci_pad(ci) * 4;
  }
  static __host__ __device__ int ci_pad(int ci) { return (ci + BM - 1) / BM * BM; }
};

// Persistent over work items w = split * tiles + tile (the tiles of one K
// range run side by side, so they share x and dy_tot in L2); a tile is
// (tap, Ci block, Co block) with the Co block fastest.
template <int BM, int BN>
__global__ void __launch_bounds__(WgradTile<BM, BN>::THREADS, BM == 64 ? 2 : 1)
    wgrad_wgmma_kernel(const __grid_constant__ CUtensorMap dmap, const Params p, long long items) {
  using T = WgradTile<BM, BN>;
  constexpr int NC = T::NC;
  constexpr int NACC = BN / 2;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* ring = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* bars = reinterpret_cast<uint64_t*>(ring + STAGES * T::STAGE_BYTES);
  uint32_t* masks = reinterpret_cast<uint32_t*>(bars + 2 * STAGES);  // [stage][2]
  long long* offs = reinterpret_cast<long long*>(masks + 2 * STAGES);  // [2][64], -1 outside
  float* s_scale = reinterpret_cast<float*>(offs + 2 * 64);
  const int ci_pad = T::ci_pad(p.Ci);
  float* s_bias = s_scale + ci_pad;

  const int tid = threadIdx.x;
  if (p.act_in) {
    for (int c = tid; c < ci_pad; c += T::THREADS) {
      s_scale[c] = c < p.Ci ? p.in_scale[c] : 0.0f;
      s_bias[c] = c < p.Ci ? p.in_bias[c] : 0.0f;
    }
  }
  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      // full: the producer's copies, the TMA arrival (thread 0, after its
      // mask word) and thread 32's arrival after its mask word
      mbar_init(smem_u32(&bars[s]), 128 + 2);
      mbar_init(smem_u32(&bars[STAGES + s]), 4 * NC);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const long long tiles = (long long)p.KH * p.KW * p.ci_blocks * p.co_blocks;
  const int hwo = p.Ho * p.Wo;
  const int adv_h = 64 / p.Wo;  // a stage of 64 pixels as whole rows and a rest
  const int adv_w = 64 - adv_h * p.Wo;

  if (tid < 128) {
    // ---- producer warpgroup: x rows of the tap by cp.async, dy_tot by TMA
    setmaxnreg_dec<40>();
    const __nv_bfloat16* x = static_cast<const __nv_bfloat16*>(p.x);
    const int c = tid & 7;
    int stage = 0;
    uint32_t phase = 0;
    int buf = 0;
    for (long long w = blockIdx.x; w < items; w += gridDim.x) {
      const int split = (int)(w / tiles);
      const long long t = w - (long long)split * tiles;
      const int co_b = (int)(t % p.co_blocks);
      const long long rest = t / p.co_blocks;
      const int ci_b = (int)(rest % p.ci_blocks);
      const int tap = (int)(rest / p.ci_blocks);
      const int ky = tap / p.KW;
      const int kx = tap - ky * p.KW;
      const int ci0 = ci_b * BM;
      const int co0 = co_b * BN;
      const int s0 = (int)((long long)split * p.nst / p.splits);
      const int s1 = (int)((long long)(split + 1) * p.nst / p.splits);
      // thread tid < 64 follows pixel q = 64 k + tid as (n, oh, ow), one
      // division an item and none a stage
      int q = s0 * 64 + tid;
      int n = q / hwo;
      int oh = (q - n * hwo) / p.Wo;
      int ow = q - n * hwo - oh * p.Wo;
      for (int k = s0; k < s1; ++k) {
        const int q0 = k * 64;
        const uint32_t full = smem_u32(&bars[stage]);
        mbar_wait(smem_u32(&bars[STAGES + stage]), phase ^ 1);
        long long* off = offs + buf * 64;
        if (tid < 64) {
          long long o = -1;
          const int ih = oh + ky - p.PH;
          const int iw = ow + kx - p.PW;
          if (q < p.M_out && (unsigned)ih < (unsigned)p.H && (unsigned)iw < (unsigned)p.W)
            o = (((long long)n * p.H + ih) * p.W + iw) * p.Ci;
          q += 64;
          ow += adv_w;
          oh += adv_h;
          if (ow >= p.Wo) {
            ow -= p.Wo;
            ++oh;
          }
          while (oh >= p.Ho) {
            oh -= p.Ho;
            ++n;
          }
          off[tid] = o;
          const uint32_t bits = __ballot_sync(0xffffffffu, o >= 0);
          if ((tid & 31) == 0) masks[stage * 2 + (tid >> 5)] = bits;
        }
        const uint32_t sa = smem_u32(ring + stage * T::STAGE_BYTES);
        if (tid == 0) {
          mbar_arrive_expect_tx(full, T::B_BYTES);
#pragma unroll
          for (int b = 0; b < BN / 64; ++b)
            tma_load_2d(sa + T::A_BYTES + b * 64 * ROW_BYTES, &dmap, full, co0 + b * 64, q0);
        } else if (tid == 32) {
          mbar_arrive(full);
        }
        named_bar(4, 128);  // this stage's pixel offsets are written
#pragma unroll
        for (int g = 0; g < NC; ++g) {
          const int ci = ci0 + g * 64 + c * 8;
#pragma unroll
          for (int r = tid >> 3; r < 64; r += 16) {
            const long long o = off[r];
            const bool ok = o >= 0 && ci < p.Ci;
            const __nv_bfloat16* src = ok ? x + o + ci : x;
            cp_async16(sa + g * 64 * ROW_BYTES + swz(r, c), src, ok ? 16u : 0u);
          }
        }
        cp_async_arrive(full);
        buf ^= 1;
        if (++stage == STAGES) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
    cp_async_wait_all();
    return;
  }

  // ---- consumer warpgroups: 64 input channels each; at BN 256 they hold
  // 128 accumulators a thread and take the registers the producer gave up
  if constexpr (BN == 256) setmaxnreg_inc<232>();
  const int ct = tid - 128;
  const int cw = ct >> 7;
  const int warp = (ct >> 5) & 3;
  const int lane = tid & 31;
  const int g8 = lane >> 2;        // the thread's first D row (channel) in its warp's 16
  const int cq = (lane & 3) * 2;   // its column pair, and its pixel pair in a k8 slice
  // ldmatrix .trans: lane l points at pixel row (l >> 4) * 8 + (l & 7) of a
  // k16 slice and at the 8-channel chunk 2 * warp + ((l >> 3) & 1)
  const int lrow = (lane >> 4) * 8 + (lane & 7);
  const int lchunk = 2 * warp + ((lane >> 3) & 1);
  float* wpart = p.wpart;

  int stage = 0;
  uint32_t phase = 0;
  for (long long w = blockIdx.x; w < items; w += gridDim.x) {
    const int split = (int)(w / tiles);
    const long long t = w - (long long)split * tiles;
    const int co_b = (int)(t % p.co_blocks);
    const long long rest = t / p.co_blocks;
    const int ci_b = (int)(rest % p.ci_blocks);
    const int tap = (int)(rest / p.ci_blocks);
    const int ci0 = ci_b * BM;
    const int co0 = co_b * BN;
    const int s0 = (int)((long long)split * p.nst / p.splits);
    const int s1 = (int)((long long)(split + 1) * p.nst / p.splits);
    const int ci_lo = ci0 + cw * 64 + warp * 16 + g8;  // the thread's two channels
    const float sc0 = p.act_in ? s_scale[ci_lo] : 0.0f;
    const float bi0 = p.act_in ? s_bias[ci_lo] : 0.0f;
    const float sc1 = p.act_in ? s_scale[ci_lo + 8] : 0.0f;
    const float bi1 = p.act_in ? s_bias[ci_lo + 8] : 0.0f;

    float acc[NACC];
#pragma unroll
    for (int i = 0; i < NACC; ++i) acc[i] = 0.0f;

    for (int k = s0; k < s1; ++k) {
      mbar_wait(smem_u32(&bars[stage]), phase);
      const uint32_t base = smem_u32(ring + stage * T::STAGE_BYTES);
      const uint32_t sa = base + cw * 64 * ROW_BYTES;
      const uint32_t sb = base + T::A_BYTES;
      uint32_t a[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) ldmatrix_x4_trans(sa + swz(kk * 16 + lrow, lchunk), a[kk]);
      if (p.act_in) {
        // registers 0/1: pixels kk*16 + cq, +1 of channels lo / lo + 8;
        // registers 2/3: pixels kk*16 + 8 + cq, +1.  Pixels outside the
        // image are exact zeros after the affine (padding after the affine)
        const unsigned long long mk =
            (unsigned long long)masks[stage * 2] | ((unsigned long long)masks[stage * 2 + 1] << 32);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const uint32_t bits = (uint32_t)(mk >> (kk * 16 + h * 8 + cq)) & 3u;
            const uint32_t keep = ((bits & 1u) ? 0x0000ffffu : 0u) | ((bits & 2u) ? 0xffff0000u : 0u);
            a[kk][2 * h] = affine2(a[kk][2 * h], sc0, bi0) & keep;
            a[kk][2 * h + 1] = affine2(a[kk][2 * h + 1], sc1, bi1) & keep;
          }
        }
      }
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_rs<1>(acc, a[kk], b128_mn_desc(sb + kk * 16 * ROW_BYTES, 64 * ROW_BYTES), 1);
      wgmma_commit();
      wgmma_wait<0>();
      if (lane == 0) mbar_arrive(smem_u32(&bars[STAGES + stage]));
      if (++stage == STAGES) {
        stage = 0;
        phase ^= 1;
      }
    }

    // ---- epilogue: this split's fp32 partial, an empty K range included
    float* dst = wpart + (((long long)split * p.KH * p.KW + tap) * p.Ci) * p.Co;
    const bool pairs = (p.Co & 1) == 0;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int co = co0 + j * 8 + cq;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int ci = ci_lo + 8 * h;
        if (ci >= p.Ci || co >= p.Co) continue;
        float* d = dst + (long long)ci * p.Co + co;
        const float v0 = acc[4 * j + 2 * h];
        const float v1 = acc[4 * j + 2 * h + 1];
        if (pairs) {
          *reinterpret_cast<float2*>(d) = make_float2(v0, v1);
        } else {
          d[0] = v0;
          if (co + 1 < p.Co) d[1] = v1;
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// 4. dw[co, ci, ky, kx] = Σ over splits, in split order, of
//    wpart[s, (ky*KW+kx)*Ci + ci, co]: a 32 x 32 tile of (ci*khw + tap) x co
//    a block, read along co and written along (ci, tap) through shared
//    memory, so both sides are coalesced
// ---------------------------------------------------------------------------
template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

template <typename T>
__global__ void __launch_bounds__(256) wgrad_reduce_kernel(const float* wpart, int splits, int khw,
                                                           int ci_n, int co_n, T* dw) {
  __shared__ float tile[32][33];
  const int tx = threadIdx.x & 31;
  const int ty = threadIdx.x >> 5;
  const int r_n = ci_n * khw;  // dw's inner extent (ci, tap)
  const int r0 = blockIdx.x * 32;
  const int c0 = blockIdx.y * 32;
  const long long total = (long long)khw * ci_n * co_n;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = r0 + ty + 8 * i;
    const int co = c0 + tx;
    float a = 0.0f;
    if (r < r_n && co < co_n) {
      const int ci = r / khw;
      const int tap = r - ci * khw;
      const long long e = ((long long)tap * ci_n + ci) * co_n + co;
      for (int s = 0; s < splits; ++s) a += wpart[(long long)s * total + e];
    }
    tile[ty + 8 * i][tx] = a;
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int co = c0 + ty + 8 * i;
    const int r = r0 + tx;
    if (co < co_n && r < r_n) dw[(long long)co * r_n + r] = from_f<T>(tile[tx][ty + 8 * i]);
  }
}

// ---------------------------------------------------------------------------
// fp32: FMA units.  dgrad 128 x 64 tiles, K steps of 32 output channels;
// wgrad 64 x 64 tiles, K steps of 32 pixels; dy folded on the fly
// ---------------------------------------------------------------------------
constexpr int F_BM = 128;
constexpr int F_BN = 64;
constexpr int F_BK = 32;
constexpr int F_THREADS = 256;
constexpr int F_A_LD = F_BK + 8;
constexpr int F_B_LD = F_BN + 8;
constexpr int F_C_LD = F_BN + 4;
constexpr int F_WM = 64;
constexpr int F_WN = 64;
constexpr int F_WK = 32;
constexpr int F_WTHREADS = 128;
constexpr int F_WA_LD = F_WM + 8;  // A stored column-major: sA[k * F_WA_LD + i]
constexpr int F_WB_LD = F_WN + 8;
constexpr int F_WC_LD = F_WN + 4;

// up to eight fp32 elements src[0..8) of a row of `len` starting at `c`;
// zeros past it
__device__ __forceinline__ void load_row8(const float* src, int c, int len, float* v) {
  if (c + 8 <= len && ((uintptr_t)src & 15) == 0) {
    const float4 a = __ldg(reinterpret_cast<const float4*>(src));
    const float4 b = __ldg(reinterpret_cast<const float4*>(src) + 1);
    v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
    v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
  } else {
#pragma unroll
    for (int j = 0; j < 8; ++j) v[j] = (c + j < len) ? src[j] : 0.0f;
  }
}

// dy of output pixel `pix` (-1: outside the output, zeros), channels co..co+8
__device__ __forceinline__ void load_dy8(const Params& p, long long pix, int co, float* dst) {
  if (pix < 0) {
#pragma unroll
    for (int j = 0; j < 8; ++j) dst[j] = 0.0f;
    return;
  }
  const long long off = pix * p.Co + co;
  load_row8(static_cast<const float*>(p.gy) + off, co, p.Co, dst);
  if (p.want_stats) {
    float yv[8];
    load_row8(static_cast<const float*>(p.y) + off, co, p.Co, yv);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c = co + j;
      if (c < p.Co) dst[j] = fold1(dst[j], yv[j], p.gs1[c], p.shift[c], p.gs2[c]);
    }
  }
}

__global__ void __launch_bounds__(F_THREADS) dgrad_fma_kernel(Params p) {
  constexpr int A_BYTES = F_BM * F_A_LD * 4;
  constexpr int B_BYTES = F_BK * F_B_LD * 4;
  constexpr int C_BYTES = F_BM * F_C_LD * 4;
  constexpr int SMEM = (A_BYTES + B_BYTES > C_BYTES) ? (A_BYTES + B_BYTES) : C_BYTES;
  __shared__ __align__(128) unsigned char smem[SMEM];
  __shared__ long long row_obase[F_BM];  // output-pixel index of the row's image
  __shared__ int row_ih[F_BM];
  __shared__ int row_iw[F_BM];
  float* sA = reinterpret_cast<float*>(smem);
  float* sB = reinterpret_cast<float*>(smem + A_BYTES);
  float* sC = reinterpret_cast<float*>(smem);

  const int tid = threadIdx.x;
  const long long m0 = (long long)blockIdx.x * F_BM;
  const int ci0 = blockIdx.y * F_BN;
  const float* w = static_cast<const float*>(p.w);
  const int khw = p.KH * p.KW;
  if (tid < F_BM) {
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

  const int ty = tid >> 4;  // rows ty*8..+8
  const int tx = tid & 15;  // cols tx*4..+4
  float facc[8][4];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) facc[i][j] = 0.0f;

  for (int ky = 0; ky < p.KH; ++ky) {
    for (int kx = 0; kx < p.KW; ++kx) {
      for (int co0 = 0; co0 < p.Co; co0 += F_BK) {
        {  // A tile (BM x BK): dy at the output pixel this tap reaches
          const int c = (tid & 3) * 8;
#pragma unroll
          for (int rr = 0; rr < 2; ++rr) {
            const int r = (tid >> 2) + rr * 64;
            const int oh = row_ih[r] + p.PH - ky;
            const int ow = row_iw[r] + p.PW - kx;
            const long long pix = (oh >= 0 && oh < p.Ho && ow >= 0 && ow < p.Wo)
                                      ? row_obase[r] + (long long)oh * p.Wo + ow
                                      : -1;
            load_dy8(p, pix, co0 + c, sA + r * F_A_LD + c);
          }
        }
        {  // B tile (BK x BN): w[co0+k, ci0+j, ky, kx]
          const int j = tid & 63;
          const int ci = ci0 + j;
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            const int k = (tid >> 6) + 4 * i;
            const int co = co0 + k;
            float v = 0.0f;
            if (ci < p.Ci && co < p.Co) v = w[((long long)co * p.Ci + ci) * khw + ky * p.KW + kx];
            sB[k * F_B_LD + j] = v;
          }
        }
        __syncthreads();
#pragma unroll 4
        for (int kk = 0; kk < F_BK; ++kk) {
          float a[8], b[4];
#pragma unroll
          for (int i = 0; i < 8; ++i) a[i] = sA[(ty * 8 + i) * F_A_LD + kk];
#pragma unroll
          for (int j = 0; j < 4; ++j) b[j] = sB[kk * F_B_LD + tx * 4 + j];
#pragma unroll
          for (int i = 0; i < 8; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) facc[i][j] = fmaf(a[i], b[j], facc[i][j]);
        }
        __syncthreads();
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) sC[(ty * 8 + i) * F_C_LD + tx * 4 + j] = facc[i][j];
  __syncthreads();

  const float* x = static_cast<const float*>(p.x);
  float* gx = static_cast<float*>(p.gx);
  for (int e = tid; e < F_BM * F_BN; e += F_THREADS) {
    const int r = e / F_BN;
    const int c = e - r * F_BN;
    const long long m = m0 + r;
    const int ci = ci0 + c;
    if (m >= p.M_in || ci >= p.Ci) continue;
    const float du = sC[r * F_C_LD + c];
    if (p.act_in) {
      const float sc = p.in_scale[ci];
      const float uf = __fadd_rn(__fmul_rn(x[m * p.Ci + ci], sc), p.in_bias[ci]);
      const float gu = uf > 0.0f ? du : 0.0f;
      gx[m * p.Ci + ci] = __fmul_rn(gu, sc);
      sC[r * F_C_LD + c] = gu;
    } else {
      gx[m * p.Ci + ci] = du;
    }
  }
  if (!p.act_in) return;
  __syncthreads();
  if (tid < F_BN) {
    const int ci = ci0 + tid;
    if (ci < p.Ci) {
      const long long left = p.M_in - m0;
      const int rows = left < F_BM ? (int)left : F_BM;
      float a1 = 0.0f, a2 = 0.0f;
      for (int r = 0; r < rows; ++r) {
        const float gu = sC[r * F_C_LD + tid];
        a1 += __fmul_rn(gu, x[(m0 + r) * p.Ci + ci]);
        a2 += gu;
      }
      p.part1[(long long)blockIdx.x * p.Ci + ci] = a1;
      p.part2[(long long)blockIdx.x * p.Ci + ci] = a2;
    }
  }
}

__global__ void __launch_bounds__(F_WTHREADS) wgrad_fma_kernel(Params p) {
  constexpr int A_BYTES = F_WK * F_WA_LD * 4;
  constexpr int B_BYTES = F_WK * F_WB_LD * 4;
  constexpr int C_BYTES = F_WM * F_WC_LD * 4;
  constexpr int SMEM = (A_BYTES + B_BYTES > C_BYTES) ? (A_BYTES + B_BYTES) : C_BYTES;
  __shared__ __align__(128) unsigned char smem[SMEM];
  float* sA = reinterpret_cast<float*>(smem);  // column-major A: sA[k * F_WA_LD + i]
  float* sB = reinterpret_cast<float*>(smem + A_BYTES);
  float* sC = reinterpret_cast<float*>(smem);

  const int tid = threadIdx.x;
  const int ci_blocks = (p.Ci + F_WM - 1) / F_WM;
  const int tap = blockIdx.x / ci_blocks;
  const int ci0 = (blockIdx.x - tap * ci_blocks) * F_WM;
  const int ky = tap / p.KW;
  const int kx = tap - ky * p.KW;
  const int co0 = blockIdx.y * F_WN;
  const long long chunks = (p.M_out + F_WK - 1) / F_WK;
  const long long c_begin = (long long)blockIdx.z * chunks / p.splits;
  const long long c_end = (long long)(blockIdx.z + 1) * chunks / p.splits;
  const float* x = static_cast<const float*>(p.x);
  const int hwo = p.Ho * p.Wo;

  const int ty = tid >> 4;  // rows ty*8..+8
  const int tx = tid & 15;  // cols tx*4..+4
  float facc[8][4];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) facc[i][j] = 0.0f;

  const int c8 = (tid & 7) * 8;
  for (long long chunk = c_begin; chunk < c_end; ++chunk) {
    const long long q0 = chunk * F_WK;
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const int k = (tid >> 3) + 16 * rr;
      const long long q = q0 + k;
      long long pix = -1;   // output pixel for the dy row
      long long xoff = -1;  // x offset of the input pixel this tap reads
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
      // A: u[q, ci0+c8..+8] (padding taps and rows past M_out: exact zeros)
      float v[8];
      if (xoff >= 0) {
        const int ci = ci0 + c8;
        load_row8(x + xoff + ci, ci, p.Ci, v);
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
      for (int j = 0; j < 8; ++j) sA[k * F_WA_LD + c8 + j] = v[j];
      // B: dy[q, co0+c8..+8]
      load_dy8(p, pix, co0 + c8, sB + k * F_WB_LD + c8);
    }
    __syncthreads();
#pragma unroll 4
    for (int kk = 0; kk < F_WK; ++kk) {
      float a[8], b[4];
#pragma unroll
      for (int i = 0; i < 8; ++i) a[i] = sA[kk * F_WA_LD + ty * 8 + i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = sB[kk * F_WB_LD + tx * 4 + j];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) facc[i][j] = fmaf(a[i], b[j], facc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) sC[(ty * 8 + i) * F_WC_LD + tx * 4 + j] = facc[i][j];
  __syncthreads();
  // every split writes its partial, an empty K range included (zeros)
  const long long rows_total = (long long)p.KH * p.KW * p.Ci;
  float* dst = p.wpart + (long long)blockIdx.z * rows_total * p.Co;
  for (int e = tid; e < F_WM * F_WN; e += F_WTHREADS) {
    const int r = e / F_WN;
    const int c = e - r * F_WN;
    const int ci = ci0 + r;
    const int co = co0 + c;
    if (ci < p.Ci && co < p.Co) dst[((long long)tap * p.Ci + ci) * p.Co + co] = sC[r * F_WC_LD + c];
  }
}

// ---------------------------------------------------------------------------
// host
// ---------------------------------------------------------------------------

// blocks of a persistent launch: as many as fit on the card at once, or
// one a work item
template <typename K>
cudaError_t persistent_blocks(K kern, int threads, size_t smem, long long items, long long* blocks) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess) err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, threads, smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  *blocks = items < (long long)sms * per_sm ? items : (long long)sms * per_sm;
  return cudaSuccess;
}

template <int BM, int BN>
cudaError_t launch_dgrad(const CUtensorMap& map, const Params& p, long long tiles, cudaStream_t s) {
  using T = DgradTile<BM, BN>;
  auto kern = dgrad_wgmma_kernel<BM, BN>;
  const size_t smem = T::smem_bytes(p.Ci);
  if (smem > (size_t)MAX_SMEM) return cudaErrorInvalidValue;
  static bool attr = false;  // idempotent: a race sets the same value twice
  if (!attr) {
    cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, MAX_SMEM);
    if (err != cudaSuccess) return err;
    attr = true;
  }
  long long blocks = 0;
  cudaError_t err = persistent_blocks(kern, T::THREADS, smem, tiles, &blocks);
  if (err != cudaSuccess) return err;
  kern<<<(unsigned)blocks, T::THREADS, smem, s>>>(map, p, tiles);
  return cudaGetLastError();
}

template <int BM, int BN>
cudaError_t launch_wgrad(const CUtensorMap& map, const Params& p, long long items, cudaStream_t s) {
  using T = WgradTile<BM, BN>;
  auto kern = wgrad_wgmma_kernel<BM, BN>;
  const size_t smem = T::smem_bytes(p.Ci);
  if (smem > (size_t)MAX_SMEM) return cudaErrorInvalidValue;
  static bool attr = false;
  if (!attr) {
    cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, MAX_SMEM);
    if (err != cudaSuccess) return err;
    attr = true;
  }
  long long blocks = 0;
  cudaError_t err = persistent_blocks(kern, T::THREADS, smem, items, &blocks);
  if (err != cudaSuccess) return err;
  kern<<<(unsigned)blocks, T::THREADS, smem, s>>>(map, p, items);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_wgrad_reduce(const Params& p, void* dw, cudaStream_t s) {
  const int r_n = p.Ci * p.KH * p.KW;
  const dim3 grid((unsigned)((r_n + 31) / 32), (unsigned)((p.Co + 31) / 32));
  wgrad_reduce_kernel<T><<<grid, 256, 0, s>>>(p.wpart, p.splits, p.KH * p.KW, p.Ci, p.Co,
                                              static_cast<T*>(dw));
  return cudaGetLastError();
}

int launch_bf16(Params& p, const void* w_dgrad, void* dw, void* gscale, void* gbias, int dbm,
                int dbn, int wbm, int wbn, cudaStream_t s) {
  cudaError_t err;
  // 1. dy_tot, unless the wrapper passed gy itself
  if (p.dyt != p.gy) {
    const long long items = p.M_out * (p.co_pad / 8);
    long long blocks = (items + 255) / 256;
    if (blocks > 132LL * 16) blocks = 132LL * 16;
    fold_dy_kernel<<<(unsigned)blocks, 256, 0, s>>>(p);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  // 2. dgrad, then the gscale/gbias partials
  CUtensorMap wmap;
  if (!encode_rows_b128(&wmap, w_dgrad, p.Ci, (long long)p.KH * p.KW * p.co_pad, dbn))
    return (int)cudaErrorInvalidValue;
  const long long m_tiles = (p.M_in + dbm - 1) / dbm;
  p.n_tiles = (p.Ci + dbn - 1) / dbn;
  const long long d_tiles = m_tiles * p.n_tiles;
  err = dbm == 128 ? launch_dgrad<128, 128>(wmap, p, d_tiles, s) : launch_dgrad<64, 64>(wmap, p, d_tiles, s);
  if (err != cudaSuccess) return (int)err;
  if (p.act_in) {
    err = reduce_stats<1>(p.part1, p.part2, m_tiles, p.Ci, static_cast<float*>(gscale),
                          static_cast<float*>(gbias), s);
    if (err != cudaSuccess) return (int)err;
  }
  // 3. wgrad partials
  CUtensorMap dmap;
  if (!encode_rows_b128(&dmap, p.dyt, p.M_out, p.co_pad, 64)) return (int)cudaErrorInvalidValue;
  p.ci_blocks = (p.Ci + wbm - 1) / wbm;
  p.co_blocks = (p.Co + wbn - 1) / wbn;
  const long long items = (long long)p.splits * p.KH * p.KW * p.ci_blocks * p.co_blocks;
  if (wbm == 128) {
    err = wbn == 256   ? launch_wgrad<128, 256>(dmap, p, items, s)
          : wbn == 128 ? launch_wgrad<128, 128>(dmap, p, items, s)
                       : launch_wgrad<128, 64>(dmap, p, items, s);
  } else {
    err = wbn == 128 ? launch_wgrad<64, 128>(dmap, p, items, s) : launch_wgrad<64, 64>(dmap, p, items, s);
  }
  if (err != cudaSuccess) return (int)err;
  // 4. dw
  return (int)launch_wgrad_reduce<__nv_bfloat16>(p, dw, s);
}

int launch_fp32(Params& p, void* dw, void* gscale, void* gbias, cudaStream_t s) {
  const long long m_blocks = (p.M_in + F_BM - 1) / F_BM;
  const dim3 dgrid((unsigned)m_blocks, (unsigned)((p.Ci + F_BN - 1) / F_BN));
  dgrad_fma_kernel<<<dgrid, F_THREADS, 0, s>>>(p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  if (p.act_in) {
    err = reduce_stats<1>(p.part1, p.part2, m_blocks, p.Ci, static_cast<float*>(gscale),
                          static_cast<float*>(gbias), s);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 wgrid((unsigned)(p.KH * p.KW * ((p.Ci + F_WM - 1) / F_WM)),
                   (unsigned)((p.Co + F_WN - 1) / F_WN), (unsigned)p.splits);
  wgrad_fma_kernel<<<wgrid, F_WTHREADS, 0, s>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return (int)launch_wgrad_reduce<float>(p, dw, s);
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16.  Stride 1 only.  The wrapper plans the
// launch (ops/fused_convbn.py::bwd_launch_plan) and allocates everything:
//   w_dgrad  bf16: the flipped weights as K-major rows, (Ci, KH, KW,
//            co_pad) with w_dgrad[ci, ky, kx, co] = w[co, ci, KH-1-ky,
//            KW-1-kx] and zeros past Co (co_pad = Co rounded up to 8);
//            fp32: ignored (the kernel reads w)
//   dyt      bf16: (M_out, co_pad) scratch for dy_tot, or gy itself when
//            want_stats is 0 and Co % 8 == 0; fp32: ignored
//   part     (2, part_rows, Ci) fp32 scratch for the gscale/gbias partials
//            and their reduction passes (ignored without act_in, when
//            gscale and gbias are left untouched)
//   wpart    (splits, KH*KW*Ci, Co) fp32 scratch for the wgrad partials
//   (dbm, dbn) the dgrad tile: bf16 (64, 64) or (128, 128), fp32 (128, 64);
//   (wbm, wbn) the wgrad tile: bf16 64 or 128 each, or (128, 256); fp32
//            (64, 64).
// bf16 takes Ci % 8 == 0 and 16-byte aligned x, gx, w_dgrad and dyt.
// y, shift, gs1 and gs2 are read only with want_stats.  Launches on
// `stream`, never synchronises, and returns cudaGetLastError() after the
// launches (0 = success; cudaErrorInvalidValue, before any launch, for a
// shape, plan or alignment it does not take).
int mx_fused_conv_unit_bwd(int dtype, const void* x, const void* w, const void* w_dgrad,
                           const void* in_scale, const void* in_bias, const void* shift,
                           const void* y, const void* gy, const void* gs1, const void* gs2,
                           void* gx, void* dw, void* gscale, void* gbias, void* dyt, void* part,
                           void* wpart, int N, int H, int W, int Ci, int Co, int KH, int KW,
                           int PH, int PW, int act_in, int want_stats, int dbm, int dbn, int wbm,
                           int wbn, int splits, long long part_rows, void* stream) {
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
  p.part1 = static_cast<float*>(part);
  p.part2 = part == nullptr ? nullptr : static_cast<float*>(part) + part_rows * Ci;
  p.wpart = static_cast<float*>(wpart);
  p.dyt = dyt;
  p.H = H; p.W = W; p.Ci = Ci; p.Co = Co;
  p.co_pad = (Co + 7) / 8 * 8;
  p.KH = KH; p.KW = KW; p.PH = PH; p.PW = PW;
  p.Ho = H + 2 * PH - KH + 1;
  p.Wo = W + 2 * PW - KW + 1;
  p.M_in = (long long)N * H * W;
  p.M_out = (long long)N * p.Ho * p.Wo;
  p.act_in = act_in;
  p.want_stats = want_stats;
  p.splits = splits;
  p.nst = (int)((p.M_out + 63) / 64);
  p.n_tiles = p.ci_blocks = p.co_blocks = 0;
  if (N <= 0 || Ci <= 0 || Co <= 0 || KH <= 0 || KW <= 0 || PH < 0 || PW < 0 || p.Ho <= 0 ||
      p.Wo <= 0 || splits < 1 || splits > 65535 || p.M_out > 0x7fffffffLL * 64)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    const bool dtile = (dbm == 64 && dbn == 64) || (dbm == 128 && dbn == 128);
    const bool wtile = (wbm == 64 || wbm == 128) && (wbn == 64 || wbn == 128 || (wbn == 256 && wbm == 128));
    const long long m_tiles = (p.M_in + dbm - 1) / dbm;
    const bool aligned = ((uintptr_t)x | (uintptr_t)gx | (uintptr_t)w_dgrad | (uintptr_t)dyt) % 16 == 0;
    const bool dyt_ok = dyt != gy || (!want_stats && Co % 8 == 0);
    if (!dtile || !wtile || Ci % 8 != 0 || !aligned || !dyt_ok || dyt == nullptr ||
        p.M_out + 64 > 0x7fffffffLL ||
        w_dgrad == nullptr || (act_in && part_rows < scratch_rows_for(m_tiles)))
      return (int)cudaErrorInvalidValue;
    return launch_bf16(p, w_dgrad, dw, gscale, gbias, dbm, dbn, wbm, wbn, s);
  }
  if (dtype == 0) {
    const long long m_blocks = (p.M_in + F_BM - 1) / F_BM;
    if (dbm != F_BM || dbn != F_BN || wbm != F_WM || wbn != F_WN || m_blocks > 0x7fffffffLL ||
        (Ci + F_BN - 1) / F_BN > 65535 || (Co + F_WN - 1) / F_WN > 65535 ||
        (act_in && part_rows < scratch_rows_for(m_blocks)))
      return (int)cudaErrorInvalidValue;
    return launch_fp32(p, dw, gscale, gbias, s);
  }
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
