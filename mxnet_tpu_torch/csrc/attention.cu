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
// Bound on one H100 SXM at BERT-base serving shapes (B*H = 384, S = Sk = 128,
// D = 64, bf16): 4*BH*S*Sk*D = 1.61 GFLOP (1.6 us at 989 TFLOP/s) against
// 25.3 MB of q, k, v, out and mask (7.5 us at 3.35 TB/s): bound by bytes, so
// the design reads each of q, k and v from device memory once and keeps the
// scores and probabilities on chip.
//
// Design (bf16): work units of (b, h, 128 query rows), 384 threads a block:
// two consumer warpgroups of 64 query rows each share the key and value tiles,
// and a producer warpgroup, one thread of which issues every load, gives
// its registers to the consumers (setmaxnreg).
//   - Loads by TMA: q, k and v are each seen through one 4-D tensor map
//     over (D, rows, H, B) with the caller's strides, in boxes of 64 D
//     columns x 128 rows in the 128-byte swizzle (D > 64 takes two).  The
//     map's row bound is S (or Sk) per (b, h), so rows past it and columns
//     past D read zeros: nothing is padded in device memory, and a block
//     never reads the next head's rows as keys.  Keys come in tiles of 128
//     through a 2-stage ring of key (and value) tiles on mbarriers.
//   - Scores: S = Q . K^T by wgmma m64n128k16 with both operands in shared
//     memory (Q and the key rows K-major), 64 fp32 accumulators a thread.
//     Scale, key mask, causal mask (finite -1e30) and -inf for keys past
//     Sk are applied in registers; each row's max and sum come from the
//     four threads that hold it (shfl).
//   - P in registers: p = exp(s - m) / l in fp32 (expf; the quotient
//     correctly rounded, as __fdiv_rn rounds it, from one reciprocal a row
//     and a residual step an element: see div_rn), then
//     rounded to bf16 by cvt.rn.bf16x2 straight into the A fragment of the
//     next product: the accumulator layout of each 16-key slab of S is the
//     A-register layout of an m64nDk16 wgmma, so P never goes to shared
//     memory.  P is rounded AFTER normalisation, as the TPU kernel does.
//   - Output: O = P . V by wgmma with A from registers and V (keys x D, D
//     contiguous) as an MN-major B (the transpose-B form); the epilogue
//     rounds O to bf16, stages it in its own rows of the q buffer (read by
//     then) and stores 16-byte runs through the output's strides, skipping
//     query rows past S.
//   - Persistent: one block an SM walks the units, and the producer runs
//     ahead into the next unit (its q into the second of two q buffers,
//     its keys and values into the ring) while the consumers finish this
//     one, so a unit's loads hide behind the last one's softmax.
//   - Passes: with Sk <= 128 the whole score row sits in registers, so the
//     block makes one pass and one Q . K^T.  Past that it makes two, as
//     the rounding point requires (an online rescale of an unnormalised P
//     would round elsewhere): first the running max and sum over the key
//     tiles, then the scores again, normalised, rounded and multiplied.
//   The head dim runs at 64 or 128 columns (the products' N); columns past
//   D are zeros read by TMA and never stored.
//
// fp32 stays on the FMA units (tensor cores would round it to TF32): one
// block of 128 threads per (b, h, 64 query rows), two passes over key tiles
// of 64 in padded shared memory, each row's max and sum held by a pair of
// threads.
#include "conv_mainloop.cuh"

namespace {

using namespace mxconv;

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
  int B, H, S, Sk, D;
  float scale;
  int causal;
  int one_pass;  // bf16: Sk fits one key tile, so one Q . K^T
};

// The finished score of key kj for query row qi: scaled, then key-masked
// and causally masked with the finite -1e30; -inf for keys past the last
// (they take no part in max or sum).  `valid` is the key's mask value.
__device__ __forceinline__ float finish_score(float raw, int kj, int qi, float valid,
                                              const Params& p) {
  if (kj >= p.Sk) return __int_as_float(0xff800000);
  float s = __fmul_rn(raw, p.scale);
  if (!(valid > 0.f)) s = MASKED;
  if (p.causal && qi + (p.Sk - p.S) < kj) s = MASKED;
  return s;
}

// ---------------------------------------------------------------------------
// bf16: wgmma, one pass where the score row fits the registers
// ---------------------------------------------------------------------------

constexpr int W_BQ = 128;        // query rows a block: two consumer warpgroups
constexpr int W_KT = 128;        // keys a tile
constexpr int W_THREADS = 384;   // two consumer warpgroups and a producer warpgroup
constexpr int KV_STAGES = 2;     // depth of the key/value ring
constexpr int BOX_BYTES = 128 * ROW_BYTES;  // one box: 128 rows x 64 columns

template <int DN>  // the head columns the products run over: 64 or 128
struct AttTile {
  static constexpr int ND = DN / 64;  // boxes a row
  static constexpr int Q_BYTES = ND * BOX_BYTES;
  static constexpr int KV_BYTES = ND * BOX_BYTES;  // one key (or value) tile
  static constexpr int STAGE_BYTES = 2 * KV_BYTES;
  // alignment slack, two q buffers (each also stages its unit's output),
  // ring, barriers
  static constexpr int SMEM = 1024 + 2 * Q_BYTES + KV_STAGES * STAGE_BYTES + (4 + 2 * KV_STAGES) * 8;
};

// Keeps the compiler from moving instructions that touch a wgmma operand
// into the span between wgmma_fence and wgmma_wait (which would make ptxas
// serialise the wgmmas).
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
}

// p / l rounded to nearest, given r = __frcp_rn(l), the correctly rounded
// reciprocal: q = p * r, then one residual step (Markstein), which gives
// the correctly rounded quotient, the one __fdiv_rn gives, wherever the
// quotient and the residual are normal (tests/test_torch_attention_plan.py
// checks it exactly); three operations instead of a division each
__device__ __forceinline__ float div_rn(float p, float l, float r) {
  const float q = __fmul_rn(p, r);
  return __fmaf_rn(__fmaf_rn(-q, l, p), r, q);
}

// a bf16 pair (low half first) from two fp32 values, rounded to nearest
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  uint32_t out;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;\n" : "=r"(out) : "f"(hi), "f"(lo));
  return out;
}

// The two rows a thread holds (rw and rw + 8 of its warpgroup): a max and
// a sum over the four threads that share them.
__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// A work unit is (b, h, 128 query rows); unit u is query tile u % nqt of
// (b, h) = u / nqt, so the query tiles of one head run side by side and
// share its keys in L2.
struct Unit {
  int b, h, q0;
};
__device__ __forceinline__ Unit unit_of(long long u, int nqt, const Params& p) {
  Unit w;
  const long long bh = u / nqt;
  w.q0 = (int)(u - bh * nqt) * W_BQ;
  w.h = (int)(bh % p.H);
  w.b = (int)(bh / p.H);
  return w;
}

// Persistent: block b takes units b, b + gridDim.x, ...  The producer runs
// ahead into the next unit (its q into the other of two q buffers, its
// key/value tiles into the ring) while the consumers finish this one.
template <int DN>
__global__ void __launch_bounds__(W_THREADS, 1)
    attention_wgmma_kernel(const __grid_constant__ CUtensorMap qmap,
                           const __grid_constant__ CUtensorMap kmap,
                           const __grid_constant__ CUtensorMap vmap,
                           const __grid_constant__ Params p, long long units) {
  using T = AttTile<DN>;
  constexpr int NO = DN / 2;  // output accumulators a thread
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sq = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* ring = sq + 2 * T::Q_BYTES;  // stage s: keys, then values
  // barriers: q full[2], q empty[2], ring full[KV_STAGES], ring empty[KV_STAGES]
  uint64_t* bars = reinterpret_cast<uint64_t*>(ring + KV_STAGES * T::STAGE_BYTES);
  const auto bar = [&](int i) { return smem_u32(&bars[i]); };
  constexpr int QFULL = 0, QEMPTY = 2, FULL = 4, EMPTY = 4 + KV_STAGES;

  const int tid = threadIdx.x;
  const int nqt = (p.S + W_BQ - 1) / W_BQ;
  const int nkt = (p.Sk + W_KT - 1) / W_KT;
  // ring steps a unit: one pass reads one key/value tile; two passes read
  // every key tile, then every key and value tile again
  const int steps = p.one_pass ? 1 : 2 * nkt;

  if (tid == 0) {
    for (int i = 0; i < 2; ++i) {
      mbar_init(bar(QFULL + i), 1);   // the producer's TMA
      mbar_init(bar(QEMPTY + i), 8);  // the consumer warps
    }
    for (int s = 0; s < KV_STAGES; ++s) {
      mbar_init(bar(FULL + s), 1);
      mbar_init(bar(EMPTY + s), 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= 256) {
    // ---- producer warpgroup: one thread issues every load
    setmaxnreg_dec<40>();
    if (tid == 256) {
      int step = 0;
      int n = 0;
      for (long long u = blockIdx.x; u < units; u += gridDim.x, ++n) {
        const Unit w = unit_of(u, nqt, p);
        const int qb = n & 1;
        mbar_wait(bar(QEMPTY + qb), ((n >> 1) & 1) ^ 1);
        mbar_arrive_expect_tx(bar(QFULL + qb), T::Q_BYTES);
        for (int d = 0; d < T::ND; ++d)
          tma_load_4d(smem_u32(sq + qb * T::Q_BYTES + d * BOX_BYTES), &qmap, bar(QFULL + qb),
                      d * 64, w.q0, w.h, w.b);
        for (int it = 0; it < steps; ++it, ++step) {
          const int s = step % KV_STAGES;
          const uint32_t phase = (step / KV_STAGES) & 1;
          const bool with_v = p.one_pass || it >= nkt;
          const int k0 = (it % nkt) * W_KT;
          unsigned char* st = ring + s * T::STAGE_BYTES;
          mbar_wait(bar(EMPTY + s), phase ^ 1);
          mbar_arrive_expect_tx(bar(FULL + s), with_v ? 2 * T::KV_BYTES : T::KV_BYTES);
          for (int d = 0; d < T::ND; ++d) {
            tma_load_4d(smem_u32(st + d * BOX_BYTES), &kmap, bar(FULL + s), d * 64, k0, w.h, w.b);
            if (with_v)
              tma_load_4d(smem_u32(st + T::KV_BYTES + d * BOX_BYTES), &vmap, bar(FULL + s),
                          d * 64, k0, w.h, w.b);
          }
        }
      }
    }
    return;
  }

  // ---- consumer warpgroups: query rows wg*64 .. wg*64 + 63 of a unit
  setmaxnreg_inc<232>();
  const int wg = tid >> 7;
  const int warp = (tid >> 5) & 3;
  const int lane = tid & 31;
  const int rw = warp * 16 + (lane >> 2);  // the thread's rows: rw and rw + 8
  const int cq = (lane & 3) * 2;           // its column pair in each 8 columns
  const int cpr = p.D / 8;  // 16-byte runs of an output row

  int step = 0;
  int n = 0;
  for (long long u = blockIdx.x; u < units; u += gridDim.x, ++n) {
    const Unit w = unit_of(u, nqt, p);
    const int qi0 = w.q0 + wg * 64 + rw;  // query index of row rw
    const __nv_bfloat16* mask =
        p.mask ? static_cast<const __nv_bfloat16*>(p.mask) + (long long)w.b * p.Sk : nullptr;
    const int qb = n & 1;
    unsigned char* qrows = sq + qb * T::Q_BYTES + wg * 64 * ROW_BYTES;  // in box 0
    const uint32_t qa = smem_u32(qrows);

    // sacc[4j + 2r + e]: score of key 8j + cq + e of the tile for row rw + 8r
    float sacc[64];
    float oacc[NO];
#pragma unroll
    for (int i = 0; i < NO; ++i) oacc[i] = 0.f;
    float m_run[2] = {__int_as_float(0xff800000), __int_as_float(0xff800000)};
    float l_run[2] = {0.f, 0.f};

    mbar_wait(bar(QFULL + qb), (n >> 1) & 1);
    for (int it = 0; it < steps; ++it, ++step) {
      const int s = step % KV_STAGES;
      const uint32_t phase = (step / KV_STAGES) & 1;
      const bool multiply = p.one_pass || it >= nkt;  // this step multiplies by V
      const int k0 = (it % nkt) * W_KT;
      const uint32_t kb = smem_u32(ring + s * T::STAGE_BYTES);
      // the tile's key mask, read while the tile is in flight: one key a
      // lane and a ballot for each 32 keys, so bit 8(j % 4) + e of vw[j / 4]
      // is this thread's key k0 + 8j + cq + e (mask > 0)
      uint32_t vw[4] = {~0u, ~0u, ~0u, ~0u};
      if (mask != nullptr) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int kj = k0 + 32 * i + lane;
          vw[i] = __ballot_sync(0xffffffffu, kj < p.Sk && __bfloat162float(mask[kj]) > 0.f) >> cq;
        }
      }
      mbar_wait(bar(FULL + s), phase);

      // S = Q . K^T over DN columns (zeros past D): k16 step kd is bytes
      // 32 (kd % 4) of box kd / 4
      fence_regs(sacc);
      wgmma_fence();
#pragma unroll
      for (int kd = 0; kd < DN / 16; ++kd) {
        const uint32_t off = (kd >> 2) * BOX_BYTES + (kd & 3) * 32;
        wgmma_ss(sacc, b128_desc(qa + off), b128_desc(kb + off), kd > 0);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(sacc);

      // finish the scores as finish_score does, with this thread's key
      // k0 + 8j + cq + e as c = 8j + e: past Sk when c >= past, causally
      // masked for row rw + 8r when c > see[r]
      const int past = p.Sk - k0 - cq;
      const int see0 = p.causal ? qi0 + p.Sk - p.S - k0 - cq : (1 << 30);
      const int see[2] = {see0, p.causal ? see0 + 8 : (1 << 30)};
#pragma unroll
      for (int j = 0; j < 16; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = 8 * j + e;
          const bool keep = (vw[j >> 2] >> (8 * (j & 3) + e)) & 1u;
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            float& x = sacc[4 * j + 2 * r + e];
            x = (keep && c <= see[r]) ? __fmul_rn(x, p.scale) : MASKED;
            if (c >= past) x = __int_as_float(0xff800000);
          }
        }

      if (!multiply) {
        // first of two passes: the running max and sum of exponentials
        if (lane == 0) mbar_arrive(bar(EMPTY + s));
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          float mx = m_run[r];
#pragma unroll
          for (int j = 0; j < 16; ++j)
            mx = fmaxf(mx, fmaxf(sacc[4 * j + 2 * r], sacc[4 * j + 2 * r + 1]));
          const float m_new = quad_max(mx);
          float e = 0.f;
#pragma unroll
          for (int j = 0; j < 16; ++j)
            e += expf(sacc[4 * j + 2 * r] - m_new) + expf(sacc[4 * j + 2 * r + 1] - m_new);
          l_run[r] = l_run[r] * expf(m_run[r] - m_new) + quad_sum(e);
          m_run[r] = m_new;
        }
        continue;
      }

      if (p.one_pass) {
        // the whole row is here: its max, then exp(s - m) kept in sacc
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          float mx = __int_as_float(0xff800000);
#pragma unroll
          for (int j = 0; j < 16; ++j)
            mx = fmaxf(mx, fmaxf(sacc[4 * j + 2 * r], sacc[4 * j + 2 * r + 1]));
          m_run[r] = quad_max(mx);
          float e = 0.f;
#pragma unroll
          for (int j = 0; j < 16; ++j) {
#pragma unroll
            for (int c = 0; c < 2; ++c) {
              const float x = expf(sacc[4 * j + 2 * r + c] - m_run[r]);
              sacc[4 * j + 2 * r + c] = x;
              e += x;
            }
          }
          l_run[r] = quad_sum(e);
        }
      } else {
#pragma unroll
        for (int i = 0; i < 64; ++i) sacc[i] = expf(sacc[i] - m_run[(i >> 1) & 1]);
      }
      // p = e / l, rounded to bf16 into the A fragments of the 16-key slabs
      const float rl[2] = {__frcp_rn(l_run[0]), __frcp_rn(l_run[1])};
      uint32_t pf[8][4];
#pragma unroll
      for (int t = 0; t < 8; ++t) {
#pragma unroll
        for (int g = 0; g < 4; ++g) {  // (rw, keys +0..7), (rw+8, +0..7), (rw, +8..15), (rw+8, +8..15)
          const int i = 4 * (2 * t + (g >> 1)) + 2 * (g & 1);
          const float l = l_run[g & 1], r = rl[g & 1];
          pf[t][g] = pack_bf16(div_rn(sacc[i], l, r), div_rn(sacc[i + 1], l, r));
        }
      }
      // O += P . V: V (keys x D) MN-major, slab t at key row 16t, the next
      // 64 columns one box further on
      const uint32_t vb = kb + T::KV_BYTES;
      fence_regs(pf);
      fence_regs(oacc);
      wgmma_fence();
#pragma unroll
      for (int t = 0; t < 8; ++t)
        wgmma_rs<1>(oacc, pf[t], b128_mn_desc(vb + t * 16 * ROW_BYTES, BOX_BYTES), 1);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(oacc);
      fence_regs(pf);
      if (lane == 0) mbar_arrive(bar(EMPTY + s));
    }

    // ---- epilogue: O to bf16, staged in this warpgroup's (read) rows of
    // the q buffer in the same 128-byte swizzle, stored in 16-byte runs
#pragma unroll
    for (int j = 0; j < DN / 8; ++j) {
      unsigned char* at = qrows + (j >> 3) * BOX_BYTES + cq * 2;
      *reinterpret_cast<__nv_bfloat162*>(at + swz(rw, j & 7)) =
          __floats2bfloat162_rn(oacc[4 * j], oacc[4 * j + 1]);
      *reinterpret_cast<__nv_bfloat162*>(at + swz(rw + 8, j & 7)) =
          __floats2bfloat162_rn(oacc[4 * j + 2], oacc[4 * j + 3]);
    }
    named_bar(1 + wg, 128);  // this warpgroup's rows are staged
    __nv_bfloat16* o = static_cast<__nv_bfloat16*>(p.o) + w.b * p.os.b + w.h * p.os.h;
    for (int i = tid & 127; i < 64 * cpr; i += 128) {
      const int r = i / cpr;
      const int c = i - r * cpr;
      const int qi = w.q0 + wg * 64 + r;
      if (qi >= p.S) continue;
      *reinterpret_cast<uint4*>(o + (long long)qi * p.os.s + c * 8) =
          *reinterpret_cast<const uint4*>(qrows + (c >> 3) * BOX_BYTES + swz(r, c & 7));
    }
    // the buffer goes back to the producer's TMA (the async proxy) once
    // every lane of the warp has read it
    fence_proxy_async();
    __syncwarp();
    if (lane == 0) mbar_arrive(bar(QEMPTY + qb));
  }
}

// q, k or v as a 4-D TMA map over (D, rows, H, B); a dimension of one
// element gets the stride of a contiguous layout (its index is always 0)
bool encode_qkv(CUtensorMap* map, const void* base, int D, int rows, int H, int B,
                const Strides& st) {
  const long long s_s = rows > 1 ? st.s * 2 : (long long)D * 2;
  const long long s_h = H > 1 ? st.h * 2 : s_s * rows;
  const long long s_b = B > 1 ? st.b * 2 : s_h * H;
  const long long dims[4] = {D, rows, H, B};
  const long long strides[3] = {s_s, s_h, s_b};
  for (long long x : strides)
    if (x <= 0 || x % 16 != 0 || x >= (1LL << 40)) return false;
  return encode_4d_b128(map, base, dims, strides, W_BQ);
}

template <int DN>
int launch_wgmma(const Params& p, cudaStream_t s) {
  using T = AttTile<DN>;
  CUtensorMap qm, km, vm;
  if (!encode_qkv(&qm, p.q, p.D, p.S, p.H, p.B, p.qs) ||
      !encode_qkv(&km, p.k, p.D, p.Sk, p.H, p.B, p.ks) ||
      !encode_qkv(&vm, p.v, p.D, p.Sk, p.H, p.B, p.vs)) {
    return (int)cudaErrorInvalidValue;
  }
  // raise the dynamic shared-memory limit once per device (a repeated call
  // from another thread is harmless), and size the persistent grid
  static unsigned long long raised = 0;  // bit d: done on device d
  static int sms_of[64] = {0};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  int sms = dev < 64 ? sms_of[dev] : 0;
  if (dev >= 64 || !((raised >> dev) & 1ull)) {
    e = cudaFuncSetAttribute(attention_wgmma_kernel<DN>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, T::SMEM);
    if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return (int)e;
    if (dev < 64) {
      sms_of[dev] = sms;
      raised |= 1ull << dev;
    }
  }
  const long long units = (long long)p.B * p.H * ((p.S + W_BQ - 1) / W_BQ);
  const long long grid = units < sms ? units : sms;  // one block an SM
  attention_wgmma_kernel<DN><<<(unsigned)grid, W_THREADS, T::SMEM, s>>>(qm, km, vm, p, units);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// fp32: FMA units, two passes over key tiles of 64
// ---------------------------------------------------------------------------

constexpr int F_BQ = 64;        // query rows per block, a pair of threads a row
constexpr int F_BKV = 64;       // keys per tile
constexpr int F_THREADS = 128;
constexpr int F_MAX_D = 128;

__host__ __device__ inline size_t align128(size_t x) { return (x + 127) & ~size_t(127); }

// Shared-memory layout (byte offsets), the same on host and device; row
// pitches keep every row 16-byte aligned and shift rows across banks.
struct FmaLayout {
  int ld, lds, ldp, ldo;
  size_t q, k, v, s, p, o, valid, total;
  __host__ __device__ explicit FmaLayout(int D) {
    ld = D + 4;
    lds = F_BKV + 4;
    ldp = F_BKV + 4;
    ldo = D + 4;
    size_t off = 0;
    q = off; off = align128(off + (size_t)F_BQ * ld * 4);
    k = off; off = align128(off + (size_t)F_BKV * ld * 4);
    v = off; off = align128(off + (size_t)F_BKV * ld * 4);
    s = off; off = align128(off + (size_t)F_BQ * lds * 4);
    p = off; off = align128(off + (size_t)F_BQ * ldp * 4);
    o = off; off = align128(off + (size_t)F_BQ * ldo * 4);
    valid = off; off = align128(off + F_BKV * 4);
    total = off;
  }
};

// rows x D tile from rows of `src` (unit stride along D, `row_stride`
// between rows); rows >= nvalid are zero.  16-byte loads: the wrapper
// guarantees aligned bases and strides.
__device__ void load_rows(float* dst, int ld, const float* src, long long row_stride, int rows,
                          int nvalid, int D) {
  const int cpr = D / 4;
  for (int i = threadIdx.x; i < rows * cpr; i += F_THREADS) {
    const int r = i / cpr, c = i - r * cpr;
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r < nvalid) val = *reinterpret_cast<const float4*>(src + r * row_stride + c * 4);
    *reinterpret_cast<float4*>(dst + r * ld + c * 4) = val;
  }
}

__global__ void __launch_bounds__(F_THREADS) attention_fma_kernel(const __grid_constant__ Params p) {
  extern __shared__ __align__(128) unsigned char smem[];
  const FmaLayout L(p.D);
  float* Qs = reinterpret_cast<float*>(smem + L.q);
  float* Ks = reinterpret_cast<float*>(smem + L.k);
  float* Vs = reinterpret_cast<float*>(smem + L.v);
  float* Ss = reinterpret_cast<float*>(smem + L.s);
  float* Ps = reinterpret_cast<float*>(smem + L.p);
  float* Os = reinterpret_cast<float*>(smem + L.o);
  float* valid = reinterpret_cast<float*>(smem + L.valid);

  const int tid = threadIdx.x;
  const int nqt = (p.S + F_BQ - 1) / F_BQ;
  const long long bh = blockIdx.x / nqt;
  const int q0 = (int)(blockIdx.x - bh * nqt) * F_BQ;
  const int h = (int)(bh % p.H);
  const int b = (int)(bh / p.H);
  const int nq = min(F_BQ, p.S - q0);
  const float* q = static_cast<const float*>(p.q) + b * p.qs.b + h * p.qs.h + (long long)q0 * p.qs.s;
  const float* k = static_cast<const float*>(p.k) + b * p.ks.b + h * p.ks.h;
  const float* v = static_cast<const float*>(p.v) + b * p.vs.b + h * p.vs.h;
  float* o = static_cast<float*>(p.o) + b * p.os.b + h * p.os.h + (long long)q0 * p.os.s;
  const float* mask = p.mask ? static_cast<const float*>(p.mask) + (long long)b * p.Sk : nullptr;

  load_rows(Qs, L.ld, q, p.qs.s, F_BQ, nq, p.D);
  for (int i = tid; i < F_BQ * L.ldo; i += F_THREADS) Os[i] = 0.f;
  // the row's running max and sum of exponentials (both threads of a
  // row's pair hold the same values)
  float m_run = __int_as_float(0xff800000), l_run = 0.f;
  const int r = tid >> 1, half = tid & 1, qi = q0 + r;

  for (int pass = 0; pass < 2; ++pass) {
    for (int k0 = 0; k0 < p.Sk; k0 += F_BKV) {
      const int nk = min(F_BKV, p.Sk - k0);
      __syncthreads();  // the previous tile's readers are done
      load_rows(Ks, L.ld, k + (long long)k0 * p.ks.s, p.ks.s, F_BKV, nk, p.D);
      if (pass == 1) load_rows(Vs, L.ld, v + (long long)k0 * p.vs.s, p.vs.s, F_BKV, nk, p.D);
      for (int c = tid; c < F_BKV; c += F_THREADS)
        valid[c] = c < nk ? (mask ? mask[k0 + c] : 1.f) : 0.f;
      __syncthreads();
      // raw scores: the pair of row r takes the tile's columns alternately
      {
        const float* qrow = Qs + r * L.ld;
        for (int c = half; c < F_BKV; c += 2) {
          const float* krow = Ks + c * L.ld;
          float acc = 0.f;
          for (int d = 0; d < p.D; ++d) acc = fmaf(qrow[d], krow[d], acc);
          Ss[r * L.lds + c] = acc;
        }
      }
      // each row's pair over 32 of the tile's columns, interleaved:
      // c = 2j + half
      {
        float sv[F_BKV / 2];
        float tmax = __int_as_float(0xff800000);
#pragma unroll
        for (int j = 0; j < F_BKV / 2; ++j) {
          const int c = 2 * j + half;
          sv[j] = finish_score(Ss[r * L.lds + c], k0 + c, qi, valid[c], p);
          tmax = fmaxf(tmax, sv[j]);
        }
        if (pass == 0) {
          tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 1));
          const float m_new = fmaxf(m_run, tmax);
          float e = 0.f;
#pragma unroll
          for (int j = 0; j < F_BKV / 2; ++j) e += expf(sv[j] - m_new);
          e += __shfl_xor_sync(0xffffffffu, e, 1);
          l_run = l_run * expf(m_run - m_new) + e;
          m_run = m_new;
        } else {
#pragma unroll
          for (int j = 0; j < F_BKV / 2; ++j) {
            const int c = 2 * j + half;
            Ps[r * L.ldp + c] = c < nk ? __fdiv_rn(expf(sv[j] - m_run), l_run) : 0.f;
          }
        }
      }
      if (pass == 0) continue;
      __syncthreads();
      // out += P . V (keys past nk: P = 0 and zero rows of V)
      {
        const float* prow = Ps + r * L.ldp;
        for (int d = half; d < p.D; d += 2) {
          float acc = Os[r * L.ldo + d];
          for (int c = 0; c < nk; ++c) acc = fmaf(prow[c], Vs[c * L.ld + d], acc);
          Os[r * L.ldo + d] = acc;
        }
      }
    }
  }

  __syncthreads();
  for (int i = tid; i < nq * p.D; i += F_THREADS) {
    const int rr = i / p.D, d = i - rr * p.D;
    o[rr * p.os.s + d] = Os[rr * L.ldo + d];
  }
}

int launch_fma(const Params& p, cudaStream_t s) {
  const FmaLayout L(p.D);
  static unsigned long long raised = 0;  // bit d: done on device d
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev >= 64 || !((raised >> dev) & 1ull)) {
    e = cudaFuncSetAttribute(attention_fma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)FmaLayout(F_MAX_D).total);
    if (e != cudaSuccess) return (int)e;
    if (dev < 64) raised |= 1ull << dev;
  }
  const long long grid = (long long)p.B * p.H * ((p.S + F_BQ - 1) / F_BQ);
  if (grid > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  attention_fma_kernel<<<(unsigned)grid, F_THREADS, L.total, s>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16, for q, k, v, mask and out alike.  q is
// (B,H,S,D), k and v (B,H,Sk,D), out (B,H,S,D), each given by its (batch,
// head, row) strides in elements with unit stride along D; bases and strides
// are 16-byte aligned.  mask is a contiguous (B,Sk) array or null.  passes
// is the wrapper's plan: bf16 takes 1 where Sk <= 128 (one Q . K^T) or 2;
// fp32 takes 2.  The wrapper checks 1 <= D <= 128 with D % 8 == 0, S >= 1
// and Sk >= 1.  Launches on `stream`, never synchronises, and returns
// cudaGetLastError() after the launch (0 = success; cudaErrorInvalidValue
// for what it does not take, before any launch).
int mx_attention_fwd(int dtype, const void* q, const void* k, const void* v, const void* mask,
                     void* o, int B, int H, int S, int Sk, int D, long long q_sb, long long q_sh,
                     long long q_ss, long long k_sb, long long k_sh, long long k_ss,
                     long long v_sb, long long v_sh, long long v_ss, long long o_sb,
                     long long o_sh, long long o_ss, float scale, int causal, int passes,
                     void* stream) {
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
  p.scale = scale;
  p.causal = causal;
  p.one_pass = passes == 1;
  if (B < 1 || H < 1 || S < 1 || Sk < 1 || D < 8 || D > 128 || D % 8 != 0) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    // the epilogue's 16-byte stores
    const bool out_ok = (uintptr_t)o % 16 == 0 && (S == 1 || o_ss % 8 == 0) &&
                        (H == 1 || o_sh % 8 == 0) && (B == 1 || o_sb % 8 == 0);
    if (!out_ok || (passes != 1 && passes != 2) || (p.one_pass && Sk > W_KT)) {
      return (int)cudaErrorInvalidValue;
    }
    return D <= 64 ? launch_wgmma<64>(p, s) : launch_wgmma<128>(p, s);
  }
  if (dtype == 0 && passes == 2) return launch_fma(p, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
