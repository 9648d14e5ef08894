// Hopper building blocks of the port's kernels.
//
// Included by fused_convbn.cu (kernel 1, the fused Conv+BN forward),
// convbn_tap.cu (kernel 6, the same unit on weights in tap layout),
// fused_convbn_bwd.cu (kernel 2, its backward: dgrad and wgrad) and
// attention.cu (kernel 5):
//   - PTX wrappers: mbarrier, cp.async with zero fill and mbarrier
//     completion, TMA 2-D and 4-D loads, ldmatrix (plain and transposed),
//     wgmma with A from registers or from shared memory and B K-major or
//     MN-major (the transpose-B form), named barriers;
//   - the host-side encoding of 2-D and 4-D TMA tensor maps, looked up at
//     run time through the CUDA runtime (no -lcuda);
//   - the tile geometry of a multi-stage ring whose stages hold bf16
//     tiles as 128-byte rows in the 128-byte swizzle (16-byte chunk c of
//     row r at chunk c ^ (r & 7)), the layout TMA writes with
//     CU_TENSOR_MAP_SWIZZLE_128B and wgmma reads through a B128
//     descriptor;
//   - the deterministic reduction of per-tile fp32 partial rows
//     (stats_reduce_kernel / reduce_stats), shared by kernels 1 and 6's
//     s1/s2 and kernel 2's gscale/gbias;
//   - namespace unit: the fused unit's kernel bodies (the persistent
//     wgmma implicit GEMM for bf16, the FMA tiles for fp32), templated on
//     the weights' layout and run by kernels 1 and 6.
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace mxconv {

constexpr int BK = 64;          // bf16 K elements per stage: one 128-byte row
constexpr int ROW_BYTES = 128;  // bytes of one swizzled tile row
constexpr int STAGES = 4;       // depth of the shared-memory ring

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// byte offset of 16-byte chunk c of row r in a 128-byte-swizzled tile
__device__ __forceinline__ uint32_t swz(int r, int c) {
  return (uint32_t)(r * ROW_BYTES + ((c ^ (r & 7)) << 4));
}

// ---- mbarrier -------------------------------------------------------------
__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}
__device__ __forceinline__ void mbar_arrive_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}
// Waits until the phase of parity `parity` has completed.  A wait that
// outlives ~2 s of SM clock traps (a launch error) instead of hanging.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  long long t0 = 0;
  while (true) {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (t0 == 0) {
      t0 = clock64();
    } else if (clock64() - t0 > 4000000000LL) {
      __trap();
    }
  }
}

// ---- asynchronous copies --------------------------------------------------
// 16 bytes global -> shared; src_bytes 0 writes 16 zero bytes (and reads
// nothing), the zero fill of padding and of rows past the edge
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, uint32_t src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(src_bytes)
               : "memory");
}
// one arrival on `bar` once every cp.async this thread issued so far has
// landed; counts against the barrier's expected arrivals (.noinc)
__device__ __forceinline__ void cp_async_arrive(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(bar) : "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}
// TMA: the box at (c0 innermost, c1) of `map` into shared memory at dst,
// completing `bytes` of the transaction count of `bar`
__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

// TMA: the box at (c0 innermost, c1, c2, c3) of a 4-D `map`, as above
__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// ---- warp / warpgroup -----------------------------------------------------
__device__ __forceinline__ void ldmatrix_x4(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}
// the transposed load: thread t receives rows 2(t%4), 2(t%4)+1 of column
// t/4 of each 8x8 matrix, the mma fragment of the matrix's transpose
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}
__device__ __forceinline__ void named_bar(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}
// makes shared memory written through the generic proxy (cp.async, plain
// stores) that this thread has observed visible to its next async-proxy
// reads (wgmma operands from shared memory)
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// waits until at most N committed wgmma groups of this warpgroup are
// still in flight
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
template <int REGS>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(REGS));
}
template <int REGS>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(REGS));
}

// wgmma descriptor of a K-major operand in the 128-byte swizzle: 8-row
// groups 1024 bytes apart (SBO), layout B128; `addr` 1024-aligned plus the
// K offset (32 bytes per k16 step) inside the swizzle row
__device__ __forceinline__ uint64_t b128_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) | ((uint64_t)(1024 >> 4) << 32) |
         ((uint64_t)1 << 62);
}

// wgmma descriptor of an MN-major operand in the 128-byte swizzle: each
// 128-byte row holds 64 MN elements of one K index, 8 K rows make one
// 1024-byte swizzle atom (the next 8 K rows at SBO = 1024 bytes), and the
// next 64 MN elements start `mn_bytes` further on (LBO); `addr`
// 1024-aligned plus the K offset (2048 bytes per k16 step)
__device__ __forceinline__ uint64_t b128_mn_desc(uint32_t addr, uint32_t mn_bytes) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)((mn_bytes >> 4) & 0x3FFF) << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

// D (64 x N, fp32, in registers) += A (64 x 16 bf16, registers: the
// mma.m16n8k16 A fragment of each warp's 16 rows) * B (16 x N, bf16, from
// the descriptor, K-major, or MN-major with TNSP_B = 1); scale_d 0
// overwrites D
template <int TNSP_B = 0>
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4],
                                         uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31},"
      " {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d), "n"(TNSP_B));
}

template <int TNSP_B = 0>
__device__ __forceinline__ void wgmma_rs(float (&d)[64], const uint32_t (&a)[4],
                                         uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63},"
      " {%64, %65, %66, %67}, %68, p, 1, 1, %70;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d), "n"(TNSP_B));
}

template <int TNSP_B = 0>
__device__ __forceinline__ void wgmma_rs(float (&d)[128], const uint32_t (&a)[4],
                                         uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63,"
      " %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79,"
      " %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95,"
      " %96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111,"
      " %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127},"
      " {%128, %129, %130, %131}, %132, p, 1, 1, %134;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d), "n"(TNSP_B));
}

// D (64 x N, fp32) += A (64 x 16 bf16, K-major in shared memory, from
// desc_a) * B (16 x N, bf16, K-major, from desc_b): the SS form
#define MXCONV_D32                                                                              \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), \
      "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),    \
      "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]),  \
      "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]),  \
      "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t desc_a, uint64_t desc_b,
                                         int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31},"
      " %32, %33, p, 1, 1, 0, 0;\n}\n"
      : MXCONV_D32
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t desc_a, uint64_t desc_b,
                                         int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63},"
      " %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}
#undef MXCONV_D32


// ---- host -----------------------------------------------------------------
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

inline EncodeTiledFn encode_tiled_fn() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaError_t err =
        cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (err != cudaSuccess || q != cudaDriverEntryPointSuccess) return nullptr;
    fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// A row-major bf16 matrix (rows x cols, cols contiguous, cols % 8 == 0,
// 16-byte aligned base) as a TMA map with boxes of box_rows x 64 in the
// 128-byte swizzle; boxes past the edge read zeros.  Returns false when
// the encoding is refused.
inline bool encode_rows_b128(CUtensorMap* map, const void* base, long long rows, long long cols,
                             int box_rows) {
  EncodeTiledFn fn = encode_tiled_fn();
  if (fn == nullptr) return false;
  cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  cuuint64_t strides[1] = {(cuuint64_t)cols * 2};
  cuuint32_t box[2] = {(cuuint32_t)BK, (cuuint32_t)box_rows};
  cuuint32_t estr[2] = {1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(base), dims, strides, box,
            estr, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// A bf16 tensor of four dimensions (d0 innermost, contiguous; d1, d2, d3
// at byte strides s1, s2, s3, each a multiple of 16, 16-byte aligned
// base) as a TMA map with boxes of 64 x box_rows x 1 x 1 in the 128-byte
// swizzle; boxes past an edge read zeros.  Bounds are per dimension, so a
// box that runs past d1 reads zeros, never the next (d2, d3) slice.
// Returns false when the encoding is refused.
inline bool encode_4d_b128(CUtensorMap* map, const void* base, const long long (&dims)[4],
                           const long long (&strides)[3], int box_rows) {
  EncodeTiledFn fn = encode_tiled_fn();
  if (fn == nullptr) return false;
  cuuint64_t d[4] = {(cuuint64_t)dims[0], (cuuint64_t)dims[1], (cuuint64_t)dims[2],
                     (cuuint64_t)dims[3]};
  cuuint64_t st[3] = {(cuuint64_t)strides[0], (cuuint64_t)strides[1], (cuuint64_t)strides[2]};
  cuuint32_t box[4] = {(cuuint32_t)BK, (cuuint32_t)box_rows, 1, 1};
  cuuint32_t estr[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), d, st, box, estr,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// ---- deterministic reduction of partial rows --------------------------
// out[g, c] = sum of in[g*128 .. g*128+127, c] for two arrays at once, 32
// channels and 128 rows a block: warp w sums rows 16w..16w+15 in order,
// then warp 0 sums the 8 warps in order.  reduce_stats repeats it on its
// output until one row is left.  The grid and the order depend on the
// shape alone, so the sums are bit-identical from run to run.  TAG only
// names the instance (0: kernel 1's s1/s2, 1: kernel 2's gscale/gbias, 2:
// kernel 6's s1/s2), so a profile tells the kernels' reductions apart;
// each source file instantiates its own TAG, so no instance is compiled
// twice.
constexpr int REDUCE_ROWS = 128;  // partial rows one stats_reduce_kernel block sums

template <int TAG>
__global__ void __launch_bounds__(256) stats_reduce_kernel(const float* in1, const float* in2,
                                                           long long rows, int co_n, float* out1,
                                                           float* out2) {
  __shared__ float r1[8][32];
  __shared__ float r2[8][32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int co = blockIdx.x * 32 + lane;
  const long long first = (long long)blockIdx.y * REDUCE_ROWS + warp * 16;
  float a1 = 0.0f, a2 = 0.0f;
  if (co < co_n) {
    for (int i = 0; i < 16; ++i) {
      const long long r = first + i;
      if (r >= rows) break;
      a1 += in1[r * co_n + co];
      a2 += in2[r * co_n + co];
    }
  }
  r1[warp][lane] = a1;
  r2[warp][lane] = a2;
  __syncthreads();
  if (warp == 0 && co < co_n) {
    float b1 = 0.0f, b2 = 0.0f;
    for (int w = 0; w < 8; ++w) {
      b1 += r1[w][lane];
      b2 += r2[w][lane];
    }
    out1[(long long)blockIdx.y * co_n + co] = b1;
    out2[(long long)blockIdx.y * co_n + co] = b2;
  }
}

// partial rows per array: the tiles' own, then those of each reduction
// pass that leaves more than one row, written after the previous pass's
// (ops/fused_convbn.py::scratch_rows sizes the scratch the same way)
inline long long scratch_rows_for(long long tiles) {
  long long rows = tiles, r = tiles;
  while (r > REDUCE_ROWS) {
    r = (r + REDUCE_ROWS - 1) / REDUCE_ROWS;
    rows += r;
  }
  return rows;
}

// part1/part2 hold `tiles` partial rows of `co` channels each, with room
// for scratch_rows_for(tiles) rows; the sums land in s1/s2
template <int TAG>
cudaError_t reduce_stats(float* part1, float* part2, long long tiles, int co, float* s1, float* s2,
                         cudaStream_t s) {
  const float* in1 = part1;
  const float* in2 = part2;
  float* free1 = part1 + tiles * co;
  float* free2 = part2 + tiles * co;
  long long rows = tiles;
  while (true) {
    const long long g = (rows + REDUCE_ROWS - 1) / REDUCE_ROWS;
    if (g > 65535) return cudaErrorInvalidConfiguration;
    float* o1 = g == 1 ? s1 : free1;
    float* o2 = g == 1 ? s2 : free2;
    stats_reduce_kernel<TAG><<<dim3((co + 31) / 32, (unsigned)g), 256, 0, s>>>(in1, in2, rows, co,
                                                                              o1, o2);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess || g == 1) return err;
    in1 = free1;
    in2 = free2;
    free1 += g * co;
    free2 += g * co;
    rows = g;
  }
}

// ---------------------------------------------------------------------------
// The fused unit's main loop, shared by kernel 1 (fused_convbn.cu) and
// kernel 6 (convbn_tap.cu).  Both compute, for NHWC x (N,H,W,Ci):
//   u  = act_in ? relu(x * in_scale + in_bias) cast to x's type : x, zero
//        padding AFTER the affine (taps outside the image read exactly 0)
//   y  = conv(u, w), fp32 accumulators, stored in x's type
//   s1 = sum y, s2 = sum (y - shift)^2 of the stored y, per m-tile partial
//        rows that reduce_stats sums in a fixed order
// and differ only in how the weights arrive (WL):
//   W_OHWI: w (Co, KH, KW, Ci), the (Co, KH*KW*Ci) matrix with K
//           contiguous: one BN x 64 TMA box a stage, K-major B;
//   W_TAPS: w_taps (KH, KW, Ci, Co), the (KH*KW*Ci, Co) matrix with Co
//           contiguous: BN / 64 boxes of 64 K rows x 64 Co a stage,
//           MN-major B (wgmma's transpose-B form), as kernel 2's wgrad
//           reads dy.
// Each kernel wraps the bodies below in a __global__ of its own name, so
// a profile tells kernels 1 and 6 apart.  fused_convbn.cu's header says
// what the design does and why.
// ---------------------------------------------------------------------------
namespace unit {

enum WeightLayout { W_OHWI = 0, W_TAPS = 1 };

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

// Fills p for one launch with output tiles of bm rows x bn channels;
// returns the number of m-tiles, or 0 for a shape it does not take.
inline long long fill_params(Params& p, const void* x, const void* w, const void* in_scale,
                             const void* in_bias, const void* shift, void* y, void* part1,
                             void* part2, int N, int H, int W, int Ci, int Co, int KH, int KW,
                             int SH, int SW, int PH, int PW, int act_in, int want_stats, int bm,
                             int bn) {
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
  if (N <= 0 || Ci <= 0 || Co <= 0 || KH <= 0 || KW <= 0 || SH <= 0 || SW <= 0) return 0;
  p.Ho = (H + 2 * PH - KH) / SH + 1;
  p.Wo = (W + 2 * PW - KW) / SW + 1;
  p.M = (long long)N * p.Ho * p.Wo;
  p.act_in = act_in;
  p.want_stats = want_stats;
  p.vec = (Ci % 8 == 0) && ((uintptr_t)x % 16 == 0);
  if (p.M <= 0 || p.Ho <= 0 || p.Wo <= 0 || bm <= 0 || bn <= 0) return 0;
  p.n_tiles = (Co + bn - 1) / bn;
  return (p.M + bm - 1) / bm;
}

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

// The persistent bf16 body: block b computes tiles b, b + gridDim.x, ...
// (the Co tile fastest), and the ring runs on across tiles, so the
// producer loads the next tile while the consumers finish the last one.
// One 384-thread block an SM at BM 128 (its consumers hold 64 fp32
// accumulators a thread at BN 128); two 256-thread blocks at BM 64.
// `smem_raw` is the kernel's dynamic shared memory.  p comes by value, as
// the kernel's own parameter does: the compiler then knows no store or
// memory clobber changes it.
template <int BM, int BN, int WL>
__device__ __forceinline__ void wgmma_body(const CUtensorMap& wmap, const Params p,
                                           long long tiles, unsigned char* smem_raw) {
  using T = WgmmaTile<BM, BN>;
  constexpr int NC = T::NC;
  constexpr int NACC = BN / 2;
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
    // ---- producer warpgroup: x rows by cp.async, the weight boxes by TMA
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
          if constexpr (WL == W_TAPS) {
            // K rows tap*Ci + ci0 .. +63 of (KH*KW*Ci, Co), 64 Co a box;
            // rows past this tap's Ci meet zero columns of A
#pragma unroll
            for (int b = 0; b < BN / 64; ++b)
              tma_load_2d(sa + T::A_BYTES + b * 64 * ROW_BYTES, &wmap, full, co0 + b * 64,
                          tap * p.Ci + ci0);
          } else {
            tma_load_2d(sa + T::A_BYTES, &wmap, full, tap * p.Ci + ci0, co0);
          }
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
      if constexpr (WL == W_TAPS) {
        // B MN-major: k16 step kk is K rows 16kk.. of each 64-row box, the
        // next 64 Co one box (64 rows x 128 bytes) further on
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_rs<1>(acc, a[kk], b128_mn_desc(sb + kk * 16 * ROW_BYTES, 64 * ROW_BYTES), 1);
      } else {
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) wgmma_rs(acc, a[kk], b128_desc(sb + kk * 32), 1);
      }
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

// Launches the persistent kernel `kern` (a __global__ around wgmma_body):
// as many blocks as fit on the card at once, or one a tile.  `attr` is
// the caller's flag that the kernel's shared-memory limit is raised
// (idempotent: a race sets the same value twice).
template <int BM, int BN, typename Kernel>
inline cudaError_t launch_wgmma_unit(Kernel kern, bool& attr, const CUtensorMap& map,
                                     const Params& p, long long tiles, cudaStream_t s) {
  using T = WgmmaTile<BM, BN>;
  const size_t smem = T::smem_bytes(p.Ci, p.Co);
  if (smem > (size_t)MAX_SMEM) return cudaErrorInvalidValue;
  if (!attr) {
    cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, MAX_SMEM);
    if (err != cudaSuccess) return err;
    attr = true;
  }
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

// ---- fp32: FMA units (tensor cores would round it to TF32), 128 x 64
// tiles, 32 channels a K step, loads into padded shared memory
constexpr int F_BM = 128;
constexpr int F_BN = 64;
constexpr int F_BK = 32;
constexpr int F_THREADS = 256;
constexpr int F_A_LD = F_BK + 8;  // smem row pitches (elements), padded
constexpr int F_B_LD = F_BN + 8;
constexpr int F_C_LD = F_BN + 4;

// One F_BM x F_BN tile a block: grid (m-tiles, Co tiles).
template <int WL>
__device__ __forceinline__ void fma_body(const Params p) {
  constexpr int A_BYTES = F_BM * F_A_LD * 4;
  constexpr int B_BYTES = F_BK * F_B_LD * 4;
  constexpr int C_BYTES = F_BM * F_C_LD * 4;
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
            float* dst = sA + r * F_A_LD + c;
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
        // ---- B tile (BK x BN)
        if constexpr (WL == W_TAPS) {
          // w_taps[ky, kx, ci, co], co fastest across the threads
          const int n = tid & 63;
          const int co = co0 + n;
          const float* w_tap = w + (long long)(ky * p.KW + kx) * p.Ci * p.Co;
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const int k = (tid >> 6) + 4 * j;
            const int ci = ci0 + k;
            float v = 0.0f;
            if (ci < p.Ci && co < p.Co) v = w_tap[(long long)ci * p.Co + co];
            sB[k * F_B_LD + n] = v;
          }
        } else {
          // w[co, ky, kx, ci], ci fastest across a warp
          const int k = tid & 31;
          const int ci = ci0 + k;
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const int n = (tid >> 5) + 8 * j;
            const int co = co0 + n;
            float v = 0.0f;
            if (ci < p.Ci && co < p.Co) v = w[((long long)co * khw + ky * p.KW + kx) * p.Ci + ci];
            sB[k * F_B_LD + n] = v;
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

  // ---- epilogue: tile -> smem, store y, per-block column sums
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) sC[(ty * 8 + i) * F_C_LD + tx * 4 + j] = facc[i][j];
  __syncthreads();

  float* y = static_cast<float*>(p.y);
  for (int e = tid; e < F_BM * F_BN; e += F_THREADS) {
    const int r = e / F_BN;
    const int c = e - r * F_BN;
    const long long m = m0 + r;
    const int co = co0 + c;
    if (m < p.M && co < p.Co) y[m * p.Co + co] = sC[r * F_C_LD + c];
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
        const float v = sC[r * F_C_LD + tid];
        const float d = v - sh;
        a1 += v;
        a2 = fmaf(d, d, a2);
      }
      p.part1[(long long)blockIdx.x * p.Co + co] = a1;
      p.part2[(long long)blockIdx.x * p.Co + co] = a2;
    }
  }
}

}  // namespace unit

}  // namespace mxconv
