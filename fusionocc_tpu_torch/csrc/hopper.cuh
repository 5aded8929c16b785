// Hopper (sm_90a) primitives shared by the bf16 bodies of window_attn.cu and
// zwin_conv.cu: mbarriers, TMA tensor and bulk copies completed on them,
// ldmatrix, and the warpgroup products (wgmma) with their shared-memory
// operand descriptors.  Host side: cuTensorMapEncodeTiled and
// cuTensorMapReplaceAddress, fetched through the runtime
// (cudaGetDriverEntryPoint), so the library links no -lcuda.
//
// Fragment layouts (PTX ISA).  Warp w of a warpgroup holds rows 16w..16w+15
// of an m64 tile; for lane l, g = l / 4 and q = l % 4:
//   A in registers (m64 x k16 bf16), 4 regs: a0 (row g, cols 2q, 2q+1),
//     a1 (row g+8, cols 2q..), a2 (row g, cols 8+2q..), a3 (row g+8, 8+2q..)
//     -- what ldmatrix.x4 gives when lanes 0-15 point at rows 0-15, k chunk
//     0, and lanes 16-31 at rows 0-15, k chunk 1;
//   accumulator (m64 x n, fp32), n / 2 floats: d[4j + 0, 1] (row g, cols
//     8j + 2q, +1), d[4j + 2, 3] (row g + 8, the same cols).
// The lower 16 bits of a bf16x2 register hold the element of lower index.
//
// Shared-memory operands are described by 64-bit descriptors: start address
// >> 4 (bits 0-13), leading byte offset >> 4 (16-29), stride byte offset >> 4
// (32-45), swizzle (62-63: 1 = 128 B, 2 = 64 B, 3 = 32 B).  A K-major operand
// (K contiguous) with rows of S bytes and an S-byte swizzle has 8-row groups
// SBO = 8 S apart; a k16 step inside the row moves the start by 32 bytes.  An
// MN-major operand (B read transposed) has its 8-row K groups SBO apart; its
// LBO is the stride between MN atoms, unused when N fits one atom.  TMA
// writes a tile with the matching swizzle (CU_TENSOR_MAP_SWIZZLE_32B/64B:
// 16-byte chunk c of row r lands at chunk c ^ ((r >> s) & m)), so the
// descriptors read what it wrote as long as each tile starts on the
// swizzle's repeat (256 B for 32 B, 512 B for 64 B).
#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cstdint>
#include <mutex>

namespace hw {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---------------------------------------------------------------- mbarrier

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(count)
               : "memory");
}

// Makes the initialised barriers visible to the async proxy (TMA).
__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}

// One arrival that also expects `bytes` more of copies to complete.
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar,
                                                      uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}

// Waits until the phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_addr(bar);
  asm volatile(
      "{\n"
      ".reg .pred done;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@done bra DONE;\n"
      "bra WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(addr),
      "r"(parity)
      : "memory");
}

// ------------------------------------------------------------ async copies

// A 3-D TMA tile load (coordinates innermost first), completed on `bar`.
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0),
      "r"(c1), "r"(c2)
      : "memory");
}

// A contiguous copy of `bytes` (a multiple of 16, both ends 16-byte
// aligned) from global to shared memory, completed on `bar`.
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// Four 8x8 b16 matrices; lanes 8m..8m+7 give the row addresses of matrix m,
// and register m receives (row l / 4, cols 2(l % 4), +1) of matrix m.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// Two floats as a bf16x2 register, lo in the lower half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// -------------------------------------------------------------------- wgmma

enum : uint32_t { SWIZZLE_128B = 1, SWIZZLE_64B = 2, SWIZZLE_32B = 3 };

__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo, uint32_t swizzle) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | ((uint64_t)swizzle << 62);
}

// Orders this thread's register and shared-memory writes before the
// warpgroup's next wgmma.
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// Waits until at most N committed groups of this warpgroup are in flight.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Register budgets of a warpgroup (a multiple of 8 in [24, 256]): the
// producer gives registers back, the consumers take them.
template <int N>
__device__ __forceinline__ void regs_dealloc() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}
template <int N>
__device__ __forceinline__ void regs_alloc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

// 2^x by the SFU (ex2.approx.ftz: relative error below 2^-22, results
// below 2^-126 flushed to zero).
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// d (m64 x 144, fp32) += a (m64 x k16) * b (k16 x 144), both bf16 K-major
// in shared memory.
__device__ __forceinline__ void wgmma_m64n144k16_ss(float (&d)[72],
    uint64_t desc_a, uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %74, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n144k16.f32.bf16.bf16 "
      "{" 
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71"
      "}, %72, %73, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]),
        "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
        "+f"(d[70]), "+f"(d[71])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// d (m64 x 8, fp32) += a (m64 x k16 bf16, registers) * b (k16 x 8 bf16,
// smem descriptor); TRANS_B 1 reads b MN-major.
template <int TRANS_B>
__device__ __forceinline__ void wgmma_m64n8k16_rs(float (&d)[4],
    const uint32_t (&a)[4], uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %9, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 "
      "{" 
      "%0, %1, %2, %3"
      "}, {%4, %5, %6, %7}, %8, p, 1, 1, %10;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d),
        "n"(TRANS_B));
}

// d (m64 x 16, fp32) += a (m64 x k16 bf16, registers) * b (k16 x 16 bf16,
// smem descriptor); TRANS_B 1 reads b MN-major.
template <int TRANS_B>
__device__ __forceinline__ void wgmma_m64n16k16_rs(float (&d)[8],
    const uint32_t (&a)[4], uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{" 
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, {%8, %9, %10, %11}, %12, p, 1, 1, %14;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d),
        "n"(TRANS_B));
}

// d (m64 x 24, fp32) += a (m64 x k16 bf16, registers) * b (k16 x 24 bf16,
// smem descriptor); TRANS_B 1 reads b MN-major.
template <int TRANS_B>
__device__ __forceinline__ void wgmma_m64n24k16_rs(float (&d)[12],
    const uint32_t (&a)[4], uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %17, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n24k16.f32.bf16.bf16 "
      "{" 
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11"
      "}, {%12, %13, %14, %15}, %16, p, 1, 1, %18;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d),
        "n"(TRANS_B));
}

// d (m64 x 32, fp32) += a (m64 x k16 bf16, registers) * b (k16 x 32 bf16,
// smem descriptor); TRANS_B 1 reads b MN-major.
template <int TRANS_B>
__device__ __forceinline__ void wgmma_m64n32k16_rs(float (&d)[16],
    const uint32_t (&a)[4], uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{" 
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, %22;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d),
        "n"(TRANS_B));
}

// d (m64 x 40, fp32) += a (m64 x k16 bf16, registers) * b (k16 x 40 bf16,
// smem descriptor); TRANS_B 1 reads b MN-major.
template <int TRANS_B>
__device__ __forceinline__ void wgmma_m64n40k16_rs(float (&d)[20],
    const uint32_t (&a)[4], uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %25, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n40k16.f32.bf16.bf16 "
      "{" 
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19"
      "}, {%20, %21, %22, %23}, %24, p, 1, 1, %26;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d),
        "n"(TRANS_B));
}

// d (m64 x 48, fp32) += a (m64 x k16 bf16, registers) * b (k16 x 48 bf16,
// smem descriptor); TRANS_B 1 reads b MN-major.
template <int TRANS_B>
__device__ __forceinline__ void wgmma_m64n48k16_rs(float (&d)[24],
    const uint32_t (&a)[4], uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %29, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n48k16.f32.bf16.bf16 "
      "{" 
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23"
      "}, {%24, %25, %26, %27}, %28, p, 1, 1, %30;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d),
        "n"(TRANS_B));
}

// d (m64 x 56, fp32) += a (m64 x k16 bf16, registers) * b (k16 x 56 bf16,
// smem descriptor); TRANS_B 1 reads b MN-major.
template <int TRANS_B>
__device__ __forceinline__ void wgmma_m64n56k16_rs(float (&d)[28],
    const uint32_t (&a)[4], uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %33, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n56k16.f32.bf16.bf16 "
      "{" 
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27"
      "}, {%28, %29, %30, %31}, %32, p, 1, 1, %34;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d),
        "n"(TRANS_B));
}

// d (m64 x 64, fp32) += a (m64 x k16 bf16, registers) * b (k16 x 64 bf16,
// smem descriptor); TRANS_B 1 reads b MN-major.
template <int TRANS_B>
__device__ __forceinline__ void wgmma_m64n64k16_rs(float (&d)[32],
    const uint32_t (&a)[4], uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{" 
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d),
        "n"(TRANS_B));
}

// d (m64 x 8 NT, fp32) += a (registers) * b (descriptor), by NT.
template <int NT, int TRANS_B>
__device__ __forceinline__ void wgmma_rs(float (&d)[NT * 4],
                                         const uint32_t (&a)[4],
                                         uint64_t desc_b, int scale_d) {
  if constexpr (NT == 1) wgmma_m64n8k16_rs<TRANS_B>(d, a, desc_b, scale_d);
  if constexpr (NT == 2) wgmma_m64n16k16_rs<TRANS_B>(d, a, desc_b, scale_d);
  if constexpr (NT == 3) wgmma_m64n24k16_rs<TRANS_B>(d, a, desc_b, scale_d);
  if constexpr (NT == 4) wgmma_m64n32k16_rs<TRANS_B>(d, a, desc_b, scale_d);
  if constexpr (NT == 5) wgmma_m64n40k16_rs<TRANS_B>(d, a, desc_b, scale_d);
  if constexpr (NT == 6) wgmma_m64n48k16_rs<TRANS_B>(d, a, desc_b, scale_d);
  if constexpr (NT == 7) wgmma_m64n56k16_rs<TRANS_B>(d, a, desc_b, scale_d);
  if constexpr (NT == 8) wgmma_m64n64k16_rs<TRANS_B>(d, a, desc_b, scale_d);
}

// ------------------------------------------------------------------- host

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// A driver entry point by name, from the driver the runtime uses; null if
// absent.
inline void* driver_entry(const char* name) {
  void* p = nullptr;
  cudaDriverEntryPointQueryResult found;
  if (cudaGetDriverEntryPoint(name, &p, cudaEnableDefault, &found) !=
          cudaSuccess ||
      found != cudaDriverEntryPointSuccess)
    return nullptr;
  return p;
}

inline EncodeTiled encode_tiled() {
  static const EncodeTiled fn =
      reinterpret_cast<EncodeTiled>(driver_entry("cuTensorMapEncodeTiled"));
  return fn;
}

using ReplaceAddress = CUresult (*)(CUtensorMap*, void*);

inline ReplaceAddress replace_address() {
  static const ReplaceAddress fn = reinterpret_cast<ReplaceAddress>(
      driver_entry("cuTensorMapReplaceAddress"));
  return fn;
}

// The current device's SM count and `kernel`'s resident CTAs per SM at
// `threads` threads and `smem` bytes of dynamic shared memory, after its
// dynamic shared-memory limit is raised to the device's: queried once per
// (kernel, device, smem) and kept, so a launch pays no attribute or
// occupancy call (the answers only size a persistent grid).
inline cudaError_t resident_ctas(const void* kernel, int threads,
                                 size_t smem, int* sms, int* per_sm) {
  struct Entry {
    const void* kernel;
    int dev;
    size_t smem;
    int sms, per_sm;
  };
  static Entry cache[256];
  static int entries = 0;
  static std::mutex lock;
  const std::lock_guard<std::mutex> held(lock);
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  for (int i = 0; i < entries; ++i)
    if (cache[i].kernel == kernel && cache[i].dev == dev &&
        cache[i].smem == smem) {
      *sms = cache[i].sms;
      *per_sm = cache[i].per_sm;
      return cudaSuccess;
    }
  int limit = 0;
  err = cudaDeviceGetAttribute(&limit,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, limit);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, kernel,
                                                        threads, smem);
  if (err != cudaSuccess) return err;
  if (entries < 256) cache[entries++] = Entry{kernel, dev, smem, *sms, *per_sm};
  return cudaSuccess;
}

// A 3-D bf16 tensor map: dims and box innermost first, strides (bytes) of
// dims 1 and 2; elements past a dim read as zeros.  Encoded once per
// (dims, strides, box, swizzle) and kept: a launch copies the kept map and
// swaps its base in with cuTensorMapReplaceAddress, so it pays no encode.
// False when the driver refuses it (unaligned base or strides, box too
// large).
inline bool encode_bf16_3d(CUtensorMap* map, const void* base,
                           const uint64_t (&dims)[3],
                           const uint64_t (&strides)[2],
                           const uint32_t (&box)[3],
                           CUtensorMapSwizzle swizzle) {
  struct Entry {
    CUtensorMap map;
    uint64_t dims[3], strides[2];
    uint32_t box[3];
    CUtensorMapSwizzle swizzle;
  };
  constexpr int SLOTS = 64;          // a model's launch geometries
  static Entry cache[SLOTS];
  static int entries = 0, next = 0;
  static std::mutex lock;
  const EncodeTiled encode = encode_tiled();
  const ReplaceAddress replace = replace_address();
  if (encode == nullptr || replace == nullptr) return false;
  const std::lock_guard<std::mutex> held(lock);
  for (int i = 0; i < entries; ++i) {
    const Entry& e = cache[i];
    if (e.swizzle == swizzle && e.dims[0] == dims[0] &&
        e.dims[1] == dims[1] && e.dims[2] == dims[2] &&
        e.strides[0] == strides[0] && e.strides[1] == strides[1] &&
        e.box[0] == box[0] && e.box[1] == box[1] && e.box[2] == box[2]) {
      *map = e.map;
      return replace(map, const_cast<void*>(base)) == CUDA_SUCCESS;
    }
  }
  const cuuint64_t d[3] = {dims[0], dims[1], dims[2]};
  const cuuint64_t s[2] = {strides[0], strides[1]};
  const cuuint32_t b[3] = {box[0], box[1], box[2]};
  const cuuint32_t e[3] = {1, 1, 1};
  if (encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
             const_cast<void*>(base), d, s, b, e,
             CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
             CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return false;
  Entry& slot = cache[entries < SLOTS ? entries++ : next++ % SLOTS];
  slot.map = *map;
  for (int i = 0; i < 3; ++i) slot.dims[i] = dims[i], slot.box[i] = box[i];
  slot.strides[0] = strides[0];
  slot.strides[1] = strides[1];
  slot.swizzle = swizzle;
  return true;
}

}  // namespace hw
