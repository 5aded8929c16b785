// Warp-level tensor-core primitives for sm_90a, shared by the bf16 bodies of
// window_attn.cu and zwin_conv.cu: 16-byte cp.async into shared memory
// (zero-filled when the source size is 0), ldmatrix (plain and transposed)
// and mma.sync m16n8k16 with bf16 inputs and fp32 accumulators.
//
// Fragment layouts (PTX ISA, mma.m16n8k16 with .bf16), for lane l,
// g = l / 4 and q = l % 4:
//   A (16 x 16, row-major), 4 regs: a0 (row g, cols 2q, 2q+1),
//     a1 (row g+8, cols 2q..), a2 (row g, cols 8+2q..), a3 (row g+8, 8+2q..)
//   B (16 x 8, k x n), 2 regs: b0 (k 2q, 2q+1; n g), b1 (k 8+2q..; n g)
//   C (16 x 8, fp32), 4 floats: c0, c1 (row g, cols 2q, 2q+1), c2, c3
//     (row g+8, cols 2q, 2q+1)
// The lower 16 bits of each register hold the element of lower index.
#pragma once

#include <cuda_bf16.h>
#include <cstdint>

namespace tc {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte async copy global -> shared; src_bytes 0 writes 16 zero bytes.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// Wait until at most N committed groups of this thread are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Four 8x8 b16 matrices; lanes 8m..8m+7 give the row addresses of matrix m,
// and register m receives (row l / 4, cols 2(l % 4), +1) of matrix m.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// The same, transposed: register m receives (rows 2(l % 4), +1; col l / 4)
// of matrix m, i.e. a B fragment of a matrix stored k-major.
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// d += a * b, m16n8k16, bf16 in, fp32 accumulate.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two floats as a bf16x2 register, lo in the lower half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

}  // namespace tc
