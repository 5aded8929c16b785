// Shifted-window attention forward for Swin.
//
// Replaces the TPU kernel fusionocc_tpu/ops/pallas/window_attn.py::_attn_kernel.
// Per window and head:
//
//   out = softmax_fp32(q * scale @ k^T + bias[h] + shift_mask) @ v
//
// with heads packed in C (q, k, v are column slices of the qkv projection,
// read through their row strides, so no copy is made).  The mmcv cyclic-shift
// mask (-100 between tokens of different regions) is rebuilt from the flat
// window index exactly as _shift_mask does: r = (win / nWw) % nWh,
// c = win % nWw; only the last window row/column is split into regions.
//
// Two bodies, chosen by dtype:
//
// bf16 (the main path): tensor cores, mma.sync m16n8k16.  What bounds the
// work is arithmetic: 4 * N^2 * head_dim flops per (window, head) against
// 6 * N * head_dim bytes of q, k, v.  One CTA takes one head and a run of
// windows.  It stages bias[h] (fp32, rows padded to NP + 8 floats so that
// the fragment reads are conflict-free) in shared memory once, then loops
// over its windows; each window's q, k and v tiles (N x 32 bf16) come in by
// 16-byte cp.async, double-buffered so that the next window loads while this
// one computes.  Rows of 64 bytes are stored with their four 16-byte chunks
// XOR-swizzled by (row / 2) % 4, so every ldmatrix phase hits 32 banks.  The
// N tokens are padded to NP = 144 = 9 x 16 (zero rows, keys past N scored
// -inf, query rows past N not stored); each of the 9 warps owns one 16-row
// m-tile.  S = Q K^T (18 n-tiles x 2 k-steps, K by ldmatrix) stays in
// registers, a full 144-wide row per quad; scale, bias and shift mask are
// added in fp32 and the softmax is exact (max and sum reduced over the
// quad, no online rescaling).  P is repacked in registers as A fragments for
// O = P V (9 k-steps x 4 n-tiles, V by ldmatrix.trans), split into a bf16
// high part and a bf16 low part (P - high), two products: P in bf16 alone,
// as SDPA and FlashAttention take it, is 2^-9 off per probability, and where
// few keys carry a row with values of both signs that puts the output two
// bf16 ulps off the fp32 softmax of the contract.  O is normalised in fp32
// and stored as bf16.
//
// fp32: the CUDA-core body.  One CTA per (window, head), K and V of the head
// in shared memory, one thread per query row with an online fp32 softmax.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <algorithm>
#include <cmath>
#include <cstdint>

#include "tensor_core.cuh"

namespace {

constexpr int D = 32;            // head_dim of both bodies
constexpr int NT = 9;            // bf16 body: 16-row tiles, N <= NP
constexpr int NP = NT * 16;      // 144 = 12 x 12 windows
constexpr int WARPS = NT;        // one m-tile per warp
constexpr int BS = NP + 8;       // bias row stride in floats (mod 32 = 24)
constexpr int TILE_BYTES = NP * D * 2;   // one of q, k, v for one window
constexpr float LOG2E = 1.4426950408889634f;

// mmcv img_mask region id of token `tok` of a window; last_r / last_c say
// whether the window is the last one along its row / column axis.
__device__ __forceinline__ int region_id(int tok, int w, int shift,
                                         bool last_r, bool last_c) {
  const int py = tok / w, px = tok % w;
  const int ry = last_r ? (py < w - shift ? 1 : 2) : 0;
  const int rx = last_c ? (px < w - shift ? 1 : 2) : 0;
  return ry * 3 + rx;
}

// Byte offset of 16-byte chunk c (0..3) of token row r in a q/k/v tile.
__device__ __forceinline__ uint32_t tile_offset(int r, int c) {
  return r * (D * 2) + ((c ^ ((r >> 1) & 3)) << 4);
}

__global__ void __launch_bounds__(WARPS * 32, 1)
    window_attn_mma_kernel(const __nv_bfloat16* __restrict__ q,
                           const __nv_bfloat16* __restrict__ k,
                           const __nv_bfloat16* __restrict__ v,
                           const float* __restrict__ bias,
                           __nv_bfloat16* __restrict__ out, int Bn, int N,
                           int C, int64_t stride_win, int64_t stride_tok,
                           int nWh, int nWw, int w, int shift, float scale,
                           int wins_per_cta) {
  extern __shared__ __align__(16) uint8_t smem[];
  uint8_t* tiles = smem;                                  // [2][3] tiles
  float* bias_s = reinterpret_cast<float*>(smem + 6 * TILE_BYTES);
  uint8_t* ry_s = smem + 6 * TILE_BYTES + NP * BS * 4;    // (NP,)
  uint8_t* rx_s = ry_s + NP;                              // (NP,)

  const int h = blockIdx.y;
  const int win0 = blockIdx.x * wins_per_cta;
  const int win1 = min(win0 + wins_per_cta, Bn);
  if (win0 >= win1) return;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nthreads = WARPS * 32;
  const uint32_t tiles_addr = tc::smem_addr(tiles);

  auto load_window = [&](int win, int buf) {
    const int64_t base = (int64_t)win * stride_win + (int64_t)h * D;
    for (int idx = tid; idx < 3 * NP * 4; idx += nthreads) {
      const int which = idx / (NP * 4);
      const int rem = idx - which * NP * 4;
      const int r = rem >> 2, c = rem & 3;
      const __nv_bfloat16* src = which == 0 ? q : (which == 1 ? k : v);
      const bool ok = r < N;
      const uint32_t dst =
          tiles_addr + (buf * 3 + which) * TILE_BYTES + tile_offset(r, c);
      tc::cp_async16(dst, ok ? src + base + (int64_t)r * stride_tok + c * 8 : q,
                     ok ? 16 : 0);
    }
  };
  load_window(win0, 0);
  tc::cp_async_commit();

  for (int idx = tid; idx < NP * NP; idx += nthreads) {
    const int i = idx / NP, j = idx - i * NP;
    bias_s[i * BS + j] =
        (i < N && j < N) ? bias[((int64_t)h * N + i) * N + j] : 0.f;
  }
  for (int j = tid; j < NP; j += nthreads) {
    ry_s[j] = j / w < w - shift ? 1 : 2;
    rx_s[j] = j % w < w - shift ? 1 : 2;
  }

  const int g = lane >> 2, qd = lane & 3;
  const int rA = warp * 16 + g, rB = rA + 8;   // this thread's two rows
  const float* bA = bias_s + rA * BS;
  const float* bB = bias_s + rB * BS;

  for (int win = win0; win < win1; ++win) {
    const int buf = (win - win0) & 1;
    if (win + 1 < win1) load_window(win + 1, buf ^ 1);
    tc::cp_async_commit();
    tc::cp_async_wait<1>();
    __syncthreads();

    const uint32_t qs = tiles_addr + (buf * 3 + 0) * TILE_BYTES;
    const uint32_t ks = tiles_addr + (buf * 3 + 1) * TILE_BYTES;
    const uint32_t vs = tiles_addr + (buf * 3 + 2) * TILE_BYTES;

    // S = Q K^T for this warp's 16 rows, all NP keys.
    uint32_t qa[2][4];
#pragma unroll
    for (int kk = 0; kk < 2; ++kk) {
      const int r = warp * 16 + (lane & 15);
      tc::ldmatrix_x4(qa[kk], qs + tile_offset(r, kk * 2 + (lane >> 4)));
    }
    float s[2 * NT][4];
#pragma unroll
    for (int nt = 0; nt < 2 * NT; ++nt) {
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
      uint32_t kb[4];
      tc::ldmatrix_x4(kb, ks + tile_offset(nt * 8 + (lane & 7), lane >> 3));
      tc::mma_bf16(s[nt], qa[0], kb[0], kb[1]);
      tc::mma_bf16(s[nt], qa[1], kb[2], kb[3]);
    }

    // scale, bias, shift mask, padding; exact fp32 softmax over the row
    const int wr = (win / nWw) % nWh, wc = win % nWw;
    const bool last_r = wr == nWh - 1, last_c = wc == nWw - 1;
    const bool masked = shift > 0 && (last_r || last_c);
    int ridA = 0, ridB = 0;
    if (masked) {
      ridA = (last_r ? ry_s[rA] : 0) * 3 + (last_c ? rx_s[rA] : 0);
      ridB = (last_r ? ry_s[rB] : 0) * 3 + (last_c ? rx_s[rB] : 0);
    }
    float mA = -INFINITY, mB = -INFINITY;
#pragma unroll
    for (int nt = 0; nt < 2 * NT; ++nt) {
      const int j = nt * 8 + 2 * qd;
      const float2 ba = *reinterpret_cast<const float2*>(bA + j);
      const float2 bb = *reinterpret_cast<const float2*>(bB + j);
      s[nt][0] = fmaf(s[nt][0], scale, ba.x);
      s[nt][1] = fmaf(s[nt][1], scale, ba.y);
      s[nt][2] = fmaf(s[nt][2], scale, bb.x);
      s[nt][3] = fmaf(s[nt][3], scale, bb.y);
      if (masked) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int rj = (last_r ? ry_s[j + e] : 0) * 3 +
                         (last_c ? rx_s[j + e] : 0);
          if (rj != ridA) s[nt][e] += -100.f;
          if (rj != ridB) s[nt][2 + e] += -100.f;
        }
      }
      if (j >= N) s[nt][0] = s[nt][2] = -INFINITY;
      if (j + 1 >= N) s[nt][1] = s[nt][3] = -INFINITY;
      mA = fmaxf(mA, fmaxf(s[nt][0], s[nt][1]));
      mB = fmaxf(mB, fmaxf(s[nt][2], s[nt][3]));
    }
#pragma unroll
    for (int o = 1; o <= 2; o <<= 1) {
      mA = fmaxf(mA, __shfl_xor_sync(0xffffffffu, mA, o));
      mB = fmaxf(mB, __shfl_xor_sync(0xffffffffu, mB, o));
    }
    const float oA = -mA * LOG2E, oB = -mB * LOG2E;
    float lA = 0.f, lB = 0.f;
#pragma unroll
    for (int nt = 0; nt < 2 * NT; ++nt) {
      s[nt][0] = exp2f(fmaf(s[nt][0], LOG2E, oA));
      s[nt][1] = exp2f(fmaf(s[nt][1], LOG2E, oA));
      s[nt][2] = exp2f(fmaf(s[nt][2], LOG2E, oB));
      s[nt][3] = exp2f(fmaf(s[nt][3], LOG2E, oB));
      lA += s[nt][0] + s[nt][1];
      lB += s[nt][2] + s[nt][3];
    }
#pragma unroll
    for (int o = 1; o <= 2; o <<= 1) {
      lA += __shfl_xor_sync(0xffffffffu, lA, o);
      lB += __shfl_xor_sync(0xffffffffu, lB, o);
    }

    // O = P V: P's C fragments repacked as A fragments (high and low bf16
    // parts), V by ldmatrix.trans
    float o[4][4];
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) o[nt][0] = o[nt][1] = o[nt][2] = o[nt][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < NT; ++kk) {
      const float* p0 = s[2 * kk];       // A fragment: a0, a1 from n-tile 2kk,
      const float* p1 = s[2 * kk + 1];   // a2, a3 from n-tile 2kk + 1
      const float h[8] = {tc::round_bf16(p0[0]), tc::round_bf16(p0[1]),
                          tc::round_bf16(p0[2]), tc::round_bf16(p0[3]),
                          tc::round_bf16(p1[0]), tc::round_bf16(p1[1]),
                          tc::round_bf16(p1[2]), tc::round_bf16(p1[3])};
      const uint32_t hi[4] = {tc::pack_bf16(h[0], h[1]),
                              tc::pack_bf16(h[2], h[3]),
                              tc::pack_bf16(h[4], h[5]),
                              tc::pack_bf16(h[6], h[7])};
      const uint32_t lo[4] = {tc::pack_bf16(p0[0] - h[0], p0[1] - h[1]),
                              tc::pack_bf16(p0[2] - h[2], p0[3] - h[3]),
                              tc::pack_bf16(p1[0] - h[4], p1[1] - h[5]),
                              tc::pack_bf16(p1[2] - h[6], p1[3] - h[7])};
#pragma unroll
      for (int dp = 0; dp < 2; ++dp) {
        uint32_t vb[4];
        const int r = kk * 16 + ((lane >> 3) & 1) * 8 + (lane & 7);
        tc::ldmatrix_x4_trans(vb, vs + tile_offset(r, dp * 2 + (lane >> 4)));
        tc::mma_bf16(o[2 * dp], hi, vb[0], vb[1]);
        tc::mma_bf16(o[2 * dp + 1], hi, vb[2], vb[3]);
        tc::mma_bf16(o[2 * dp], lo, vb[0], vb[1]);
        tc::mma_bf16(o[2 * dp + 1], lo, vb[2], vb[3]);
      }
    }

    const float iA = 1.f / lA, iB = 1.f / lB;
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const int d = nt * 8 + 2 * qd;
      if (rA < N)
        *reinterpret_cast<uint32_t*>(
            out + ((int64_t)win * N + rA) * C + h * D + d) =
            tc::pack_bf16(o[nt][0] * iA, o[nt][1] * iA);
      if (rB < N)
        *reinterpret_cast<uint32_t*>(
            out + ((int64_t)win * N + rB) * C + h * D + d) =
            tc::pack_bf16(o[nt][2] * iB, o[nt][3] * iB);
    }
    __syncthreads();                  // this buffer is refilled next window
  }
}

__global__ void window_attn_fp32_kernel(const float* __restrict__ q,
                                        const float* __restrict__ k,
                                        const float* __restrict__ v,
                                        const float* __restrict__ bias,
                                        float* __restrict__ out, int N, int C,
                                        int64_t stride_win, int64_t stride_tok,
                                        int nWh, int nWw, int w, int shift,
                                        float scale) {
  extern __shared__ float smem_f[];
  float* ks = smem_f;                        // (N, D)
  float* vs = smem_f + N * D;                // (N, D)
  int* rid = (int*)(smem_f + 2 * N * D);     // (N,)

  const int win = blockIdx.x;
  const int h = blockIdx.y;
  const int64_t base = (int64_t)win * stride_win + (int64_t)h * D;
  const bool last_r = ((win / nWw) % nWh) == nWh - 1;
  const bool last_c = (win % nWw) == nWw - 1;

  for (int idx = threadIdx.x; idx < N * D; idx += blockDim.x) {
    const int j = idx / D, d = idx % D;
    const int64_t off = base + (int64_t)j * stride_tok + d;
    ks[idx] = k[off];
    vs[idx] = v[off];
  }
  for (int j = threadIdx.x; j < N; j += blockDim.x) {
    rid[j] = shift > 0 ? region_id(j, w, shift, last_r, last_c) : 0;
  }
  __syncthreads();

  const int i = threadIdx.x;
  if (i >= N) return;

  float qr[D];
  const float* qrow = q + base + (int64_t)i * stride_tok;
#pragma unroll
  for (int d = 0; d < D; ++d) qr[d] = qrow[d] * scale;

  const int my_rid = rid[i];
  const float* brow = bias + ((int64_t)h * N + i) * N;
  float m = -INFINITY, l = 0.f;
  float acc[D];
#pragma unroll
  for (int d = 0; d < D; ++d) acc[d] = 0.f;

  for (int j = 0; j < N; ++j) {
    const float* kr = ks + j * D;
    float s = 0.f;
#pragma unroll
    for (int d = 0; d < D; ++d) s = fmaf(qr[d], kr[d], s);
    s += brow[j];
    if (rid[j] != my_rid) s += -100.f;
    const float m_new = fmaxf(m, s);
    const float corr = expf(m - m_new);
    const float p = expf(s - m_new);
    l = l * corr + p;
    const float* vr = vs + j * D;
#pragma unroll
    for (int d = 0; d < D; ++d) acc[d] = fmaf(acc[d], corr, p * vr[d]);
    m = m_new;
  }

  const float inv = 1.f / l;
  float* orow = out + ((int64_t)win * N + i) * C + (int64_t)h * D;
#pragma unroll
  for (int d = 0; d < D; ++d) orow[d] = acc[d] * inv;
}

int launch_fp32(const void* q, const void* k, const void* v,
                const float* bias, void* out, int Bn, int N, int C, int heads,
                long long stride_win, long long stride_tok, int nWh, int nWw,
                int w, int shift, float scale, cudaStream_t stream) {
  if (N > 1024) return (int)cudaErrorInvalidValue;
  const dim3 grid(Bn, heads);
  const int threads = ((N + 31) / 32) * 32;
  const size_t smem = (size_t)2 * N * D * sizeof(float) + N * sizeof(int);
  window_attn_fp32_kernel<<<grid, threads, smem, stream>>>(
      (const float*)q, (const float*)k, (const float*)v, bias, (float*)out, N,
      C, stride_win, stride_tok, nWh, nWw, w, shift, scale);
  return (int)cudaGetLastError();
}

int launch_bf16(const void* q, const void* k, const void* v,
                const float* bias, void* out, int Bn, int N, int C, int heads,
                long long stride_win, long long stride_tok, int nWh, int nWw,
                int w, int shift, float scale, cudaStream_t stream) {
  // 16-byte copies of each token row: aligned pointers and strides
  const bool aligned = ((uintptr_t)q | (uintptr_t)k | (uintptr_t)v) % 16 == 0 &&
                       stride_win % 8 == 0 && stride_tok % 8 == 0;
  if (N > NP || !aligned) return (int)cudaErrorInvalidValue;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  const size_t smem = (size_t)6 * TILE_BYTES + (size_t)NP * BS * 4 + 2 * NP;
  err = cudaFuncSetAttribute(window_attn_mma_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;
  // one resident CTA per SM (the shared memory allows one): each head's
  // windows split into sms / heads runs, at least one window each
  const int runs = std::max(1, std::min(Bn, sms / heads));
  const int wins_per_cta = (Bn + runs - 1) / runs;
  const dim3 grid((Bn + wins_per_cta - 1) / wins_per_cta, heads);
  window_attn_mma_kernel<<<grid, WARPS * 32, smem, stream>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k,
      (const __nv_bfloat16*)v, bias, (__nv_bfloat16*)out, Bn, N, C,
      stride_win, stride_tok, nWh, nWw, w, shift, scale, wins_per_cta);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int window_attn_fwd(const void* q, const void* k, const void* v,
                               const void* bias, void* out, int Bn, int N,
                               int C, int heads, int head_dim,
                               long long stride_win, long long stride_tok,
                               int nWh, int nWw, int w, int shift, float scale,
                               int dtype, void* stream) {
  if (Bn == 0) return (int)cudaSuccess;
  if (head_dim != D) return (int)cudaErrorInvalidValue;
  if (dtype != 0 && dtype != 1) return (int)cudaErrorInvalidValue;
  return (dtype == 0 ? launch_fp32 : launch_bf16)(
      q, k, v, (const float*)bias, out, Bn, N, C, heads, stride_win,
      stride_tok, nWh, nWw, w, shift, scale, (cudaStream_t)stream);
}
