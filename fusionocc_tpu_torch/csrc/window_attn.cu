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
// bf16 (the main path), for Hopper.  By its bytes it is bound by HBM: a
// (window, head) item reads 3 N d bf16 of q, k, v and writes N d, 36.9 KB
// at N = 144, against 4 N^2 d = 2.65 MFLOP (72 FLOP a byte, where the card
// needs about 295 to be bound by its tensor cores).  In practice each SM's
// consumers set the pace: the exact softmax (N^2 exponentials an item on 16
// SFU lanes, about 9 instructions an element) and the products of the
// hi/lo split, while TMA moves the 64-byte head slices well below HBM's
// rate.  The design keeps loads in flight behind the compute:
// - a per-head persistent schedule: CTA (x, h) takes head h and a run of
//   windows, and stages bias[h] (fp32, rows padded to NP + 8 floats so the
//   fragment reads are conflict-free, 87.5 KB) in shared memory once, while
//   its first windows load.  Reading the bias fragments from L2 instead
//   (all heads of a stage together are at most 2.65 MB), which lets two
//   CTAs share an SM, measured slower at every shape;
// - one producer thread (in a warpgroup that gives its registers to the
//   consumers) loads each window's q, k and v tiles with TMA (3-D tensor
//   maps over the strided views, encoded on the host once per geometry and
//   rebased per launch; box 32 x 144 x 1 bf16, 64-byte swizzle; tokens past
//   N read as zeros) into a ring
//   of STAGES = 3 window stages (4 measured slower), each completed on an
//   mbarrier (full) and handed back by its consumer (empty);
// - two consumer warpgroups take alternate windows, so one window's softmax
//   overlaps the other's products and the loads of the next ones;
// - S = Q K^T by wgmma m64n144k16, Q and K read from shared memory K-major
//   in the swizzle that TMA wrote, over three m64 tiles of query rows (the
//   last tile's 48 padding rows cost products, not bytes, and their warps
//   skip the softmax);
// - the exact fp32 softmax in registers: scale, bias, shift mask, -inf for
//   the padded keys (only when N < NP), max and sum reduced over the quad;
// - O = P V by wgmma m64n32k16 with P from registers (the S accumulator
//   layout is the A fragment layout) and V read MN-major (transposed) from
//   shared memory.  P is split into a bf16 high part and a bf16 low part
//   (P - high), two products into two accumulators: P in bf16 alone, as
//   SDPA and FlashAttention take it, is 2^-9 off per probability, and where
//   few keys carry a row with values of both signs that puts the output two
//   bf16 ulps off the fp32 softmax of the contract.  O is normalised in fp32
//   and stored as bf16.
//
// fp32: the CUDA-core body.  One CTA per (window, head), K and V of the head
// in shared memory, one thread per query row with an online fp32 softmax.
#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <algorithm>
#include <cmath>
#include <cstdint>

#include "hopper.cuh"

namespace {

constexpr int D = 32;            // head_dim of both bodies
constexpr int NP = 144;          // bf16 body: tokens padded, 12 x 12 windows
constexpr int BS = NP + 8;       // bias row stride in floats (mod 32 = 24)
constexpr int TILE_BYTES = NP * D * 2;      // one of q, k, v: 9216 B
constexpr int STAGE_BYTES = 3 * TILE_BYTES;
constexpr int STAGES = 3;        // window stages in the ring
constexpr int CONSUMERS = 2;     // consumer warpgroups
constexpr int THREADS = (CONSUMERS + 1) * 128;  // and a producer warpgroup
// registers a thread: 2 x 128 x 232 + 128 x 40 <= 65536
constexpr int CONSUMER_REGS = 232, PRODUCER_REGS = 40;
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

constexpr size_t SMEM_BYTES = 1024 + (size_t)STAGES * STAGE_BYTES +
                              (size_t)NP * BS * 4 + 2 * STAGES * 8 + 2 * NP;

// K-major tiles of 64-byte rows (q, k) and V read MN-major: 8-row groups
// 512 B apart, 64-byte swizzle (see hopper.cuh).
__device__ __forceinline__ uint64_t desc_kmajor(uint32_t addr) {
  return hw::make_desc(addr, 16, 512, hw::SWIZZLE_64B);
}
__device__ __forceinline__ uint64_t desc_mnmajor(uint32_t addr) {
  return hw::make_desc(addr, 512, 512, hw::SWIZZLE_64B);
}

// PADDED: N < NP, the keys past N are scored -inf and the m tiles and k16
// steps past N skipped.
template <bool PADDED>
__global__ void __launch_bounds__(THREADS, 1)
    window_attn_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                             const __grid_constant__ CUtensorMap tm_k,
                             const __grid_constant__ CUtensorMap tm_v,
                             const float* __restrict__ bias,
                             __nv_bfloat16* __restrict__ out, int Bn, int N,
                             int C, int nWh, int nWw, int w, int shift,
                             float scale, int wins_per_cta) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* ring =
      smem_raw + ((1024 - (hw::smem_addr(smem_raw) & 1023)) & 1023);
  float* bias_s = reinterpret_cast<float*>(ring + STAGES * STAGE_BYTES);
  uint64_t* full = reinterpret_cast<uint64_t*>(
      ring + STAGES * STAGE_BYTES + NP * BS * 4);
  uint64_t* empty = full + STAGES;
  uint8_t* ry_s = reinterpret_cast<uint8_t*>(empty + STAGES);   // (NP,)
  uint8_t* rx_s = ry_s + NP;                                     // (NP,)

  const int h = blockIdx.y;
  const int win0 = blockIdx.x * wins_per_cta;
  const int items = min(wins_per_cta, Bn - win0);
  if (items <= 0) return;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const bool producer = warp >= CONSUMERS * 4;

  // q, k, v of window win0 + i into stage i % STAGES
  auto issue = [&](int i) {
    const int s = i % STAGES;
    uint8_t* dst = ring + s * STAGE_BYTES;
    hw::mbar_arrive_expect_tx(&full[s], STAGE_BYTES);
    hw::tma_load_3d(dst, &tm_q, &full[s], h * D, 0, win0 + i);
    hw::tma_load_3d(dst + TILE_BYTES, &tm_k, &full[s], h * D, 0, win0 + i);
    hw::tma_load_3d(dst + 2 * TILE_BYTES, &tm_v, &full[s], h * D, 0,
                    win0 + i);
  };

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      hw::mbar_init(&full[s], 1);
      hw::mbar_init(&empty[s], 4);      // the consumer's four warps
    }
    hw::fence_barrier_init();
  }
  __syncthreads();
  if (warp == CONSUMERS * 4 && lane == 0)
    for (int i = 0; i < min(items, STAGES); ++i) issue(i);
  for (int idx = tid; idx < NP * NP; idx += THREADS) {
    const int i = idx / NP, j = idx - i * NP;
    bias_s[i * BS + j] =
        (i < N && j < N) ? __ldg(bias + ((int64_t)h * N + i) * N + j) : 0.f;
  }
  for (int j = tid; j < NP; j += THREADS) {
    ry_s[j] = j / w < w - shift ? 1 : 2;
    rx_s[j] = j % w < w - shift ? 1 : 2;
  }
  __syncthreads();

  if (producer) {
    hw::regs_dealloc<PRODUCER_REGS>();
    if (warp == CONSUMERS * 4 && lane == 0)
      for (int i = STAGES; i < items; ++i) {
        hw::mbar_wait(&empty[i % STAGES], (i / STAGES - 1) & 1);
        issue(i);
      }
  } else {
    hw::regs_alloc<CONSUMER_REGS>();
    const int wg = warp >> 2, wq = warp & 3;
    const int g = lane >> 2, qd = lane & 3;
    const int m_tiles = PADDED ? (N + 63) / 64 : 3;
    const int k_steps = PADDED ? (N + 15) / 16 : NP / 16;
    for (int i = wg; i < items; i += CONSUMERS) {
      const int s = i % STAGES;
      hw::mbar_wait(&full[s], (i / STAGES) & 1);
      const int win = win0 + i;
      const uint32_t qs = hw::smem_addr(ring + s * STAGE_BYTES);
      const uint32_t ks = qs + TILE_BYTES, vs = ks + TILE_BYTES;
      const int wr = (win / nWw) % nWh, wc = win % nWw;
      const bool last_r = wr == nWh - 1, last_c = wc == nWw - 1;
      const bool masked = shift > 0 && (last_r || last_c);

      for (int t = 0; t < m_tiles; ++t) {
        // S = Q K^T for query rows 64t..64t+63, all NP keys
        float sc[72];
#pragma unroll
        for (int e = 0; e < 72; ++e) sc[e] = 0.f;
        hw::wgmma_fence();
        hw::wgmma_m64n144k16_ss(sc, desc_kmajor(qs + t * 64 * 64),
                                desc_kmajor(ks), 0);
        hw::wgmma_m64n144k16_ss(sc, desc_kmajor(qs + t * 64 * 64 + 32),
                                desc_kmajor(ks + 32), 1);
        hw::wgmma_commit();
        hw::wgmma_wait<0>();

        // scale, bias, shift mask, padding; exact fp32 softmax over the row;
        // P as A fragments, high and low bf16 parts
        const int rbase = t * 64 + wq * 16;
        const int rA = rbase + g, rB = rA + 8;   // this thread's two rows
        uint32_t hi[9][4], lo[9][4];
        float iA = 0.f, iB = 0.f;
        if (rbase < N) {                 // uniform over the warp
          int ridA = 0, ridB = 0;
          if (masked) {
            ridA = (last_r ? ry_s[rA] : 0) * 3 + (last_c ? rx_s[rA] : 0);
            ridB = (last_r ? ry_s[rB] : 0) * 3 + (last_c ? rx_s[rB] : 0);
          }
          float mA = -INFINITY, mB = -INFINITY;
#pragma unroll
          for (int nt = 0; nt < NP / 8; ++nt) {
            const int j = nt * 8 + 2 * qd;
            const float2 ba =
                *reinterpret_cast<const float2*>(bias_s + rA * BS + j);
            const float2 bb =
                *reinterpret_cast<const float2*>(bias_s + rB * BS + j);
            float* sn = sc + 4 * nt;
            sn[0] = fmaf(sn[0], scale, ba.x);
            sn[1] = fmaf(sn[1], scale, ba.y);
            sn[2] = fmaf(sn[2], scale, bb.x);
            sn[3] = fmaf(sn[3], scale, bb.y);
            if (masked) {
#pragma unroll
              for (int e = 0; e < 2; ++e) {
                const int rj = (last_r ? ry_s[j + e] : 0) * 3 +
                               (last_c ? rx_s[j + e] : 0);
                if (rj != ridA) sn[e] += -100.f;
                if (rj != ridB) sn[2 + e] += -100.f;
              }
            }
            if (PADDED) {
              if (j >= N) sn[0] = sn[2] = -INFINITY;
              if (j + 1 >= N) sn[1] = sn[3] = -INFINITY;
            }
            mA = fmaxf(mA, fmaxf(sn[0], sn[1]));
            mB = fmaxf(mB, fmaxf(sn[2], sn[3]));
          }
#pragma unroll
          for (int o = 1; o <= 2; o <<= 1) {
            mA = fmaxf(mA, __shfl_xor_sync(0xffffffffu, mA, o));
            mB = fmaxf(mB, __shfl_xor_sync(0xffffffffu, mB, o));
          }
          const float oA = -mA * LOG2E, oB = -mB * LOG2E;
          float lA = 0.f, lB = 0.f;
#pragma unroll
          for (int nt = 0; nt < NP / 8; ++nt) {
            float* sn = sc + 4 * nt;
            sn[0] = hw::exp2_approx(fmaf(sn[0], LOG2E, oA));
            sn[1] = hw::exp2_approx(fmaf(sn[1], LOG2E, oA));
            sn[2] = hw::exp2_approx(fmaf(sn[2], LOG2E, oB));
            sn[3] = hw::exp2_approx(fmaf(sn[3], LOG2E, oB));
            lA += sn[0] + sn[1];
            lB += sn[2] + sn[3];
          }
#pragma unroll
          for (int o = 1; o <= 2; o <<= 1) {
            lA += __shfl_xor_sync(0xffffffffu, lA, o);
            lB += __shfl_xor_sync(0xffffffffu, lB, o);
          }
          iA = 1.f / lA;
          iB = 1.f / lB;
#pragma unroll
          for (int kk = 0; kk < NP / 16; ++kk) {
            const float* p = sc + 8 * kk;    // n-blocks 2kk and 2kk + 1
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const uint32_t hp = hw::pack_bf16(p[2 * e], p[2 * e + 1]);
              hi[kk][e] = hp;
              const float h0 = __uint_as_float(hp << 16);
              const float h1 = __uint_as_float(hp & 0xffff0000u);
              lo[kk][e] = hw::pack_bf16(p[2 * e] - h0, p[2 * e + 1] - h1);
            }
          }
        } else {
#pragma unroll
          for (int kk = 0; kk < NP / 16; ++kk)
#pragma unroll
            for (int e = 0; e < 4; ++e) hi[kk][e] = lo[kk][e] = 0u;
        }

        // O = P V, V from shared memory read transposed; the high and the
        // low parts into two accumulators, two chains of products
        float o[16], o_lo[16];
#pragma unroll
        for (int e = 0; e < 16; ++e) o[e] = o_lo[e] = 0.f;
        hw::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < NP / 16; ++kk) {
          if (kk < k_steps) {            // keys past N have P = 0
            const uint64_t dv = desc_mnmajor(vs + kk * 16 * 64);
            hw::wgmma_m64n32k16_rs<1>(o, hi[kk], dv, 1);
            hw::wgmma_m64n32k16_rs<1>(o_lo, lo[kk], dv, 1);
          }
        }
        hw::wgmma_commit();
        hw::wgmma_wait<0>();
#pragma unroll
        for (int e = 0; e < 16; ++e) o[e] += o_lo[e];

        if (rbase < N) {
#pragma unroll
          for (int jj = 0; jj < D / 8; ++jj) {
            const int d = jj * 8 + 2 * qd;
            if (rA < N)
              *reinterpret_cast<uint32_t*>(
                  out + ((int64_t)win * N + rA) * C + h * D + d) =
                  hw::pack_bf16(o[4 * jj] * iA, o[4 * jj + 1] * iA);
            if (rB < N)
              *reinterpret_cast<uint32_t*>(
                  out + ((int64_t)win * N + rB) * C + h * D + d) =
                  hw::pack_bf16(o[4 * jj + 2] * iB, o[4 * jj + 3] * iB);
          }
        }
      }
      __syncwarp();
      if (lane == 0) hw::mbar_arrive(&empty[s]);   // the stage may refill
    }
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
  if (N > NP) return (int)cudaErrorInvalidValue;
  // (C, N, Bn) views through the strides; TMA refuses unaligned bases and
  // strides that are not multiples of 16 bytes
  CUtensorMap maps[3];
  const void* bases[3] = {q, k, v};
  const uint64_t dims[3] = {(uint64_t)C, (uint64_t)N, (uint64_t)Bn};
  const uint64_t strides[2] = {(uint64_t)stride_tok * 2,
                               (uint64_t)stride_win * 2};
  const uint32_t box[3] = {D, NP, 1};
  for (int i = 0; i < 3; ++i)
    if (!hw::encode_bf16_3d(&maps[i], bases[i], dims, strides, box,
                            CU_TENSOR_MAP_SWIZZLE_64B))
      return (int)cudaErrorInvalidValue;
  auto kernel = N < NP ? window_attn_wgmma_kernel<true>
                       : window_attn_wgmma_kernel<false>;
  int sms = 0, per_sm = 0;
  const cudaError_t err = hw::resident_ctas(
      reinterpret_cast<const void*>(kernel), THREADS, SMEM_BYTES, &sms,
      &per_sm);
  if (err != cudaSuccess) return (int)err;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  // the resident CTAs split each head's windows into runs of at least one
  const int runs = std::max(1, std::min(Bn, sms * per_sm / heads));
  const int wins_per_cta = (Bn + runs - 1) / runs;
  const dim3 grid((Bn + wins_per_cta - 1) / wins_per_cta, heads);
  kernel<<<grid, THREADS, SMEM_BYTES, stream>>>(
      maps[0], maps[1], maps[2], bias, (__nv_bfloat16*)out, Bn, N, C, nWh,
      nWw, w, shift, scale, wins_per_cta);
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
  if (dtype == 0)
    return launch_fp32(q, k, v, (const float*)bias, out, Bn, N, C, heads,
                       stride_win, stride_tok, nWh, nWw, w, shift, scale,
                       (cudaStream_t)stream);
  return launch_bf16(q, k, v, (const float*)bias, out, Bn, N, C, heads,
                     stride_win, stride_tok, nWh, nWw, w, shift, scale,
                     (cudaStream_t)stream);
}
