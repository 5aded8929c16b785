// Z-folded 3x3x3 sparse convolution forward (SubM stride 1 and stride 2).
//
// Replaces the TPU kernel fusionocc_tpu/ops/pallas/zwin_conv.py::_make_kernel
// (and its variant _make_kernel_merged, which computes the same contract),
// and with the entry zwin_conv_fwd_epi its fused eval epilogue
// _epilogue_in_kernel (below).  The contract is ops/zfold.py's
// zband_conv_apply:
//
//   out[r, zo*Cout + co] = mask_out[r] *
//       sum over taps t with nbr[r, t] < S_in, over the in cells
//       zi = stride*zo + dz - 1 - (ds - 1)*f_in (dz = 0..2) with 0 <= zi < f_in,
//       where ds = t % 3 is the tap's super z shift:
//           sum over ci of feats[b(r), nbr[r, t], zi*Cin + ci]
//                          * weight[t - ds + dz, ci, co]
//
// summed in fp32 over all taps and cast to the output type once; masked
// rows are exact zeros.  weight is the (27, Cin, Cout) cell kernel.  The in
// lanes a tap reads form the band (zi_lo, nzi) of its z shift ds, the
// nonzero rows of the lifted weight (z_bands in ops/zwin_conv.py).
//
// The TPU kernel streamed contiguous windows of rows and picked each tap's
// rows with one-hot matmuls, because Mosaic had no dynamic gather.  Here the
// rows are gathered by index, so no window plan, overflow patch or fallback
// exists: every tap of every row is exact.
//
// Two bodies, chosen by dtype:
//
// bf16 (the main path): an implicit gather-GEMM on the tensor cores
// (mma.sync m16n8k16).  One CTA per ROWS = 32 consecutive output rows of the
// flattened B*S_out, one warp per out cell zo (f_out <= 8 warps).  For a tap
// t and a dz, the out cells zo whose in cell zi is valid form a GEMM of
// (32 rows) x Cin by Cin x Cout against the cell kernel t - ds + dz; the
// warp of out cell zo runs it for its 32 rows (2 m-tiles) when its zi is
// valid, so only valid (zo, zi) pairs are multiplied and every warp does 3
// cell GEMMs per (dx, dy).  Per tap that some active row of the block finds,
// 16-byte cp.async copies gather the band cells of the 32 neighbour rows
// (misses and masked or past-the-end rows zero-filled) and the tap's used
// cell kernels into a shared-memory stage; the stage is double-buffered, so
// the next tap's gather is in flight while this tap multiplies.  A fragments
// come by ldmatrix from the gathered rows (each lane points at its row's
// cell zi, so the cell pick costs nothing), B fragments by ldmatrix.trans
// from the staged kernel.  Row strides are padded by 16 bytes, so every
// ldmatrix phase hits 32 banks.  The fp32 accumulators (2 m-tiles x Cout/8
// n-tiles x 4 per thread) stay in registers over all 27 taps; the epilogue
// applies mask_out, casts once and stores.  The NULL_BODY instantiation
// (entry zwin_conv_null) runs the same gathers and stores with the products
// left out: the cost of the data movement alone.
//
// fp32: the CUDA-core body.  One CTA per 32 output rows, one thread per
// output lane c = zo*Cout + co; per tap the band cells of the 32 neighbour
// rows are gathered into shared memory as fp32 and each thread runs the at
// most 3 band cells its out cell reads against its column of the cell
// kernel.
//
// The fused eval epilogue (the EPI instantiations of both bodies, entry
// zwin_conv_fwd_epi; SparseEncoderConfig.zwin_fuse): before the single
// store, each fp32 accumulator of lane c = zo*Cout + co of row r becomes
//
//   lane[r, zo] ? max(acc * inv[c] + shift[c], 0) : 0
//
// with inv, shift the eval BatchNorm's (L_out,) affine and lane the compact
// (B*S_out, f_out) cell mask, one byte per cell (JAX's kernel read an
// expanded (B, S_out, L_out) multiplier instead, Cout times the bytes).
// The product and the sum round separately (no FMA), as the plain version
// does.  What it saves is the unfused chain's passes over the output: the
// BatchNorm's fp32 copy, its masked affine and cast, and the ReLU.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cstdint>

#include "tensor_core.cuh"

namespace {

constexpr int ROWS = 32;
constexpr int MAX_FOUT = 8;      // bf16 body: one warp per out cell
constexpr int MAX_NT = 8;        // bf16 body: Cout <= 64, n8 tiles
constexpr int MAX_CIN = 64;      // bf16 body: Cin <= 64, k16 steps

struct Bands {
  int zi_lo[3];   // first input lane (in cells) of the band of z shift ds
  int nzi[3];     // band height in cells; 0 = no tap of this ds
  int dz_used[3]; // bit dz set when some out cell reads dz in band ds
};

// operands of the fused eval epilogue; unused by the plain instantiations
struct Epilogue {
  const float* inv;      // (L_out,) BatchNorm scale
  const float* shift;    // (L_out,) BatchNorm shift
  const uint8_t* lane;   // (B*S_out, f_out) cell lane mask
  int f_out;
};

__host__ __device__ __forceinline__ int round4(int x) { return (x + 3) & ~3; }

__device__ __forceinline__ float affine_relu(float acc, float inv,
                                             float shift) {
  return fmaxf(__fadd_rn(__fmul_rn(acc, inv), shift), 0.f);
}

// ---------------------------------------------------------------- bf16 body

template <bool NULL_BODY, bool EPI>
__global__ void __launch_bounds__(MAX_FOUT * 32, 2)
    zwin_conv_mma_kernel(const __nv_bfloat16* __restrict__ feats,
                         const int32_t* __restrict__ nbr,
                         const uint8_t* __restrict__ mask_out,
                         const __nv_bfloat16* __restrict__ weight,
                         __nv_bfloat16* __restrict__ out, int S_in, int S_out,
                         int total_rows, int cin, int cout, int f_in,
                         int stride, int L_in, int L_out, Bands bands,
                         int g_bytes, int w_bytes, Epilogue epi) {
  extern __shared__ __align__(16) uint8_t smem[];
  int* src_s = reinterpret_cast<int*>(smem);       // (ROWS, 27) feats rows
  uint32_t* hits_s = reinterpret_cast<uint32_t*>(smem + ROWS * 27 * 4);
  uint8_t* gbuf = smem + ROWS * 27 * 4 + 16;        // [2] gathered bands
  uint8_t* wbuf = gbuf + 2 * g_bytes;               // [2] cell kernels

  const int tid = threadIdx.x, lane = tid & 31, zo = tid >> 5;
  const int nthreads = blockDim.x;
  const int row0 = blockIdx.x * ROWS;
  if (tid == 0) *hits_s = 0;
  __syncthreads();

  // the feats row (b * S_in + nbr) of each (row, tap), -1 for a miss or an
  // inactive row; the taps that some row finds
  uint32_t hits = 0;
  for (int i = tid; i < ROWS * 27; i += nthreads) {
    const int r = row0 + i / 27, t = i % 27;
    int src = -1;
    if (r < total_rows && mask_out[r]) {
      const int n = nbr[(int64_t)r * 27 + t];
      if (n < S_in && bands.nzi[t % 3] > 0) {
        src = (r / S_out) * S_in + n;
        hits |= 1u << t;
      }
    }
    src_s[i] = src;
  }
  hits = __reduce_or_sync(0xffffffffu, hits);
  if (lane == 0 && hits) atomicOr(hits_s, hits);
  __syncthreads();
  hits = *hits_s;

  const uint32_t g_addr = tc::smem_addr(gbuf);
  const uint32_t w_addr = tc::smem_addr(wbuf);
  const int w_row = cout * 2 + 16;                  // staged kernel row, bytes

  auto issue = [&](int t, int buf) {
    const int ds = t % 3, nzi = bands.nzi[ds];
    const int chunks = nzi * cin / 8;               // 16-byte chunks a row
    const int g_row = nzi * cin * 2 + 16;
    const __nv_bfloat16* band = feats + bands.zi_lo[ds] * cin;
    for (int idx = tid; idx < ROWS * chunks; idx += nthreads) {
      const int i = idx / chunks, c = idx - i * chunks;
      const int src = src_s[i * 27 + t];
      tc::cp_async16(g_addr + buf * g_bytes + i * g_row + c * 16,
                     src >= 0 ? band + (int64_t)src * L_in + c * 8 : feats,
                     src >= 0 ? 16 : 0);
    }
    const int w_chunks = cout / 8;
    for (int idx = tid; idx < 3 * cin * w_chunks; idx += nthreads) {
      const int dz = idx / (cin * w_chunks);
      if (!((bands.dz_used[ds] >> dz) & 1)) continue;
      const int rem = idx - dz * cin * w_chunks;
      const int ci = rem / w_chunks, c = rem - ci * w_chunks;
      tc::cp_async16(
          w_addr + buf * w_bytes + (dz * cin + ci) * w_row + c * 16,
          weight + ((int64_t)(t - ds + dz) * cin + ci) * cout + c * 8, 16);
    }
  };

  float acc[2][MAX_NT][4];
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int n = 0; n < MAX_NT; ++n)
      acc[m][n][0] = acc[m][n][1] = acc[m][n][2] = acc[m][n][3] = 0.f;

  const int n_tiles = cout / 8, k_steps = cin / 16;
  int t = hits ? __ffs(hits) - 1 : -1;
  int buf = 0;
  if (t >= 0) issue(t, 0);
  tc::cp_async_commit();
  while (t >= 0) {
    const uint32_t later = hits & ~((2u << t) - 1u);
    const int t_next = later ? __ffs(later) - 1 : -1;
    if (t_next >= 0) issue(t_next, buf ^ 1);
    tc::cp_async_commit();
    tc::cp_async_wait<1>();
    __syncthreads();

    if (!NULL_BODY) {
      const int ds = t % 3, nzi = bands.nzi[ds];
      const int g_row = nzi * cin * 2 + 16;
      const uint32_t ga = g_addr + buf * g_bytes;
      const uint32_t wa = w_addr + buf * w_bytes;
      for (int dz = 0; dz < 3; ++dz) {
        const int zi = stride * zo + dz - 1 - (ds - 1) * f_in;
        if (zi < 0 || zi >= f_in) continue;         // uniform over the warp
        const int z = zi - bands.zi_lo[ds];         // cell within the band
        for (int kk = 0; kk < k_steps; ++kk) {
          uint32_t a[2][4];
#pragma unroll
          for (int m = 0; m < 2; ++m)
            tc::ldmatrix_x4(a[m], ga + (m * 16 + (lane & 15)) * g_row +
                                      z * cin * 2 + kk * 32 +
                                      (lane >> 4) * 16);
          const int ci = kk * 16 + ((lane >> 3) & 1) * 8 + (lane & 7);
#pragma unroll
          for (int np = 0; np < MAX_NT / 2; ++np) {
            if (2 * np < n_tiles) {
              uint32_t b[4];
              tc::ldmatrix_x4_trans(b, wa + (dz * cin + ci) * w_row +
                                           (np * 16 + (lane >> 4) * 8) * 2);
#pragma unroll
              for (int m = 0; m < 2; ++m) {
                tc::mma_bf16(acc[m][2 * np], a[m], b[0], b[1]);
                tc::mma_bf16(acc[m][2 * np + 1], a[m], b[2], b[3]);
              }
            }
          }
        }
      }
    }
    __syncthreads();                  // this stage is refilled next tap
    t = t_next;
    buf ^= 1;
  }

  const int g = lane >> 2, qd = lane & 3;
#pragma unroll
  for (int m = 0; m < 2; ++m) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = row0 + m * 16 + half * 8 + g;
      if (r >= total_rows) continue;
      const bool keep =
          mask_out[r] != 0 &&
          (!EPI || epi.lane[(int64_t)r * epi.f_out + zo] != 0);
      __nv_bfloat16* orow = out + (int64_t)r * L_out + zo * cout;
#pragma unroll
      for (int n = 0; n < MAX_NT; ++n) {
        if (n < n_tiles) {
          float v0 = keep ? acc[m][n][2 * half] : 0.f;
          float v1 = keep ? acc[m][n][2 * half + 1] : 0.f;
          if (EPI && keep) {
            const int c = zo * cout + n * 8 + 2 * qd;
            v0 = affine_relu(v0, __ldg(epi.inv + c), __ldg(epi.shift + c));
            v1 = affine_relu(v1, __ldg(epi.inv + c + 1),
                             __ldg(epi.shift + c + 1));
          }
          *reinterpret_cast<uint32_t*>(orow + n * 8 + 2 * qd) =
              tc::pack_bf16(v0, v1);
        }
      }
    }
  }
}

// ---------------------------------------------------------------- fp32 body

template <bool EPI>
__global__ void zwin_conv_fp32_kernel(const float* __restrict__ feats,
                                      const int32_t* __restrict__ nbr,
                                      const uint8_t* __restrict__ mask_out,
                                      const float* __restrict__ weight,
                                      float* __restrict__ out, int S_in,
                                      int S_out, int total_rows, int cin,
                                      int cout, int f_in, int stride, int L_in,
                                      int L_out, int kp_max, Bands bands,
                                      Epilogue epi) {
  extern __shared__ __align__(16) float smem_f[];
  float* gs = smem_f;                              // (ROWS, kp_max) fp32
  int* nbr_s = (int*)(smem_f + ROWS * kp_max);     // (ROWS, 27)

  const int row0 = blockIdx.x * ROWS;
  const int c = threadIdx.x;
  const int zo = c / cout;
  const int co = c - zo * cout;
  const int cin4 = round4(cin);
  for (int i = threadIdx.x; i < ROWS * 27; i += blockDim.x) {
    const int r = row0 + i / 27;
    nbr_s[i] = r < total_rows ? nbr[(int64_t)r * 27 + i % 27] : S_in;
  }
  float acc[ROWS];
#pragma unroll
  for (int i = 0; i < ROWS; ++i) acc[i] = 0.f;
  __syncthreads();

  for (int t = 0; t < 27; ++t) {
    const int ds = t % 3;
    const int nzi = bands.nzi[ds];
    if (nzi == 0) continue;                       // uniform over the block
    const int hit = __syncthreads_or(threadIdx.x < ROWS &&
                                     nbr_s[threadIdx.x * 27 + t] < S_in);
    if (hit) {
      const int KP = nzi * cin4;                  // gs row: nzi cells
      const int lane0 = bands.zi_lo[ds] * cin;
      for (int idx = threadIdx.x; idx < ROWS * KP; idx += blockDim.x) {
        const int i = idx / KP, k = idx - i * KP;
        const int z = k / cin4, ci = k - z * cin4;
        const int n = nbr_s[i * 27 + t];
        float v = 0.f;
        if (ci < cin && n < S_in) {
          const int64_t b = (row0 + i) / S_out;
          v = feats[(b * S_in + n) * L_in + lane0 + z * cin + ci];
        }
        gs[i * KP + k] = v;
      }
      __syncthreads();
      if (c < L_out) {
        // band cells (relative to zi_lo) that out cell zo reads: dz = 0..2
        const int z0 = stride * zo - 1 - (ds - 1) * f_in - bands.zi_lo[ds];
        const int za = z0 > 0 ? z0 : 0;
        const int zb = z0 + 2 < nzi - 1 ? z0 + 2 : nzi - 1;
        for (int z = za; z <= zb; ++z) {
          const float* wp = weight + (int64_t)(t - ds + z - z0) * cin * cout + co;
          const float* gz = gs + z * cin4;
          for (int k0 = 0; k0 < cin; k0 += 4) {
            float w[4];
#pragma unroll
            for (int j = 0; j < 4; ++j)
              w[j] = k0 + j < cin ? wp[(k0 + j) * cout] : 0.f;
#pragma unroll
            for (int i = 0; i < ROWS; ++i) {
              const float4 g =
                  *reinterpret_cast<const float4*>(gz + i * KP + k0);
              acc[i] = fmaf(g.x, w[0], acc[i]);
              acc[i] = fmaf(g.y, w[1], acc[i]);
              acc[i] = fmaf(g.z, w[2], acc[i]);
              acc[i] = fmaf(g.w, w[3], acc[i]);
            }
          }
        }
      }
      __syncthreads();                            // gs is rewritten next tap
    }
  }

  if (c >= L_out) return;
  const float inv = EPI ? __ldg(epi.inv + c) : 1.f;
  const float shift = EPI ? __ldg(epi.shift + c) : 0.f;
#pragma unroll
  for (int i = 0; i < ROWS; ++i) {
    const int r = row0 + i;
    if (r >= total_rows) continue;
    const bool keep = mask_out[r] != 0 &&
                      (!EPI || epi.lane[(int64_t)r * epi.f_out + zo] != 0);
    const float v = EPI ? affine_relu(acc[i], inv, shift) : acc[i];
    out[(int64_t)r * L_out + c] = keep ? v : 0.f;
  }
}

// ------------------------------------------------------------------ launch

template <bool EPI>
int launch_fp32(const void* feats, const void* nbr, const void* mask_out,
                const void* weight, void* out, int S_in, int S_out,
                int total_rows, int cin, int cout, int f_in, int stride,
                int L_in, int L_out, const Bands& bands, const Epilogue& epi,
                cudaStream_t stream) {
  int kp_max = 0;
  for (int ds = 0; ds < 3; ++ds) {
    const int kp = bands.nzi[ds] * round4(cin);
    kp_max = kp > kp_max ? kp : kp_max;
  }
  const int threads = ((L_out + 31) / 32) * 32;
  if (threads > 1024) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)ROWS * kp_max * sizeof(float) +
                      (size_t)ROWS * 27 * sizeof(int);
  auto kernel = zwin_conv_fp32_kernel<EPI>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (total_rows + ROWS - 1) / ROWS;
  kernel<<<blocks, threads, smem, stream>>>(
      (const float*)feats, (const int32_t*)nbr, (const uint8_t*)mask_out,
      (const float*)weight, (float*)out, S_in, S_out, total_rows, cin, cout,
      f_in, stride, L_in, L_out, kp_max, bands, epi);
  return (int)cudaGetLastError();
}

template <bool NULL_BODY, bool EPI>
int launch_bf16(const void* feats, const void* nbr, const void* mask_out,
                const void* weight, void* out, int S_in, int S_out,
                int total_rows, int cin, int cout, int f_in, int f_out,
                int stride, int L_in, int L_out, const Bands& bands,
                const Epilogue& epi, cudaStream_t stream) {
  // k16 steps over Cin, n8 tiles over Cout, one warp per out cell, 16-byte
  // copies of band cells and kernel rows
  const bool aligned =
      ((uintptr_t)feats | (uintptr_t)weight) % 16 == 0 && (uintptr_t)out % 4 == 0;
  if (cin % 16 != 0 || cin > MAX_CIN || cout % 8 != 0 ||
      cout > MAX_NT * 8 || f_out > MAX_FOUT || !aligned)
    return (int)cudaErrorInvalidValue;
  int nzi_max = 0;
  for (int ds = 0; ds < 3; ++ds)
    nzi_max = bands.nzi[ds] > nzi_max ? bands.nzi[ds] : nzi_max;
  const int g_bytes = ROWS * (nzi_max * cin * 2 + 16);
  const int w_bytes = 3 * cin * (cout * 2 + 16);
  const size_t smem = (size_t)ROWS * 27 * 4 + 16 + 2 * (size_t)g_bytes +
                      2 * (size_t)w_bytes;
  auto kernel = zwin_conv_mma_kernel<NULL_BODY, EPI>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (total_rows + ROWS - 1) / ROWS;
  kernel<<<blocks, f_out * 32, smem, stream>>>(
      (const __nv_bfloat16*)feats, (const int32_t*)nbr,
      (const uint8_t*)mask_out, (const __nv_bfloat16*)weight,
      (__nv_bfloat16*)out, S_in, S_out, total_rows, cin, cout, f_in, stride,
      L_in, L_out, bands, g_bytes, w_bytes, epi);
  return (int)cudaGetLastError();
}

// Checks the fold and fills the band table; false on a bad argument.
bool make_bands(int cin, int cout, int stride, int L_in, int L_out,
                const int (&zi_lo)[3], const int (&nzi)[3], int* f_in,
                int* f_out, Bands* bands) {
  if (cin <= 0 || cout <= 0 || L_in % cin != 0 || L_out % cout != 0 ||
      (stride != 1 && stride != 2))
    return false;
  *f_in = L_in / cin;
  *f_out = L_out / cout;
  for (int ds = 0; ds < 3; ++ds) {
    if (nzi[ds] < 0 || zi_lo[ds] < 0 || zi_lo[ds] + nzi[ds] > *f_in)
      return false;
    bands->zi_lo[ds] = zi_lo[ds];
    bands->nzi[ds] = nzi[ds];
    bands->dz_used[ds] = 0;
    for (int zo = 0; zo < *f_out; ++zo)
      for (int dz = 0; dz < 3; ++dz) {
        const int zi = stride * zo + dz - 1 - (ds - 1) * *f_in;
        if (zi >= 0 && zi < *f_in) bands->dz_used[ds] |= 1 << dz;
      }
  }
  return true;
}

// Both bodies, chosen by dtype (0 fp32, 1 bf16), with the fused epilogue
// when EPI.
template <bool EPI>
int zwin_conv_run(const void* feats, const void* nbr, const void* mask_out,
                  const void* weight, const Epilogue& epi, void* out, int B,
                  int S_in, int S_out, int cin, int cout, int stride,
                  int L_in, int L_out, const int (&zi_lo)[3],
                  const int (&nzi)[3], int dtype, cudaStream_t stream) {
  if (B * S_out == 0) return (int)cudaSuccess;
  int f_in = 0, f_out = 0;
  Bands bands;
  if (!make_bands(cin, cout, stride, L_in, L_out, zi_lo, nzi, &f_in, &f_out,
                  &bands))
    return (int)cudaErrorInvalidValue;
  Epilogue e = epi;
  e.f_out = f_out;
  if (dtype == 0)
    return launch_fp32<EPI>(feats, nbr, mask_out, weight, out, S_in, S_out,
                            B * S_out, cin, cout, f_in, stride, L_in, L_out,
                            bands, e, stream);
  if (dtype == 1)
    return launch_bf16<false, EPI>(feats, nbr, mask_out, weight, out, S_in,
                                   S_out, B * S_out, cin, cout, f_in, f_out,
                                   stride, L_in, L_out, bands, e, stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" int zwin_conv_fwd(const void* feats, const void* nbr,
                             const void* mask_out, const void* weight,
                             void* out, int B, int S_in, int S_out, int cin,
                             int cout, int stride, int L_in, int L_out,
                             int zi_lo0, int nzi0, int zi_lo1, int nzi1,
                             int zi_lo2, int nzi2, int dtype, void* stream) {
  return zwin_conv_run<false>(feats, nbr, mask_out, weight, Epilogue{}, out,
                              B, S_in, S_out, cin, cout, stride, L_in, L_out,
                              {zi_lo0, zi_lo1, zi_lo2}, {nzi0, nzi1, nzi2},
                              dtype, (cudaStream_t)stream);
}

// zwin_conv_fwd with the fused eval epilogue: inv and shift (L_out,) fp32,
// lane (B*S_out, f_out) uint8.
extern "C" int zwin_conv_fwd_epi(const void* feats, const void* nbr,
                                 const void* mask_out, const void* weight,
                                 const void* inv, const void* shift,
                                 const void* lane, void* out, int B, int S_in,
                                 int S_out, int cin, int cout, int stride,
                                 int L_in, int L_out, int zi_lo0, int nzi0,
                                 int zi_lo1, int nzi1, int zi_lo2, int nzi2,
                                 int dtype, void* stream) {
  const Epilogue epi{(const float*)inv, (const float*)shift,
                     (const uint8_t*)lane, 0};
  return zwin_conv_run<true>(feats, nbr, mask_out, weight, epi, out, B, S_in,
                             S_out, cin, cout, stride, L_in, L_out,
                             {zi_lo0, zi_lo1, zi_lo2}, {nzi0, nzi1, nzi2},
                             dtype, (cudaStream_t)stream);
}

// The bf16 body with the products left out (gathers, staging and stores
// only), for the microbenchmark tools/profile_torch_zwin_micro.py.
extern "C" int zwin_conv_null(const void* feats, const void* nbr,
                              const void* mask_out, const void* weight,
                              void* out, int B, int S_in, int S_out, int cin,
                              int cout, int stride, int L_in, int L_out,
                              int zi_lo0, int nzi0, int zi_lo1, int nzi1,
                              int zi_lo2, int nzi2, int dtype, void* stream) {
  if (B * S_out == 0) return (int)cudaSuccess;
  int f_in = 0, f_out = 0;
  Bands bands;
  if (dtype != 1 ||
      !make_bands(cin, cout, stride, L_in, L_out, {zi_lo0, zi_lo1, zi_lo2},
                  {nzi0, nzi1, nzi2}, &f_in, &f_out, &bands))
    return (int)cudaErrorInvalidValue;
  return launch_bf16<true, false>(feats, nbr, mask_out, weight, out, S_in,
                                  S_out, B * S_out, cin, cout, f_in, f_out,
                                  stride, L_in, L_out, bands, Epilogue{},
                                  (cudaStream_t)stream);
}
