// Z-folded 3x3x3 sparse convolution forward (SubM stride 1 and stride 2).
//
// Replaces the TPU kernel fusionocc_tpu/ops/pallas/zwin_conv.py::_make_kernel
// (and its variants _make_kernel_merged and _epilogue_in_kernel, which
// compute the same contract).  The contract is ops/zfold.py's
// zband_conv_apply:
//
//   out[r, zo*Cout + co] = mask_out[r] *
//       sum over taps t with nbr[r, t] < S_in, over the in cells
//       stride*zo + dz - 1 (dz = 0..2) that lie in super shift ds = t % 3:
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
// Design: one CTA per ROWS = 32 consecutive output rows (of the flattened
// B*S_out), one thread per output lane c = zo*Cout + co (blockDim = L_out
// rounded up to a warp).  The block loads its 32 x 27 neighbour indices
// once.  Per tap whose band is not empty and that some row of the block
// finds, the threads gather the band cells of the 32 neighbour rows into
// shared memory as fp32 (zeros for misses; each cell's Cin lanes padded to a
// multiple of 4), then each thread runs the band cells its out cell zo reads
// (at most 3, stride*zo + dz - 1) against its column co of the cell kernel's
// tap t - ds + dz, with 32 fp32 accumulators in registers.  Shared reads are
// 16-byte loads, broadcast to the threads of one out cell.
//
// What bounds it: fp32 FMAs on the CUDA cores and the shared-memory reads
// that feed them (one 16-byte load per four FMAs).  The gathers read each
// neighbour row's band once per block and tap (HBM / L2).  Tensor cores
// (mma.sync / wgmma over the gathered tile) and TMA weight staging are later
// work.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cstdint>

namespace {

constexpr int ROWS = 32;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

struct Bands {
  int zi_lo[3];  // first input lane (in cells) of the band of z shift ds
  int nzi[3];    // band height in cells; 0 = no tap of this ds
};

__host__ __device__ __forceinline__ int round4(int x) { return (x + 3) & ~3; }

template <typename T>
__global__ void zwin_conv_fwd_kernel(const T* __restrict__ feats,
                                     const int32_t* __restrict__ nbr,
                                     const uint8_t* __restrict__ mask_out,
                                     const T* __restrict__ weight,
                                     T* __restrict__ out, int S_in, int S_out,
                                     int total_rows, int cin, int cout,
                                     int f_in, int stride, int L_in,
                                     int L_out, int kp_max, Bands bands) {
  extern __shared__ __align__(16) float smem[];
  float* gs = smem;                              // (ROWS, kp_max) fp32
  int* nbr_s = (int*)(smem + ROWS * kp_max);      // (ROWS, 27)

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
          v = to_float(feats[(b * S_in + n) * L_in + lane0 + z * cin + ci]);
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
          const T* wp = weight + (int64_t)(t - ds + z - z0) * cin * cout + co;
          const float* gz = gs + z * cin4;
          for (int k0 = 0; k0 < cin; k0 += 4) {
            float w[4];
#pragma unroll
            for (int j = 0; j < 4; ++j)
              w[j] = k0 + j < cin ? to_float(wp[(k0 + j) * cout]) : 0.f;
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
#pragma unroll
  for (int i = 0; i < ROWS; ++i) {
    const int r = row0 + i;
    if (r < total_rows)
      store(out + (int64_t)r * L_out + c, mask_out[r] ? acc[i] : 0.f);
  }
}

template <typename T>
int launch(const void* feats, const void* nbr, const void* mask_out,
           const void* weight, void* out, int B, int S_in, int S_out, int cin,
           int cout, int stride, int L_in, int L_out, const Bands& bands,
           cudaStream_t stream) {
  if (cin <= 0 || cout <= 0 || L_in % cin != 0 || L_out % cout != 0 ||
      (stride != 1 && stride != 2))
    return (int)cudaErrorInvalidValue;
  const int f_in = L_in / cin;
  int kp_max = 0;
  for (int ds = 0; ds < 3; ++ds) {
    if (bands.nzi[ds] < 0 || bands.zi_lo[ds] < 0 ||
        bands.zi_lo[ds] + bands.nzi[ds] > f_in)
      return (int)cudaErrorInvalidValue;
    const int kp = bands.nzi[ds] * round4(cin);
    kp_max = kp > kp_max ? kp : kp_max;
  }
  const int threads = ((L_out + 31) / 32) * 32;
  if (threads > 1024) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)ROWS * kp_max * sizeof(float) +
                      (size_t)ROWS * 27 * sizeof(int);
  auto kernel = zwin_conv_fwd_kernel<T>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int total_rows = B * S_out;
  const int blocks = (total_rows + ROWS - 1) / ROWS;
  kernel<<<blocks, threads, smem, stream>>>(
      (const T*)feats, (const int32_t*)nbr, (const uint8_t*)mask_out,
      (const T*)weight, (T*)out, S_in, S_out, total_rows, cin, cout, f_in,
      stride, L_in, L_out, kp_max, bands);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int zwin_conv_fwd(const void* feats, const void* nbr,
                             const void* mask_out, const void* weight,
                             void* out, int B, int S_in, int S_out, int cin,
                             int cout, int stride, int L_in, int L_out,
                             int zi_lo0, int nzi0, int zi_lo1, int nzi1,
                             int zi_lo2, int nzi2, int dtype, void* stream) {
  if (B * S_out == 0) return (int)cudaSuccess;
  const Bands bands = {{zi_lo0, zi_lo1, zi_lo2}, {nzi0, nzi1, nzi2}};
  if (dtype == 0)
    return launch<float>(feats, nbr, mask_out, weight, out, B, S_in, S_out,
                         cin, cout, stride, L_in, L_out, bands,
                         (cudaStream_t)stream);
  if (dtype == 1)
    return launch<__nv_bfloat16>(feats, nbr, mask_out, weight, out, B, S_in,
                                 S_out, cin, cout, stride, L_in, L_out, bands,
                                 (cudaStream_t)stream);
  return (int)cudaErrorInvalidValue;
}
