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
// Design: one CTA per (window, head).  K and V of that head are staged in
// shared memory as fp32 (144 x 32 x 4 B each for Swin-B), with each token's
// region id.  One thread per query row (N = 144 rows rounded up to 160
// threads, the rest idle) keeps its q row and output accumulator in
// registers and runs an online softmax over the N keys in fp32; the
// (N, N) score matrix never leaves registers.
//
// What bounds it: fp32 FMAs on the CUDA cores (2 * N * head_dim per key for
// scores, rescale and PV); shared-memory reads are warp broadcasts.  No
// tensor cores yet: a wgmma / mma.sync version is later work.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cmath>
#include <cstdint>

namespace {

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// mmcv img_mask region id of token `tok` of a window; last_r / last_c say
// whether the window is the last one along its row / column axis.
__device__ __forceinline__ int region_id(int tok, int w, int shift,
                                         bool last_r, bool last_c) {
  const int py = tok / w, px = tok % w;
  const int ry = last_r ? (py < w - shift ? 1 : 2) : 0;
  const int rx = last_c ? (px < w - shift ? 1 : 2) : 0;
  return ry * 3 + rx;
}

template <typename T, int D>
__global__ void window_attn_fwd_kernel(const T* __restrict__ q,
                                       const T* __restrict__ k,
                                       const T* __restrict__ v,
                                       const float* __restrict__ bias,
                                       T* __restrict__ out, int N, int C,
                                       int64_t stride_win, int64_t stride_tok,
                                       int nWh, int nWw, int w, int shift,
                                       float scale) {
  extern __shared__ float smem[];
  float* ks = smem;                          // (N, D)
  float* vs = smem + N * D;                  // (N, D)
  int* rid = (int*)(smem + 2 * N * D);       // (N,)

  const int win = blockIdx.x;
  const int h = blockIdx.y;
  const int64_t base = (int64_t)win * stride_win + (int64_t)h * D;
  const bool last_r = ((win / nWw) % nWh) == nWh - 1;
  const bool last_c = (win % nWw) == nWw - 1;

  for (int idx = threadIdx.x; idx < N * D; idx += blockDim.x) {
    const int j = idx / D, d = idx % D;
    const int64_t off = base + (int64_t)j * stride_tok + d;
    ks[idx] = to_float(k[off]);
    vs[idx] = to_float(v[off]);
  }
  for (int j = threadIdx.x; j < N; j += blockDim.x) {
    rid[j] = shift > 0 ? region_id(j, w, shift, last_r, last_c) : 0;
  }
  __syncthreads();

  const int i = threadIdx.x;
  if (i >= N) return;

  float qr[D];
  const T* qrow = q + base + (int64_t)i * stride_tok;
#pragma unroll
  for (int d = 0; d < D; ++d) qr[d] = to_float(qrow[d]) * scale;

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
  T* orow = out + ((int64_t)win * N + i) * C + (int64_t)h * D;
#pragma unroll
  for (int d = 0; d < D; ++d) store(orow + d, acc[d] * inv);
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const float* bias,
           void* out, int Bn, int N, int C, int heads, int head_dim,
           long long stride_win, long long stride_tok, int nWh, int nWw,
           int w, int shift, float scale, cudaStream_t stream) {
  constexpr int D = 32;
  if (head_dim != D) return (int)cudaErrorInvalidValue;
  const dim3 grid(Bn, heads);
  const int threads = ((N + 31) / 32) * 32;
  const size_t smem = (size_t)2 * N * D * sizeof(float) + N * sizeof(int);
  window_attn_fwd_kernel<T, D><<<grid, threads, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, bias, (T*)out, N, C, stride_win,
      stride_tok, nWh, nWw, w, shift, scale);
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
  if (dtype == 0)
    return launch<float>(q, k, v, (const float*)bias, out, Bn, N, C, heads,
                         head_dim, stride_win, stride_tok, nWh, nWw, w, shift,
                         scale, (cudaStream_t)stream);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k, v, (const float*)bias, out, Bn, N, C,
                                 heads, head_dim, stride_win, stride_tok, nWh,
                                 nWw, w, shift, scale, (cudaStream_t)stream);
  return (int)cudaErrorInvalidValue;
}
