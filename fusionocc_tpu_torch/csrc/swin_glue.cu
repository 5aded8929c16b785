// Swin's block glue around the window attention: two row kernels.
//
// Replaces no TPU kernel: the JAX package and the port's plain path compose
// each block of separate ops (nn/swin.py, ops/swin_glue.py): LayerNorm
// (widened to fp32, normalised, narrowed), F.pad, torch.roll, the window
// partition, then after the attention the window reverse, a second roll, the
// crop, the residual add and the second LayerNorm.  On the card those were
// a dozen aten launches a block, each a full pass over the activation, with
// fp32 copies in the LayerNorms: about 44 passes over the bf16 activation a
// block, where the work needs about 8.
//
// window_in  (x, r?, norm1) -> (x + r, windows):
//   when r (the previous block's MLP output) is given, x' = x + r rounded to
//   x's dtype is written; the window token at padded-and-shifted position
//   (py, px) = ((wy w + ty + shift) mod Hp, (wx w + tx + shift) mod Wp)
//   gets LayerNorm(x'[py, px]) rounded once, or zeros where py >= H or
//   px >= W (the plain path pads the normed tensor).  Every real token is
//   one window token, so x' is written from the window-ordered walk.
// window_out (o, x, norm2) -> (x + o, norm2(x + o)):
//   each real token (h, w) reads o's row at window position
//   ((h - shift) mod Hp, (w - shift) mod Wp), writes x' = x + o rounded,
//   then LayerNorm(x') rounded.
//
// The rounding points are the plain path's: the residual stream is rounded
// after each add, the norm reads the rounded sum, statistics are fp32
// (mean, then the mean squared deviation from it), the normed value is
// rounded once.  Only the order of the fp32 sums differs.
//
// What bounds them: HBM bytes (no products, a few FLOPs a byte).  A group
// of G lanes owns a token row of C channels; each lane holds V 16-byte
// vectors of it in registers (lane l the vectors v G + l, so a group's
// loads and stores are contiguous), G = min(32, C / elements a vector): a
// half-warp a 256-byte row at C = 128 in bf16, a warp of 2 KB vectors at C
// = 1024.  The row never leaves registers between its load and its stores;
// the statistics are shuffle reductions within the group.  Groups stride
// over the rows, so a small stage still fills the card across the batch.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cstdint>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T narrow(float x);
template <> __device__ __forceinline__ float narrow<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16 narrow(float x) {
  return __float2bfloat16_rn(x);
}

// One lane's part of a row: V vectors of E = 16 / sizeof(T) channels.
template <typename T, int V>
struct Part {
  static constexpr int E = 16 / sizeof(T);
  float v[V * E];
};

// Vector k of a lane at (lane, G): channels (k G + lane) E ... + E - 1.
template <typename T, int G, int V>
__device__ __forceinline__ void load(const T* row, int lane, Part<T, V>& p) {
  constexpr int E = Part<T, V>::E;
#pragma unroll
  for (int k = 0; k < V; ++k) {
    const uint4 raw = *reinterpret_cast<const uint4*>(row + (k * G + lane) * E);
    const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int i = 0; i < E; ++i) p.v[k * E + i] = widen(e[i]);
  }
}

template <typename T, int G, int V>
__device__ __forceinline__ void store(T* row, int lane, const float* vals) {
  constexpr int E = Part<T, V>::E;
#pragma unroll
  for (int k = 0; k < V; ++k) {
    uint4 raw;
    T* e = reinterpret_cast<T*>(&raw);
#pragma unroll
    for (int i = 0; i < E; ++i) e[i] = narrow<T>(vals[k * E + i]);
    *reinterpret_cast<uint4*>(row + (k * G + lane) * E) = raw;
  }
}

template <typename T, int G, int V>
__device__ __forceinline__ void store_zero(T* row, int lane) {
  constexpr int E = Part<T, V>::E;
#pragma unroll
  for (int k = 0; k < V; ++k)
    *reinterpret_cast<uint4*>(row + (k * G + lane) * E) = make_uint4(0, 0, 0, 0);
}

// The group's sum of s (G lanes, aligned within the warp).
template <int G>
__device__ __forceinline__ float group_sum(float s, unsigned mask) {
#pragma unroll
  for (int o = G / 2; o > 0; o >>= 1) s += __shfl_xor_sync(mask, s, o, G);
  return s;
}

// The row's values rounded to T and back (the residual stream's rounding).
template <typename T, int V>
__device__ __forceinline__ void round_to(Part<T, V>& p) {
#pragma unroll
  for (int i = 0; i < V * Part<T, V>::E; ++i)
    p.v[i] = widen(narrow<T>(p.v[i]));
}

// LayerNorm of the row in p into y (fp32, not yet rounded): two-pass fp32
// statistics over the C channels, then (x - mean) rstd gamma + beta.
template <typename T, int G, int V>
__device__ __forceinline__ void normalise(const Part<T, V>& p,
                                          const float* gamma,
                                          const float* beta, int C, float eps,
                                          unsigned mask, float* y) {
  constexpr int N = V * Part<T, V>::E;
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < N; ++i) s += p.v[i];
  const float mean = group_sum<G>(s, mask) / C;
  float q = 0.f;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const float d = p.v[i] - mean;
    q = fmaf(d, d, q);
  }
  const float rstd = rsqrtf(group_sum<G>(q, mask) / C + eps);
#pragma unroll
  for (int i = 0; i < N; ++i)
    y[i] = fmaf((p.v[i] - mean) * rstd, gamma[i], beta[i]);
}

// The lane's gamma and beta, in the order of its part of a row.
template <typename T, int G, int V>
__device__ __forceinline__ void load_affine(const float* w, int lane,
                                            float* out) {
  constexpr int E = Part<T, V>::E;
#pragma unroll
  for (int k = 0; k < V; ++k)
#pragma unroll
    for (int i = 0; i < E; ++i) out[k * E + i] = w[(k * G + lane) * E + i];
}

struct Geometry {
  int H, W, C, w, shift, nWh, nWw, Hp, Wp;
};

template <typename T, int G, int V>
__global__ void __launch_bounds__(kThreads)
window_in_kernel(const T* __restrict__ x, const T* __restrict__ r,
                 T* __restrict__ xo, const float* __restrict__ gamma,
                 const float* __restrict__ beta, T* __restrict__ wins,
                 Geometry g, int64_t rows, float eps) {
  constexpr int N = V * Part<T, V>::E;
  const int lane = threadIdx.x % G;
  const unsigned mask =
      G == 32 ? 0xffffffffu : ((1u << G) - 1) << (threadIdx.x % 32 / G * G);
  float ga[N], be[N];
  load_affine<T, G, V>(gamma, lane, ga);
  load_affine<T, G, V>(beta, lane, be);
  const int n = g.w * g.w;
  const int64_t groups = (int64_t)gridDim.x * (kThreads / G);
  for (int64_t row = (int64_t)blockIdx.x * (kThreads / G) + threadIdx.x / G;
       row < rows; row += groups) {
    const int t = (int)(row % n);
    const int64_t win = row / n;
    const int wx = (int)(win % g.nWw);
    const int64_t bw = win / g.nWw;
    const int wy = (int)(bw % g.nWh);
    const int64_t b = bw / g.nWh;
    const int py = (wy * g.w + t / g.w + g.shift) % g.Hp;
    const int px = (wx * g.w + t % g.w + g.shift) % g.Wp;
    T* out = wins + row * g.C;
    if (py >= g.H || px >= g.W) {
      store_zero<T, G, V>(out, lane);
      continue;
    }
    const int64_t src = ((b * g.H + py) * g.W + px) * g.C;
    Part<T, V> p;
    load<T, G, V>(x + src, lane, p);
    if (r != nullptr) {
      Part<T, V> q;
      load<T, G, V>(r + src, lane, q);
#pragma unroll
      for (int i = 0; i < N; ++i) p.v[i] += q.v[i];
      round_to(p);
      store<T, G, V>(xo + src, lane, p.v);
    }
    float y[N];
    normalise<T, G, V>(p, ga, be, g.C, eps, mask, y);
    store<T, G, V>(out, lane, y);
  }
}

template <typename T, int G, int V>
__global__ void __launch_bounds__(kThreads)
window_out_kernel(const T* __restrict__ o, const T* __restrict__ x,
                  T* __restrict__ xo, const float* __restrict__ gamma,
                  const float* __restrict__ beta, T* __restrict__ h,
                  Geometry g, int64_t rows, float eps) {
  constexpr int N = V * Part<T, V>::E;
  const int lane = threadIdx.x % G;
  const unsigned mask =
      G == 32 ? 0xffffffffu : ((1u << G) - 1) << (threadIdx.x % 32 / G * G);
  float ga[N], be[N];
  load_affine<T, G, V>(gamma, lane, ga);
  load_affine<T, G, V>(beta, lane, be);
  const int64_t groups = (int64_t)gridDim.x * (kThreads / G);
  for (int64_t row = (int64_t)blockIdx.x * (kThreads / G) + threadIdx.x / G;
       row < rows; row += groups) {
    const int col = (int)(row % g.W);
    const int64_t bh = row / g.W;
    const int hh = (int)(bh % g.H);
    const int64_t b = bh / g.H;
    const int py = (hh - g.shift + g.Hp) % g.Hp;
    const int px = (col - g.shift + g.Wp) % g.Wp;
    const int64_t win = (b * g.nWh + py / g.w) * g.nWw + px / g.w;
    const int64_t src = (win * g.w * g.w + (py % g.w) * g.w + px % g.w) * g.C;
    Part<T, V> p, q;
    load<T, G, V>(x + row * g.C, lane, p);
    load<T, G, V>(o + src, lane, q);
#pragma unroll
    for (int i = 0; i < N; ++i) p.v[i] += q.v[i];
    round_to(p);
    store<T, G, V>(xo + row * g.C, lane, p.v);
    float y[N];
    normalise<T, G, V>(p, ga, be, g.C, eps, mask, y);
    store<T, G, V>(h + row * g.C, lane, y);
  }
}

int sm_count() {
  static int count = 0;
  if (count == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount, dev);
    if (count <= 0) count = 1;
  }
  return count;
}

// Both kernels take the same arguments: (a, b, xo, gamma, beta, out).
template <typename T>
using Kernel = void (*)(const T*, const T*, T*, const float*, const float*,
                        T*, Geometry, int64_t, float);

template <typename T, int G, int V>
Kernel<T> pick(bool in) {
  return in ? &window_in_kernel<T, G, V> : &window_out_kernel<T, G, V>;
}

// The instantiation for C channels: G lanes a row, V vectors a lane (G a
// power of two up to 32; V 1, 2, 4 or 8 once G is 32); null if none.
template <typename T>
Kernel<T> select(bool in, int C, int* lanes) {
  constexpr int E = 16 / sizeof(T);
  if (C <= 0 || C % E) return nullptr;
  const int vecs = C / E;
  *lanes = vecs < 32 ? vecs : 32;
  switch (vecs) {
    case 4: return pick<T, 4, 1>(in);
    case 8: return pick<T, 8, 1>(in);
    case 16: return pick<T, 16, 1>(in);
    case 32: return pick<T, 32, 1>(in);
    case 64: return pick<T, 32, 2>(in);
    case 128: return pick<T, 32, 4>(in);
    case 256: return pick<T, 32, 8>(in);
    default: return nullptr;
  }
}

template <typename T>
int run(bool in, const void* a, const void* b, void* xo, const void* gamma,
        const void* beta, void* out, int B, int H, int W, int C, int w,
        int shift, float eps, cudaStream_t stream) {
  int lanes = 0;
  const Kernel<T> k = select<T>(in, C, &lanes);
  if (k == nullptr || B < 0 || H <= 0 || W <= 0 || w <= 0 || shift < 0 ||
      shift >= w)
    return (int)cudaErrorInvalidValue;
  Geometry g;
  g.H = H, g.W = W, g.C = C, g.w = w, g.shift = shift;
  g.nWh = (H + w - 1) / w, g.nWw = (W + w - 1) / w;
  g.Hp = g.nWh * w, g.Wp = g.nWw * w;
  const int64_t rows = in ? (int64_t)B * g.Hp * g.Wp : (int64_t)B * H * W;
  if (rows == 0) return (int)cudaSuccess;
  const int per_block = kThreads / lanes;
  const int64_t need = (rows + per_block - 1) / per_block;
  const int64_t cap = (int64_t)sm_count() * 8;
  const int blocks = (int)(need < cap ? need : cap);
  k<<<blocks, kThreads, 0, stream>>>((const T*)a, (const T*)b, (T*)xo,
                                     (const float*)gamma, (const float*)beta,
                                     (T*)out, g, rows, eps);
  return (int)cudaGetLastError();
}

int dispatch(bool in, const void* a, const void* b, void* xo,
             const void* gamma, const void* beta, void* out, int B, int H,
             int W, int C, int w, int shift, float eps, int dtype,
             void* stream) {
  return dtype ? run<__nv_bfloat16>(in, a, b, xo, gamma, beta, out, B, H, W,
                                    C, w, shift, eps, (cudaStream_t)stream)
               : run<float>(in, a, b, xo, gamma, beta, out, B, H, W, C, w,
                            shift, eps, (cudaStream_t)stream);
}

}  // namespace

// x (B, H W, C), r (the same, or null: then xo is not written), xo, norm1's
// gamma and beta (C fp32), wins (B nWh nWw, w w, C); dtype 0 f32, 1 bf16.
extern "C" int window_in_fwd(const void* x, const void* r, void* xo,
                             const void* gamma, const void* beta, void* wins,
                             int B, int H, int W, int C, int w, int shift,
                             float eps, int dtype, void* stream) {
  return dispatch(true, x, r, xo, gamma, beta, wins, B, H, W, C, w, shift,
                  eps, dtype, stream);
}

// o (B nWh nWw, w w, C), x (B, H W, C), xo, norm2's gamma and beta, h (B,
// H W, C).
extern "C" int window_out_fwd(const void* o, const void* x, void* xo,
                              const void* gamma, const void* beta, void* h,
                              int B, int H, int W, int C, int w, int shift,
                              float eps, int dtype, void* stream) {
  return dispatch(false, o, x, xo, gamma, beta, h, B, H, W, C, w, shift, eps,
                  dtype, stream);
}
