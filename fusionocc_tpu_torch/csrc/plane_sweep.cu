// The plane-sweep stereo cost volume of BEVStereo4D-Occ, one launch a volume.
//
// Replaces no TPU kernel: the JAX package computes the volume with XLA ops
// (fusionocc_tpu/models/lss_base.py stereo_cost_volume: the grid's einsums,
// then per channel group a gather-based grid_sample, the L1 distance and a
// sum), and the port first ran the same as plain PyTorch
// (ops/plane_sweep.py stereo_grid and plane_sweep, the CPU path of the
// custom op fusionocc::plane_sweep).  On the card those were about 185
// launches a volume, each moving some 380 MB of fp32 intermediates: about
// 36 ms a volume against the 0.454 ms the work needs.
//
// Per hypothesis (camera n, plane d, pixel y, x) this kernel
//   - projects the frustum point into the previous camera with the
//     per-camera pieces ops/plane_sweep.py sweep_geometry composed, in
//     stereo_grid's chain and order, in fp32 rounded op by op (no
//     contraction outside the 3-term dot products, which are fma chains);
//     normalises over the input image and maps onto the stage-0 map as
//     grid_sample(align_corners=True) does;
//   - samples the previous feature bilinearly, zeros outside: each of the
//     four taps is one contiguous row of C channels, read as 16-byte
//     vectors and widened to fp32; a tap outside the map weighs 0 and the
//     footprint is moved inside, so every read is in bounds and the taps
//     that count are summed in grid_sample's order (for finite features
//     the sum grid_sample's skipped taps give);
//   - sums |curr - sample| over the C channels in fp32 (curr less each
//     tap's product in turn: the sample's sum in another order), adds the
//     invalid bias where the sample of channel `bias_ch` (taken by the
//     projecting lane in grid_sample's order) is exactly 0;
// then takes the softmax of -cost over the D planes and writes the
// (B*N, D, H, W) fp32 volume.  No grid or intermediate touches memory.
//
// What bounds it: instruction issue on the CUDA cores.  An L1 distance has
// no product for the tensor cores.  Per hypothesis and channel: 4 widenings
// (bf16 -> fp32 is one integer op), 4 fma and an add taking |.| as a free
// modifier; per hypothesis the projection (about 200 instructions, 4 of
// them divisions) and the bias channel's sample.  Bytes are small: one
// camera's previous feature is 11.5 MB of bf16 at the published shapes,
// and neighbouring planes and pixels sample neighbouring rows, so taps come
// from L1 and L2.
//
// Layout: a block is 16 consecutive pixels of one row of one camera, a
// group of kLanes = 8 lanes per pixel, each lane C/8 channels (16 at C =
// 128: two 16-byte bf16 vectors a tap).  A group walks its pixel through
// the planes in chunks of 8: each lane projects one plane of the chunk into
// shared memory (weights, base row, bias flag), then the group samples the
// chunk's 8 planes, each lane summing its channels; a reduce-scatter over
// the 8 lanes leaves lane l the cost of the chunk's plane l, which goes to
// a (D, 16) tile in shared memory.  After the last chunk the group takes
// its pixel's softmax from the tile, and the block stores the tile
// coalesced along W.
#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kLanes = 8;                  // lanes of one pixel (a group)
constexpr int kPixels = 16;                // pixels of a block, along W
constexpr int kThreads = kLanes * kPixels;
constexpr int kMaxPlanes = 128;
constexpr int kCamWords = 37;              // ops/plane_sweep.py CAM_WORDS
// offsets of the pieces in a camera's words
constexpr int kPostTrans = 0, kInvPost = 3, kCombine = 12, kTrans = 21,
              kIntrins = 24, kPostRot = 33;

// A hypothesis's sample: the 2x2 footprint at base, base + 1, base + W,
// base + W + 1 (rows of C channels), always inside the map, and the weight
// of each tap; a tap of grid_sample's footprint that lies outside weighs 0
// and the footprint is moved inside, each weight with its tap, so the taps
// that count are summed in grid_sample's order (nw, ne, sw, se).
struct __align__(16) Tap {
  float w[4];
  int base;
  int zero;        // the sample of the bias channel is exactly 0
  int pad[2];
};

__device__ __forceinline__ float dot3(const float* a, float b0, float b1,
                                      float b2) {
  return __fmaf_rn(a[2], b2, __fmaf_rn(a[1], b1, __fmul_rn(a[0], b0)));
}

__device__ __forceinline__ float widen1(uint16_t x) {
  return __uint_as_float((uint32_t)x << 16);
}
__device__ __forceinline__ float widen1(float x) { return x; }

// The first two terms of the inverse post-rotation's rows at pixel (u, v):
// the part of stereo_grid's first product that no plane changes.
__device__ __forceinline__ void pixel_terms(const float* cam, float u,
                                           float v, float* a) {
  const float* pt = cam + kPostTrans;
  const float p0 = __fsub_rn(u, pt[0]), p1 = __fsub_rn(v, pt[1]);
  const float* ip = cam + kInvPost;
#pragma unroll
  for (int i = 0; i < 3; ++i)
    a[i] = __fmaf_rn(ip[3 * i + 1], p1, __fmul_rn(ip[3 * i], p0));
}

// The hypothesis at depth dz of the pixel whose terms are `a`: stereo_grid's
// chain, then grid_sample's unnormalisation and bilinear weights; and the
// sample of channel `bias_ch`, summed in the same order as the main loop
// would (products of the taps in nw, ne, sw, se order).
template <typename T>
__device__ Tap project(const float* cam, const float* a, float dz,
                       const T* prev_n, int H, int W, int C, float wi1,
                       float hi1, int bias_ch) {
  const float* pt = cam + kPostTrans;
  const float p2 = __fsub_rn(dz, pt[2]);
  const float* ip = cam + kInvPost;
  const float q0 = __fmaf_rn(ip[2], p2, a[0]),
              q1 = __fmaf_rn(ip[5], p2, a[1]),
              q2 = __fmaf_rn(ip[8], p2, a[2]);
  const float r0 = __fmul_rn(q0, q2), r1 = __fmul_rn(q1, q2);
  const float* cb = cam + kCombine;
  const float* tr = cam + kTrans;
  const float s0 = __fadd_rn(dot3(cb, r0, r1, q2), tr[0]),
              s1 = __fadd_rn(dot3(cb + 3, r0, r1, q2), tr[1]),
              s2 = __fadd_rn(dot3(cb + 6, r0, r1, q2), tr[2]);
  const bool behind = s2 < 1e-3f;
  const float* in = cam + kIntrins;
  const float t0 = dot3(in, s0, s1, s2), t1 = dot3(in + 3, s0, s1, s2),
              t2 = dot3(in + 6, s0, s1, s2);
  const float z = fmaxf(t2, 1e-6f);
  const float a0 = __fdiv_rn(t0, z), a1 = __fdiv_rn(t1, z);
  const float* pr = cam + kPostRot;
  const float b0 = __fadd_rn(__fmaf_rn(pr[1], a1, __fmul_rn(pr[0], a0)),
                             pt[0]);
  const float b1 = __fadd_rn(__fmaf_rn(pr[3], a1, __fmul_rn(pr[2], a0)),
                             pt[1]);
  float px = __fsub_rn(__fmul_rn(__fdiv_rn(b0, wi1), 2.f), 1.f);
  float py = __fsub_rn(__fmul_rn(__fdiv_rn(b1, hi1), 2.f), 1.f);
  if (behind) px = py = -2.f;
  // grid_sample(align_corners=True): ((g + 1) / 2) * (size - 1)
  const float ix = __fmul_rn(__fmul_rn(__fadd_rn(px, 1.f), 0.5f),
                             (float)(W - 1));
  const float iy = __fmul_rn(__fmul_rn(__fadd_rn(py, 1.f), 0.5f),
                             (float)(H - 1));
  Tap t;
  t.w[0] = t.w[1] = t.w[2] = t.w[3] = 0.f;
  t.base = 0;
  // a sample with every tap outside (or a NaN coordinate) weighs nothing
  if (ix > -1.f && ix < (float)W && iy > -1.f && iy < (float)H) {
    const float fx = floorf(ix), fy = floorf(iy);
    int x0 = (int)fx, y0 = (int)fy;        // in [-1, W - 1], [-1, H - 1]
    const float ex = __fsub_rn(__fadd_rn(fx, 1.f), ix),
                ey = __fsub_rn(__fadd_rn(fy, 1.f), iy);
    const float gx = __fsub_rn(ix, fx), gy = __fsub_rn(iy, fy);
    float w[4] = {__fmul_rn(ex, ey), __fmul_rn(gx, ey), __fmul_rn(ex, gy),
                  __fmul_rn(gx, gy)};
    if (x0 < 0) {                 // column x0 outside: x0 + 1 moves left
      w[0] = w[1], w[2] = w[3], w[1] = w[3] = 0.f, x0 = 0;
    } else if (x0 == W - 1) {     // column x0 + 1 outside: x0 moves right
      w[1] = w[0], w[3] = w[2], w[0] = w[2] = 0.f, x0 = W - 2;
    }
    if (y0 < 0) {
      w[0] = w[2], w[1] = w[3], w[2] = w[3] = 0.f, y0 = 0;
    } else if (y0 == H - 1) {
      w[2] = w[0], w[3] = w[1], w[0] = w[1] = 0.f, y0 = H - 2;
    }
#pragma unroll
    for (int k = 0; k < 4; ++k) t.w[k] = w[k];
    t.base = y0 * W + x0;
  }
  const T* row = prev_n + (long long)t.base * C + bias_ch;
  float sb = __fmul_rn(widen1(__ldg(row)), t.w[0]);
  sb = __fmaf_rn(widen1(__ldg(row + C)), t.w[1], sb);
  sb = __fmaf_rn(widen1(__ldg(row + (long long)W * C)), t.w[2], sb);
  sb = __fmaf_rn(widen1(__ldg(row + (long long)(W + 1) * C)), t.w[3], sb);
  t.zero = sb == 0.f;               // -0 too, as plane_sweep's test
  return t;
}

// 8 channels from 16-byte vectors of T, widened to fp32 as .to(float32)
template <typename T>
struct Chunk;

template <>
struct Chunk<uint16_t> {     // bf16
  static constexpr int kVec = 1;
  static __device__ __forceinline__ void widen(const uint4* r, float* v) {
    const uint32_t w[4] = {r[0].x, r[0].y, r[0].z, r[0].w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      v[2 * i] = __uint_as_float(w[i] << 16);
      v[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
};

template <>
struct Chunk<float> {
  static constexpr int kVec = 2;
  static __device__ __forceinline__ void widen(const uint4* r, float* v) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      v[4 * i] = __uint_as_float(r[i].x);
      v[4 * i + 1] = __uint_as_float(r[i].y);
      v[4 * i + 2] = __uint_as_float(r[i].z);
      v[4 * i + 3] = __uint_as_float(r[i].w);
    }
  }
};

// CPL channels a lane: chunks q of 8 channels at (q * kLanes + lane) * 8
template <typename T, int CPL>
__global__ void __launch_bounds__(kThreads, 5)
plane_sweep_kernel(const T* __restrict__ prev, const T* __restrict__ curr,
                   const float* __restrict__ frustum,
                   const float* __restrict__ cams, float* __restrict__ out,
                   uint8_t* __restrict__ invalid, int D, int H, int W,
                   float wi1, float hi1, int bias_ch, float bias) {
  constexpr int C = CPL * kLanes;
  constexpr int kChunks = CPL / 8;
  constexpr int kVec = Chunk<T>::kVec;
  extern __shared__ float tile[];          // (D, kPixels + 1)
  __shared__ float cam[kCamWords];
  __shared__ Tap taps[kPixels][kLanes];

  const int bn = blockIdx.z, y = blockIdx.y, x0 = blockIdx.x * kPixels;
  const int group = threadIdx.x / kLanes, lane = threadIdx.x % kLanes;
  if (threadIdx.x < kCamWords)
    cam[threadIdx.x] = cams[bn * kCamWords + threadIdx.x];
  __syncthreads();
  // a pixel past the row's end repeats the last one and stores nothing
  const bool stores = x0 + group < W;
  const int x = stores ? x0 + group : W - 1;
  const size_t plane_px = (size_t)H * W;
  const T* prev_n = prev + (size_t)bn * plane_px * C;

  float c[CPL];
#pragma unroll
  for (int q = 0; q < kChunks; ++q) {
    const uint4* src = reinterpret_cast<const uint4*>(
        curr + ((size_t)bn * plane_px + (size_t)y * W + x) * C +
        (q * kLanes + lane) * 8);
    uint4 r[kVec];
#pragma unroll
    for (int i = 0; i < kVec; ++i) r[i] = __ldg(src + i);
    Chunk<T>::widen(r, c + 8 * q);
  }
  float a[3];
  pixel_terms(cam, frustum[(size_t)x * 3], frustum[(size_t)y * W * 3 + 1],
              a);
  const long long down = (long long)W * C;
  for (int d0 = 0; d0 < D; d0 += kLanes) {
    // each lane projects one plane of the chunk for the group
    const int dl = min(d0 + lane, D - 1);
    const Tap mine = project(cam, a, frustum[(size_t)dl * plane_px * 3 + 2],
                             prev_n, H, W, C, wi1, hi1, bias_ch);
    taps[group][lane] = mine;
    __syncwarp();
    float part[kLanes];
#pragma unroll
    for (int j = 0; j < kLanes; ++j) {
      const Tap t = taps[group][j];
      const T* p = prev_n + (long long)t.base * C + lane * 8;
      const T* tap[4] = {p, p + C, p + down, p + down + C};
      float acc = 0.f;
#pragma unroll
      for (int q = 0; q < kChunks; ++q) {
        uint4 r[4][kVec];
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const uint4* src =
              reinterpret_cast<const uint4*>(tap[k] + q * kLanes * 8);
#pragma unroll
          for (int i = 0; i < kVec; ++i) r[k][i] = __ldg(src + i);
        }
        // curr - sample, the taps' products subtracted in turn
        float e[8], tv[8];
#pragma unroll
        for (int i = 0; i < 8; ++i) e[i] = c[8 * q + i];
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          Chunk<T>::widen(r[k], tv);
#pragma unroll
          for (int i = 0; i < 8; ++i) e[i] = __fmaf_rn(tv[i], -t.w[k], e[i]);
        }
#pragma unroll
        for (int i = 0; i < 8; ++i) acc = __fadd_rn(acc, fabsf(e[i]));
      }
      part[j] = acc;
    }
    __syncwarp();          // the next chunk overwrites taps
    // reduce-scatter: lane l ends with the group's cost of plane d0 + l
#pragma unroll
    for (int h = kLanes / 2; h >= 1; h /= 2) {
      const bool upper = lane & h;
#pragma unroll
      for (int i = 0; i < h; ++i) {
        const float send = upper ? part[i] : part[i + h];
        const float keep = upper ? part[i + h] : part[i];
        part[i] = __fadd_rn(keep, __shfl_xor_sync(0xffffffffu, send, h));
      }
    }
    if (d0 + lane < D) {
      tile[(d0 + lane) * (kPixels + 1) + group] =
          mine.zero ? __fadd_rn(part[0], bias) : part[0];
      if (invalid != nullptr && stores)
        invalid[((size_t)bn * D + d0 + lane) * plane_px + (size_t)y * W + x] =
            mine.zero;
    }
  }
  __syncwarp();
  // softmax over the planes of -cost, the group's pixel
  float* col = tile + group;
  float m = -__int_as_float(0x7f800000);     // -inf
  for (int d = lane; d < D; d += kLanes)
    m = fmaxf(m, -col[d * (kPixels + 1)]);
#pragma unroll
  for (int h = kLanes / 2; h >= 1; h /= 2)
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, h));
  float sum = 0.f;
  for (int d = lane; d < D; d += kLanes) {
    const float e = expf(__fsub_rn(-col[d * (kPixels + 1)], m));
    col[d * (kPixels + 1)] = e;
    sum = __fadd_rn(sum, e);
  }
#pragma unroll
  for (int h = kLanes / 2; h >= 1; h /= 2)
    sum = __fadd_rn(sum, __shfl_xor_sync(0xffffffffu, sum, h));
  for (int d = lane; d < D; d += kLanes)
    col[d * (kPixels + 1)] = __fdiv_rn(col[d * (kPixels + 1)], sum);
  __syncthreads();
  float* dst = out + (size_t)bn * D * plane_px + (size_t)y * W + x0;
  for (int i = threadIdx.x; i < D * kPixels; i += kThreads) {
    const int d = i / kPixels, p = i % kPixels;
    if (x0 + p < W)
      dst[(size_t)d * plane_px + p] = tile[d * (kPixels + 1) + p];
  }
}

template <typename T, int CPL>
int launch(const void* prev, const void* curr, const void* frustum,
           const void* cams, void* out, void* invalid, int BN, int D, int H,
           int W, int hi, int wi, int bias_ch, float bias,
           cudaStream_t stream) {
  const dim3 grid((W + kPixels - 1) / kPixels, H, BN);
  const size_t smem = (size_t)D * (kPixels + 1) * sizeof(float);
  plane_sweep_kernel<T, CPL><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(prev), static_cast<const T*>(curr),
      static_cast<const float*>(frustum), static_cast<const float*>(cams),
      static_cast<float*>(out), static_cast<uint8_t*>(invalid), D, H, W,
      (float)(wi - 1), (float)(hi - 1), bias_ch, bias);
  return (int)cudaGetLastError();
}

}  // namespace

// prev, curr (BN, H, W, C) in fp32 (dtype 0) or bf16 (1), C 64 or 128;
// frustum (D, H, W, 3) fp32, its axes read from row (0, 0), column (0, ., 0)
// and (., 0, 0); cams (BN, 37) fp32; out (BN, D, H, W) fp32; invalid, when
// not null, (BN, D, H, W) uint8 receiving each hypothesis's bias flag; hi,
// wi the input image the grid is normalised over; bias_ch the channel whose
// zero sample takes the bias.
extern "C" int plane_sweep_fwd(const void* prev, const void* curr,
                               const void* frustum, const void* cams,
                               void* out, void* invalid, int BN, int D, int H,
                               int W, int C, int hi, int wi, int bias_ch,
                               float bias, int dtype, void* stream) {
  if (BN == 0) return (int)cudaSuccess;
  if (D <= 0 || D > kMaxPlanes || H < 2 || W < 2 ||
      (C != 64 && C != 128) || bias_ch < 0 || bias_ch >= C)
    return (int)cudaErrorInvalidValue;
  using Launch = int (*)(const void*, const void*, const void*, const void*,
                         void*, void*, int, int, int, int, int, int, int,
                         float, cudaStream_t);
  const Launch run = dtype ? (C == 128 ? &launch<uint16_t, 16>
                                       : &launch<uint16_t, 8>)
                           : (C == 128 ? &launch<float, 16>
                                       : &launch<float, 8>);
  return run(prev, curr, frustum, cams, out, invalid, BN, D, H, W, hi, wi,
             bias_ch, bias, (cudaStream_t)stream);
}
