// Frustum-to-voxel pooling forward.
//
// Replaces the TPU kernel fusionocc_tpu/ops/pallas/segsum.py::_kernel (a
// blocked inclusive scan of depth*feat whose differences at `bounds` give the
// segment sums).  On Hopper no scan is needed: points are sorted by voxel
// rank and `bounds[v]..bounds[v+1]` is voxel v's run, so each voxel's run is
// gathered and summed directly in fp32:
//
//   out[v, c] = sum_{p in [bounds[v], bounds[v+1])}
//                   depth[ranks_depth[p]] * feat[ranks_feat[p], c]
//
// cast once to the output type (fp32 or bf16, round to nearest even).
//
// What bounds it: bytes, and the latency of the gather chain bounds ->
// ranks -> (depth, feature row) -> store.  The output (one row per voxel,
// half of them empty) is most of the bytes; the depth (5.9 MB) and the
// feature rows (1-2 MB) are gathered from L2.  The runs are skewed: at full
// size the median run is 1 point and the longest 480.  The design:
//
// - Work table (ops/bev_pool.py, built once per rig with the index): a run
//   of at most max_short points is a short item, summed by a group of
//   G = C/8 lanes, each lane owning 8 channels; short items need no table
//   beyond bounds.  Longer runs are listed in long_voxels, longest first,
//   and each is one warp's item: the 32 lanes load 32 points' ranks at a
//   time and the 32/G sub-groups of G lanes stride over them.  The long
//   items take the first blocks of the grid, so the longest start first.
//   No thread walks a run point by point.
// - Short items, 32 voxels per warp: one coalesced load brings the 32 runs'
//   bounds, and every group loads the ranks of all its G voxels before it
//   gathers any row, so a warp has G voxels' gathers in flight per group
//   and the bounds load is paid once per 32 voxels, empty ones included.
// - Loads issued together: a group's lanes load a batch of points' ranks
//   and depth values, pass them round the group with __shfl_sync, and every
//   lane issues the 16-byte feature-row loads of the whole batch before it
//   uses any of them.  A long item prefetches its next batch's ranks while
//   its rows load.
// - feat in its own dtype (fp32 or bf16), widened in registers; sums in fp32.
// - Epilogue templated on the output type: bf16 rows are rounded once and
//   stored as 16-byte streaming stores (__stcs), fp32 rows as two.
// - Every voxel is written exactly once, by its short group or its long warp:
//   empty voxels get zeros from the same launch, with no memset.  A short
//   run is summed point by point in order; a long run's sub-group sums are
//   combined by a fixed xor tree of shuffles.  There are no atomics, so two
//   launches give bit-identical outputs.  Points past bounds[num_voxels]
//   (outside the grid) are never read.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cstdint>
#include <type_traits>

namespace {

constexpr int kCh = 8;          // channels per lane
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
// Feature rows a short group loads per batch (rounded up to a multiple of
// G; half as many from fp32 features: the same registers), and the blocks
// an SM must hold, which caps the registers; tools/ab_bev_pool_split.py
// measures both.
constexpr int kShortRows = 4;
constexpr int kMinBlocks = 4;

// 8 channels of one feature row, as loaded
template <bool kBf16> struct Row;
template <> struct Row<true> { uint4 u; };
template <> struct Row<false> { float4 a, b; };

__device__ __forceinline__ void load_row(const __nv_bfloat16* feat,
                                         int64_t off, Row<true>& r) {
  r.u = __ldg(reinterpret_cast<const uint4*>(feat + off));
}

__device__ __forceinline__ void load_row(const float* feat, int64_t off,
                                         Row<false>& r) {
  const float4* p = reinterpret_cast<const float4*>(feat + off);
  r.a = __ldg(p);
  r.b = __ldg(p + 1);
}

// acc += d * row; a bf16 widens exactly by a 16-bit shift (the low half of
// each 32-bit word is the lower channel)
__device__ __forceinline__ void fma_row(float (&acc)[kCh], float d,
                                        const Row<true>& r) {
  const uint32_t w[4] = {r.u.x, r.u.y, r.u.z, r.u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    acc[2 * i] = fmaf(d, __uint_as_float(w[i] << 16), acc[2 * i]);
    acc[2 * i + 1] = fmaf(d, __uint_as_float(w[i] & 0xffff0000u),
                          acc[2 * i + 1]);
  }
}

__device__ __forceinline__ void fma_row(float (&acc)[kCh], float d,
                                        const Row<false>& r) {
  const float f[kCh] = {r.a.x, r.a.y, r.a.z, r.a.w, r.b.x, r.b.y, r.b.z, r.b.w};
#pragma unroll
  for (int i = 0; i < kCh; ++i) acc[i] = fmaf(d, f[i], acc[i]);
}

__device__ __forceinline__ void store_row(__nv_bfloat16* out, int64_t off,
                                          const float (&acc)[kCh]) {
  uint4 u;
  uint32_t* w = reinterpret_cast<uint32_t*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(acc[2 * i], acc[2 * i + 1]);
    w[i] = *reinterpret_cast<const uint32_t*>(&h);
  }
  __stcs(reinterpret_cast<uint4*>(out + off), u);
}

__device__ __forceinline__ void store_row(float* out, int64_t off,
                                          const float (&acc)[kCh]) {
  float4* p = reinterpret_cast<float4*>(out + off);
  __stcs(p, make_float4(acc[0], acc[1], acc[2], acc[3]));
  __stcs(p + 1, make_float4(acc[4], acc[5], acc[6], acc[7]));
}

// One warp sums voxel v's run (longer than max_short).  Per batch of 32
// points, lane l holds point base + l's feature rank and depth value;
// sub-group sg = lane / G takes points sg, sg + S, ..., sg + (G-1)*S
// (S = 32 / G sub-groups), each lane its 8 channels of those rows.  The S
// partial sums are then added by a xor tree over the sub-group bits.
template <typename TF, typename TO, int G>
__device__ __forceinline__ void long_item(
    const float* __restrict__ depth, const TF* __restrict__ feat,
    const int32_t* __restrict__ ranks_depth,
    const int32_t* __restrict__ ranks_feat, int begin, int end, int v,
    TO* __restrict__ out) {
  constexpr int C = G * kCh;
  constexpr int S = 32 / G;
  constexpr bool kBf16 = sizeof(TF) == 2;
  const int lane = threadIdx.x & 31;
  const int sub = lane % G, sg = lane / G;
  float acc[kCh] = {};
  int rf = 0;
  float d = 0.f;
  if (begin + lane < end) {
    rf = ranks_feat[begin + lane];
    d = depth[ranks_depth[begin + lane]];
  }
  for (int base = begin; base < end; base += 32) {
    Row<kBf16> rows[G];
    float dj[G];
#pragma unroll
    for (int k = 0; k < G; ++k) {
      const int j = sg + k * S;
      const int rfj = __shfl_sync(0xffffffffu, rf, j);
      if (base + j < end) load_row(feat, (int64_t)rfj * C + sub * kCh, rows[k]);
    }
    // the depth values are shared once the row loads are in flight
#pragma unroll
    for (int k = 0; k < G; ++k) dj[k] = __shfl_sync(0xffffffffu, d, sg + k * S);
    // the next batch's ranks load while this batch's rows arrive
    const int pn = base + 32 + lane;
    int rdn = 0;
    rf = 0;
    if (pn < end) {
      rdn = ranks_depth[pn];
      rf = ranks_feat[pn];
    }
#pragma unroll
    for (int k = 0; k < G; ++k)
      if (base + sg + k * S < end) fma_row(acc, dj[k], rows[k]);
    d = pn < end ? depth[rdn] : 0.f;
  }
#pragma unroll
  for (int off = G; off < 32; off <<= 1)
#pragma unroll
    for (int i = 0; i < kCh; ++i)
      acc[i] += __shfl_xor_sync(0xffffffffu, acc[i], off);
  if (sg == 0) store_row(out, (int64_t)v * C + sub * kCh, acc);
}

// Adds one batch of B = R*G points of a short run, [base, end) cut to B, to
// acc.  Lane sub of the group of G lanes holds points base + sub + k*G
// (k < R): their feature ranks rf[k] and depth values d[k].  The group
// shares them by __shfl_sync, and every lane issues the B row loads before
// it adds any; the depth values are shared once the row loads are in
// flight, so the rows wait on the ranks only, not on the depth gather.
template <typename TF, int G, int R>
__device__ __forceinline__ void add_batch(float (&acc)[kCh],
                                          const TF* __restrict__ feat,
                                          const int (&rf)[R],
                                          const float (&d)[R], int base,
                                          int end, int sub, unsigned mask) {
  constexpr int C = G * kCh;
  constexpr int B = R * G;
  constexpr bool kBf16 = sizeof(TF) == 2;
  Row<kBf16> rows[B];
  float dj[B];
#pragma unroll
  for (int j = 0; j < B; ++j) {
    const int rfj = __shfl_sync(mask, rf[j / G], j % G, G);
    if (base + j < end) load_row(feat, (int64_t)rfj * C + sub * kCh, rows[j]);
  }
#pragma unroll
  for (int j = 0; j < B; ++j) dj[j] = __shfl_sync(mask, d[j / G], j % G, G);
#pragma unroll
  for (int j = 0; j < B; ++j)
    if (base + j < end) fma_row(acc, dj[j], rows[j]);
}

// Lane sub's ranks and depth values of points base + sub + k*G (k < R) of
// a run ending at end; zeros past it.
template <int G, int R>
__device__ __forceinline__ void load_ranks(
    const float* __restrict__ depth, const int32_t* __restrict__ ranks_depth,
    const int32_t* __restrict__ ranks_feat, int base, int end, int sub,
    int (&rf)[R], float (&d)[R]) {
#pragma unroll
  for (int k = 0; k < R; ++k) {
    const int p = base + sub + k * G;
    rf[k] = 0;
    d[k] = 0.f;
    if (p < end) {
      rf[k] = ranks_feat[p];
      d[k] = depth[ranks_depth[p]];
    }
  }
}

// One warp writes the 32 voxels [v0, v0 + 32): the 32/G groups of G lanes
// take G rounds of 32/G voxels each.  Lane l loads voxel v0 + l's run
// bounds, so one coalesced load serves all rounds; then every round's first
// batch of ranks and depth values is loaded before any round's rows, so the
// rounds' gathers overlap.  A run longer than max_short is skipped (its
// warp item writes it); a run longer than one batch B but at most max_short
// adds its later batches in a loop.  Empty voxels are written as zeros.
template <typename TF, typename TO, int G>
__device__ __forceinline__ void short_span(
    const float* __restrict__ depth, const TF* __restrict__ feat,
    const int32_t* __restrict__ ranks_depth,
    const int32_t* __restrict__ ranks_feat,
    const int32_t* __restrict__ bounds, int v0, int num_voxels,
    int max_short, TO* __restrict__ out) {
  constexpr int C = G * kCh;
  constexpr int NG = 32 / G;       // groups per warp: voxels per round
  constexpr bool kBf16 = sizeof(TF) == 2;
  // kShortRows rows in flight from bf16 features, half as many from fp32
  // (the same registers)
  constexpr int R = ((kBf16 ? kShortRows : kShortRows / 2) + G - 1) / G;
  constexpr int B = R * G;
  const int lane = threadIdx.x & 31;
  const int sub = lane % G, q = lane / G;
  const unsigned mask = (G == 32 ? 0xffffffffu : ((1u << G) - 1u))
                        << (lane - sub);
  int bl = 0, el = 0;
  if (v0 + lane < num_voxels) {
    bl = bounds[v0 + lane];
    el = bounds[v0 + lane + 1];
  }
  int begin[G], end[G], rf[G][R];
  float d[G][R];
#pragma unroll
  for (int r = 0; r < G; ++r) {
    begin[r] = __shfl_sync(0xffffffffu, bl, r * NG + q);
    end[r] = __shfl_sync(0xffffffffu, el, r * NG + q);
    if (end[r] - begin[r] > max_short) end[r] = begin[r] - 1;   // long item
    load_ranks<G, R>(depth, ranks_depth, ranks_feat, begin[r], end[r], sub,
                     rf[r], d[r]);
  }
#pragma unroll
  for (int r = 0; r < G; ++r) {
    const int v = v0 + r * NG + q;
    if (v >= num_voxels || end[r] < begin[r]) continue;   // the whole group
    float acc[kCh] = {};
    add_batch<TF, G, R>(acc, feat, rf[r], d[r], begin[r], end[r], sub, mask);
    for (int base = begin[r] + B; base < end[r]; base += B) {
      int rf_t[R];
      float d_t[R];
      load_ranks<G, R>(depth, ranks_depth, ranks_feat, base, end[r], sub,
                       rf_t, d_t);
      add_batch<TF, G, R>(acc, feat, rf_t, d_t, base, end[r], sub, mask);
    }
    store_row(out, (int64_t)v * C + sub * kCh, acc);
  }
}

template <bool kBf16>
using Elem = typename std::conditional<kBf16, __nv_bfloat16, float>::type;

// Blocks [0, long_blocks) run the long items, one per warp; the rest write
// the other voxels, 32 per warp.  A voxel whose run is longer than
// max_short is skipped there: its warp item writes it.
template <bool kFeatBf16, bool kOutBf16, int G>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
    bev_pool_fwd_kernel(const float* __restrict__ depth,
                        const Elem<kFeatBf16>* __restrict__ feat,
                        const int32_t* __restrict__ ranks_depth,
                        const int32_t* __restrict__ ranks_feat,
                        const int32_t* __restrict__ bounds,
                        const int32_t* __restrict__ long_voxels, int n_long,
                        int long_blocks, Elem<kOutBf16>* __restrict__ out,
                        int num_voxels, int max_short) {
  using TF = Elem<kFeatBf16>;
  using TO = Elem<kOutBf16>;
  const int warp = blockIdx.x * kWarps + threadIdx.x / 32;
  if ((int)blockIdx.x < long_blocks) {
    if (warp >= n_long) return;                 // the whole warp
    const int v = long_voxels[warp];
    if (v < 0) return;                          // padding of a static table
    long_item<TF, TO, G>(depth, feat, ranks_depth, ranks_feat, bounds[v],
                         bounds[v + 1], v, out);
    return;
  }
  const int v0 = (warp - long_blocks * kWarps) * 32;
  if (v0 >= num_voxels) return;                 // the whole warp
  short_span<TF, TO, G>(depth, feat, ranks_depth, ranks_feat, bounds, v0,
                        num_voxels, max_short, out);
}

template <bool kFeatBf16, bool kOutBf16>
int launch(const void* depth, const void* feat, const void* ranks_depth,
           const void* ranks_feat, const void* bounds, const void* long_voxels,
           int n_long, void* out, int num_voxels, int C, int max_short,
           cudaStream_t stream) {
  const int G = C / kCh;
  const int long_blocks = (n_long + kWarps - 1) / kWarps;
  const int64_t short_blocks =
      ((int64_t)num_voxels + 32 * kWarps - 1) / (32 * kWarps);
  const unsigned grid = (unsigned)(long_blocks + short_blocks);
#define FO_BEV_POOL_LAUNCH(g)                                                \
  bev_pool_fwd_kernel<kFeatBf16, kOutBf16, g><<<grid, kThreads, 0, stream>>>( \
      (const float*)depth, (const Elem<kFeatBf16>*)feat,                     \
      (const int32_t*)ranks_depth, (const int32_t*)ranks_feat,               \
      (const int32_t*)bounds, (const int32_t*)long_voxels, n_long,           \
      long_blocks, (Elem<kOutBf16>*)out, num_voxels, max_short)
  switch (G) {
    case 1: FO_BEV_POOL_LAUNCH(1); break;
    case 4: FO_BEV_POOL_LAUNCH(4); break;
    default: return (int)cudaErrorInvalidValue;
  }
#undef FO_BEV_POOL_LAUNCH
  return (int)cudaGetLastError();
}

}  // namespace

// C is 8 (the test presets) or 32 (the reference's feature channels);
// feat_bf16 / out_bf16 pick the dtypes (else fp32);
// long_voxels holds n_long voxel ids, each with a run longer than max_short,
// or -1 (padding of a table of static length, skipped).
extern "C" int bev_pool_fwd(const void* depth, const void* feat,
                            const void* ranks_depth, const void* ranks_feat,
                            const void* bounds, const void* long_voxels,
                            int n_long, void* out, int num_voxels, int C,
                            int max_short, int feat_bf16, int out_bf16,
                            void* stream) {
  if (num_voxels == 0) return (int)cudaSuccess;
  if (C % kCh != 0) return (int)cudaErrorInvalidValue;
  using Launch = int (*)(const void*, const void*, const void*, const void*,
                         const void*, const void*, int, void*, int, int, int,
                         cudaStream_t);
  const Launch run =
      feat_bf16 ? (out_bf16 ? &launch<true, true> : &launch<true, false>)
                : (out_bf16 ? &launch<false, true> : &launch<false, false>);
  return run(depth, feat, ranks_depth, ranks_feat, bounds, long_voxels, n_long,
             out, num_voxels, C, max_short, (cudaStream_t)stream);
}

extern "C" const char* fo_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
