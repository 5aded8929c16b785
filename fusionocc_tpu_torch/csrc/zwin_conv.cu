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
// rows are exact zeros.  weight is the (27, Cin, Cout) cell kernel; the bf16
// body takes it transposed, (27, Cout, Cin) (the wrapper makes that copy).
// The in lanes a tap reads form the band (zi_lo, nzi) of its z shift ds,
// the nonzero rows of the lifted weight (z_bands in ops/zwin_conv.py).
//
// The TPU kernel streamed contiguous windows of rows and picked each tap's
// rows with one-hot matmuls, because Mosaic had no dynamic gather.  Here the
// rows are gathered by index, so no window plan, overflow patch or fallback
// exists: every tap of every row is exact.
//
// Two bodies, chosen by dtype:
//
// bf16 (the main path): a gather-GEMM for Hopper.  On the H100 the small
// layers are bound by the bytes they gather and the wide ones (Cin = Cout =
// 48) by their products; what held the sm_80-style body back was neither:
// every 32-row CTA re-read the tap's cell kernels and waited at two block
// barriers per tap.  So:
// - persistent CTAs, each holding its part of the layer's cell kernel in
//   shared memory for the whole launch, loaded once by TMA (a 3-D tensor
//   map over the transposed weight, box 16 ci x Cout part x 27 cells,
//   32-byte swizzle: wgmma's K-major B layout);
// - m64 blocks of ZB out cells zo and 64 / ZB rows of a tile: for a tap t
//   and a dz a block's cells take part where their zi is valid.  ZB = 1
//   (tiles of 64 rows) unless the whole kernel does not fit beside a ring of
//   3 stages; then ZB = 2 or 4 (tiles of 32 or 16 rows, stages a half or a
//   quarter of the size), which keeps 48 -> 48 and 48 -> 64 whole.  What
//   still would not fit splits Cout into parts of a multiple of 8 across the
//   grid's rows (blockIdx.y; the gathers are repeated per part, from L2);
// - a producer warpgroup: three of its warps read each tile's (row, tap)
//   neighbour table coalesced into one of two tables in shared memory (the
//   next tile's while this one's gathers are issued) with the taps some
//   active row finds; the fourth warp skips the other taps and gathers each
//   found (row, tap)'s band (nzi * Cin bf16, contiguous, up to 1 KB) with
//   one cp.async.bulk into a ring of at least 3 tap stages (rows padded by
//   16 bytes, so ldmatrix is free of bank conflicts), each completed on an
//   mbarrier, with a 16-byte stage header of the tap and the found rows.
//   Consumers wait on the stage's mbarrier and hand it back on another;
//   there is no block-wide barrier per tap.  (Hopper's TMA has no row
//   gather; 16-byte cp.async by the whole warpgroup, each thread's copies
//   completing the stage's mbarrier, measured slower on the H100.)
// - two consumer warpgroups split the blocks; per (dz, k16 step) with a
//   valid (zo, zi) in a warpgroup's blocks, it takes the A fragments of its
//   blocks by ldmatrix from the gathered rows (a lane of a row whose tap
//   was not found, or of a cell without a valid zi, reads a zero row) and
//   runs wgmma m64nNk16 (N = the Cout part) on each with B from the
//   resident kernel: a wgmma under a per-block condition is one that ptxas
//   cannot prove uniform over the warpgroup, and it serializes them, which
//   cost more than the zero products;
// - the fp32 accumulators (up to 4 blocks x N / 2 per thread) stay in
//   registers over all the taps of the tile; the epilogue applies mask_out,
//   casts once and stores while the producer gathers the next tile.
// The NULL_BODY instantiation (entry zwin_conv_null) runs the same loads,
// gathers, waits and stores with the products left out: the cost of the
// data movement alone.
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
#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cstdint>

#include "hopper.cuh"

namespace {

constexpr int ROWS = 32;         // fp32 body: output rows per CTA
constexpr int TILE = 64;         // bf16 body: the M of a product, and the
                                 // output rows of a tile of single-cell blocks
constexpr int CONSUMERS = 2;     // bf16 body: consumer warpgroups
constexpr int THREADS = (CONSUMERS + 1) * 128;  // and a producer warpgroup
constexpr int MAX_FOUT = 8;

constexpr int MAX_NT = 8;        // Cout <= 64, n8 tiles
constexpr int MAX_CIN = 64;      // k16 steps
constexpr int MIN_STAGES = 3, MAX_STAGES = 8;
constexpr int HEADER = 16;       // stage header: tap, last, found rows
// the producer's two tables of a tile: (TILE, 27) feats rows (-1: not
// found) and the found taps of each of its three builder warps
constexpr int TABLE_BYTES = 2 * (TILE * 27 * 4 + 16);
constexpr int BUILDERS = 3;      // producer warps that build the tables
constexpr int SMEM_MAX = 232448; // dynamic shared memory a block may use

struct Bands {
  int zi_lo[3];   // first input lane (in cells) of the band of z shift ds
  int nzi[3];     // band height in cells; 0 = no tap of this ds
};

// operands of the fused eval epilogue; unused by the plain instantiations
struct Epilogue {
  const float* inv;      // (L_out,) BatchNorm scale
  const float* shift;    // (L_out,) BatchNorm shift
  const uint8_t* lane;   // (B*S_out, f_out) cell lane mask
  int f_out;
};

// what the producer tells the consumers about a stage
struct StageHeader {
  int tap;             // -1: a tile no active row of which finds any tap
  int last;            // the tile's last stage
  uint32_t found[2];   // rows 0-31, 32-63 of the tile whose tap was found
};

__host__ __device__ __forceinline__ int round4(int x) { return (x + 3) & ~3; }

__device__ __forceinline__ float affine_relu(float acc, float inv,
                                             float shift) {
  return fmaxf(__fadd_rn(__fmul_rn(acc, inv), shift), 0.f);
}

// ---------------------------------------------------------------- bf16 body

// NT: n8 tiles of the Cout part; ZB: out cells of an m64 block (its rows:
// TILE / ZB output rows of the tile).
template <int NT, int ZB, bool NULL_BODY, bool EPI>
__global__ void __launch_bounds__(THREADS, 1)
    zwin_conv_wgmma_kernel(const __grid_constant__ CUtensorMap tm_w,
                           const __nv_bfloat16* __restrict__ feats,
                           const int32_t* __restrict__ nbr,
                           const uint8_t* __restrict__ mask_out,
                           __nv_bfloat16* __restrict__ out, int S_in,
                           int S_out, int total_rows, int cin, int cout,
                           int f_in, int f_out, int stride, int L_in,
                           int L_out, Bands bands, int stages, int row_pitch,
                           int stage_bytes, int w_bytes, Epilogue epi) {
  constexpr int BOX_BYTES = 27 * NT * 8 * 32;   // one k16 slab of the kernel
  extern __shared__ uint8_t smem_raw[];
  uint8_t* w_s =
      smem_raw + ((1024 - (hw::smem_addr(smem_raw) & 1023)) & 1023);
  uint8_t* ring = w_s + w_bytes;
  uint32_t* zero = reinterpret_cast<uint32_t*>(ring + stages * stage_bytes);
  int* src_s = reinterpret_cast<int*>(zero + 8);       // [2] (TILE, 27)
  uint32_t* taps_s = reinterpret_cast<uint32_t*>(src_s + 2 * TILE * 27);
  uint64_t* full = reinterpret_cast<uint64_t*>(
      reinterpret_cast<uint8_t*>(zero) + 32 + TABLE_BYTES);
  uint64_t* empty = full + stages;
  uint64_t* w_full = empty + stages;
  uint64_t* table_full = w_full + 1;    // [2]
  uint64_t* table_empty = w_full + 3;   // [2]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int co0 = blockIdx.y * NT * 8;          // this CTA's Cout part
  constexpr int rows_t = TILE / ZB;             // output rows of a tile
  constexpr int BPW = MAX_FOUT / CONSUMERS / ZB;  // m64 blocks a warpgroup
  const int tiles = (total_rows + rows_t - 1) / rows_t;
  const int k_steps = cin / 16;

  if (tid == 0) {
    for (int s = 0; s < stages; ++s) {
      hw::mbar_init(&full[s], 1);
      hw::mbar_init(&empty[s], CONSUMERS * 4);   // every consumer warp
    }
    hw::mbar_init(w_full, 1);
    for (int b = 0; b < 2; ++b) {
      hw::mbar_init(&table_full[b], BUILDERS);
      hw::mbar_init(&table_empty[b], 1);
    }
    hw::fence_barrier_init();
  }
  if (tid < 8) zero[tid] = 0u;
  __syncthreads();

  if (warp == CONSUMERS * 4) {
    // ------------------------------------------- producer: the issuing warp
    if (lane == 0) {
      hw::mbar_arrive_expect_tx(w_full, BOX_BYTES * k_steps);
      for (int kb = 0; kb < k_steps; ++kb)
        hw::tma_load_3d(w_s + kb * BOX_BYTES, &tm_w, w_full, kb * 16, co0, 0);
    }
    int it = 0, k = 0;
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x, ++k) {
      const int b = k & 1;
      hw::mbar_wait(&table_full[b], (k >> 1) & 1);
      const int* src_t = src_s + b * TILE * 27;
      uint32_t taps = taps_s[4 * b] | taps_s[4 * b + 1] | taps_s[4 * b + 2];
      do {
        const int t = taps ? __ffs(taps) - 1 : -1;
        taps &= taps - 1;
        const int s = it % stages;
        if (it >= stages) hw::mbar_wait(&empty[s], (it / stages - 1) & 1);
        uint8_t* st = ring + s * stage_bytes;
        const int src0 = t >= 0 && lane < rows_t ? src_t[lane * 27 + t] : -1;
        const int src1 =
            t >= 0 && lane + 32 < rows_t ? src_t[(lane + 32) * 27 + t] : -1;
        const uint32_t m0 = __ballot_sync(0xffffffffu, src0 >= 0);
        const uint32_t m1 = __ballot_sync(0xffffffffu, src1 >= 0);
        const int ds = t >= 0 ? t % 3 : 0;
        const uint32_t band = bands.nzi[ds] * cin * 2;
        if (lane == 0) {
          StageHeader* hd = reinterpret_cast<StageHeader*>(st);
          hd->tap = t;
          hd->last = taps == 0;
          hd->found[0] = m0;
          hd->found[1] = m1;
          hw::mbar_arrive_expect_tx(&full[s],
                                    (__popc(m0) + __popc(m1)) * band);
        }
        __syncwarp();
        const __nv_bfloat16* lo = feats + bands.zi_lo[ds] * cin;
        uint8_t* rows = st + HEADER;
        if (src0 >= 0)
          hw::bulk_load(rows + lane * row_pitch, lo + (int64_t)src0 * L_in,
                        band, &full[s]);
        if (src1 >= 0)
          hw::bulk_load(rows + (lane + 32) * row_pitch,
                        lo + (int64_t)src1 * L_in, band, &full[s]);
        ++it;
      } while (taps);
      __syncwarp();
      if (lane == 0) hw::mbar_arrive(&table_empty[b]);   // the table is free
    }
    return;
  }
  if (warp > CONSUMERS * 4) {
    // ---------------------- producer: the warps that build the row tables
    const int bw = warp - CONSUMERS * 4 - 1;        // 0..BUILDERS - 1
    const int q = bw * 32 + lane;
    int k = 0;
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x, ++k) {
      const int b = k & 1;
      if (k >= 2) hw::mbar_wait(&table_empty[b], ((k >> 1) - 1) & 1);
      const int row0 = tile * rows_t;
      int* src_t = src_s + b * TILE * 27;
      uint32_t mine = 0;
      for (int idx = q; idx < rows_t * 27; idx += BUILDERS * 32) {
        const int r = row0 + idx / 27, t = idx % 27;
        int src = -1;
        if (r < total_rows && bands.nzi[t % 3] > 0 && mask_out[r]) {
          const int n = __ldg(nbr + (int64_t)row0 * 27 + idx);
          if (n < S_in) {
            src = (r / S_out) * S_in + n;
            mine |= 1u << t;
          }
        }
        src_t[idx] = src;
      }
      mine = __reduce_or_sync(0xffffffffu, mine);
      if (lane == 0) {
        taps_s[4 * b + bw] = mine;
        hw::mbar_arrive(&table_full[b]);
      }
    }
    return;
  }

  // -------------------------------------------------------------- consumers
  // m64 block j holds out cells j*ZB .. j*ZB + ZB - 1, rows_t rows each;
  // warpgroup wg takes blocks wg*bpw .. wg*bpw + bpw - 1
  const int wg = warp >> 2, wq = warp & 3;
  const int g = lane >> 2, qd = lane & 3;
  const int nblk = (f_out + ZB - 1) / ZB;
  const int bpw = (nblk + 1) / 2;
  const int am = wq * 16 + (lane & 15);         // this lane's ldmatrix row
  const int arow = am % rows_t, asub = am / rows_t;
  const uint32_t w_addr = hw::smem_addr(w_s);
  const uint32_t zero_a = hw::smem_addr(zero) + (lane >> 4) * 16;
  hw::mbar_wait(w_full, 0);
  int it = 0;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    float acc[BPW][NT * 4];
#pragma unroll
    for (int z = 0; z < BPW; ++z)
#pragma unroll
      for (int e = 0; e < NT * 4; ++e) acc[z][e] = 0.f;
    int last;
    do {
      const int s = it % stages;
      hw::mbar_wait(&full[s], (it / stages) & 1);
      const uint8_t* st = ring + s * stage_bytes;
      const StageHeader hd = *reinterpret_cast<const StageHeader*>(st);
      last = hd.last;
      if (!NULL_BODY && hd.tap >= 0) {
        const int t = hd.tap, ds = t % 3;
        const bool found = (hd.found[arow >> 5] >> (arow & 31)) & 1;
        const uint32_t a_row = hw::smem_addr(st + HEADER + arow * row_pitch) +
                               (lane >> 4) * 16 - bands.zi_lo[ds] * cin * 2;
        const int zoff = 1 + (ds - 1) * f_in;   // zi = stride*zo + dz - zoff
        for (int dz = 0; dz < 3; ++dz) {
          // the in cell of this lane's out cell in each of this warpgroup's
          // blocks (-1: none); whether some block has a valid (zo, zi)
          int zi[BPW];
          bool any = false;
#pragma unroll
          for (int z = 0; z < BPW; ++z) {
            const int j = wg * bpw + z;
#pragma unroll
            for (int u = 0; u < ZB; ++u) {
              const int zo = j * ZB + u, zu = stride * zo + dz - zoff;
              any |= z < bpw && j < nblk && zo < f_out && zu >= 0 &&
                     zu < f_in;
            }
            const int zo = j * ZB + asub;
            zi[z] = stride * zo + dz - zoff;
            if (zo >= f_out || zi[z] < 0 || zi[z] >= f_in) zi[z] = -1;
          }
          if (!any) continue;
          // every block's product, the invalid cells reading zeros: a
          // product under a condition ptxas cannot prove uniform over the
          // warpgroup is serialized (C7520), which cost more than the zeros
          for (int kk = 0; kk < k_steps; ++kk) {
            uint32_t a[BPW][4];
#pragma unroll
            for (int z = 0; z < BPW; ++z)
              hw::ldmatrix_x4(a[z], found && zi[z] >= 0
                                          ? a_row + zi[z] * cin * 2 + kk * 32
                                          : zero_a);
            const uint64_t db = hw::make_desc(
                w_addr + kk * BOX_BYTES + (t - ds + dz) * NT * 8 * 32, 16, 256,
                hw::SWIZZLE_32B);
            hw::wgmma_fence();
#pragma unroll
            for (int z = 0; z < BPW; ++z)
              hw::wgmma_rs<NT, 0>(acc[z], a[z], db, 1);
            hw::wgmma_commit();
            hw::wgmma_wait<0>();
          }
        }
      }
      __syncwarp();
      if (lane == 0) hw::mbar_arrive(&empty[s]);   // the stage may refill
      ++it;
    } while (!last);

#pragma unroll
    for (int z = 0; z < BPW; ++z) {
      const int j = wg * bpw + z;
      if (z >= bpw || j >= nblk) continue;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int m = wq * 16 + half * 8 + g;     // this thread's M row
        const int zo = j * ZB + m / rows_t;
        const int r = tile * rows_t + m % rows_t;
        if (zo >= f_out || r >= total_rows) continue;
        const bool keep =
            mask_out[r] != 0 &&
            (!EPI || epi.lane[(int64_t)r * epi.f_out + zo] != 0);
        __nv_bfloat16* orow = out + (int64_t)r * L_out + zo * cout + co0;
#pragma unroll
        for (int j8 = 0; j8 < NT; ++j8) {
          float v0 = keep ? acc[z][4 * j8 + 2 * half] : 0.f;
          float v1 = keep ? acc[z][4 * j8 + 2 * half + 1] : 0.f;
          if (EPI && keep) {
            const int c = zo * cout + co0 + j8 * 8 + 2 * qd;
            v0 = affine_relu(v0, __ldg(epi.inv + c), __ldg(epi.shift + c));
            v1 = affine_relu(v1, __ldg(epi.inv + c + 1),
                             __ldg(epi.shift + c + 1));
          }
          *reinterpret_cast<uint32_t*>(orow + j8 * 8 + 2 * qd) =
              hw::pack_bf16(v0, v1);
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


template <int NT, bool NULL_BODY, bool EPI>
int launch_bf16_nt(const CUtensorMap& tm_w, const void* feats,
                   const void* nbr, const void* mask_out, void* out,
                   int S_in, int S_out, int total_rows, int cin, int cout,
                   int f_in, int f_out, int stride, int L_in, int L_out,
                   const Bands& bands, int zb, int nsplit, int stages,
                   int row_pitch, int stage_bytes, int w_bytes,
                   const Epilogue& epi, cudaStream_t stream) {
  auto kernel = zb == 1   ? zwin_conv_wgmma_kernel<NT, 1, NULL_BODY, EPI>
                : zb == 2 ? zwin_conv_wgmma_kernel<NT, 2, NULL_BODY, EPI>
                          : zwin_conv_wgmma_kernel<NT, 4, NULL_BODY, EPI>;
  const size_t smem = 1024 + (size_t)w_bytes + (size_t)stages * stage_bytes +
                      32 + TABLE_BYTES + (2 * stages + 5) * 8;
  int sms = 0, per_sm = 0;
  const cudaError_t err = hw::resident_ctas(
      reinterpret_cast<const void*>(kernel), THREADS, smem, &sms, &per_sm);
  if (err != cudaSuccess) return (int)err;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  // persistent: the resident CTAs of each Cout part share its row tiles
  const int tiles = (total_rows + TILE / zb - 1) / (TILE / zb);
  const int ctas = sms * per_sm / nsplit;
  const dim3 grid(ctas < 1 ? 1 : (ctas < tiles ? ctas : tiles), nsplit);
  kernel<<<grid, THREADS, smem, stream>>>(
      tm_w, (const __nv_bfloat16*)feats, (const int32_t*)nbr,
      (const uint8_t*)mask_out, (__nv_bfloat16*)out, S_in, S_out,
      total_rows, cin, cout, f_in, f_out, stride, L_in, L_out, bands, stages,
      row_pitch, stage_bytes, w_bytes, epi);
  return (int)cudaGetLastError();
}

// The bf16 body's launch plan.
struct Plan {
  int zb, nsplit, stages, w_bytes, stage_bytes, row_pitch;
};

// The plan for Cin, Cout and the widest band of nzi_max in cells: per block
// size zb (m64 blocks of zb out cells and 64 / zb rows of a tile: the stage
// shrinks with the tile), the fewest Cout parts whose resident kernel fits
// beside MIN_STAGES stages, then as many stages as fit; the smallest zb of
// the fewest parts.  False when none fits.
bool pick_plan(int cin, int cout, int nzi_max, Plan* plan) {
  // a gathered row padded by 16 bytes: an odd number of 16-byte chunks, so
  // the 8 rows of an ldmatrix phase hit different banks
  const int row_pitch = (nzi_max > 0 ? nzi_max : 1) * cin * 2 + 16;
  const int nt_all = cout / 8;
  Plan p{0, 0, 0, 0, 0, row_pitch};
  for (int b = 1; b <= 4; b *= 2) {
    const int sb = (HEADER + TILE / b * row_pitch + 15) & ~15;
    for (int ns = 1; ns <= nt_all && (p.nsplit == 0 || ns < p.nsplit); ++ns) {
      if (nt_all % ns) continue;
      const int wb = (27 * cin * (cout / ns) * 2 + 1023) & ~1023;
      const long long room = (long long)SMEM_MAX - 1024 - wb - 32 -
                             TABLE_BYTES - (2 * MAX_STAGES + 5) * 8;
      const long long fit = room / sb;
      if (fit >= MIN_STAGES) {
        p.zb = b;
        p.nsplit = ns;
        p.w_bytes = wb;
        p.stage_bytes = sb;
        p.stages = fit < MAX_STAGES ? (int)fit : MAX_STAGES;
        break;
      }
    }
  }
  *plan = p;
  return p.nsplit > 0;
}

// weight_t: the (27, Cout, Cin) transposed cell kernel.
template <bool NULL_BODY, bool EPI>
int launch_bf16(const void* feats, const void* nbr, const void* mask_out,
                const void* weight_t, void* out, int S_in, int S_out,
                int total_rows, int cin, int cout, int f_in, int f_out,
                int stride, int L_in, int L_out, const Bands& bands,
                const Epilogue& epi, cudaStream_t stream) {
  // k16 steps over Cin, n8 tiles over Cout, at most two warpgroups of four
  // out cells; 16-byte aligned bands for the bulk copies
  const bool aligned = (uintptr_t)feats % 16 == 0 && (uintptr_t)out % 4 == 0;
  if (cin % 16 != 0 || cin > MAX_CIN || cout % 8 != 0 ||
      cout > MAX_NT * 8 || f_out > MAX_FOUT || !aligned)
    return (int)cudaErrorInvalidValue;
  int nzi_max = 0;
  for (int ds = 0; ds < 3; ++ds)
    nzi_max = bands.nzi[ds] > nzi_max ? bands.nzi[ds] : nzi_max;
  Plan plan;
  if (!pick_plan(cin, cout, nzi_max, &plan)) return (int)cudaErrorInvalidValue;
  const int nt = cout / 8 / plan.nsplit;
  CUtensorMap tm_w;
  const uint64_t dims[3] = {(uint64_t)cin, (uint64_t)cout, 27};
  const uint64_t strides[2] = {(uint64_t)cin * 2, (uint64_t)cout * cin * 2};
  const uint32_t box[3] = {16, (uint32_t)nt * 8, 27};
  if (!hw::encode_bf16_3d(&tm_w, weight_t, dims, strides, box,
                          CU_TENSOR_MAP_SWIZZLE_32B))
    return (int)cudaErrorInvalidValue;
#define ZWIN_LAUNCH(N)                                                       \
  case N:                                                                    \
    return launch_bf16_nt<N, NULL_BODY, EPI>(                                \
        tm_w, feats, nbr, mask_out, out, S_in, S_out, total_rows, cin, cout, \
        f_in, f_out, stride, L_in, L_out, bands, plan.zb, plan.nsplit,       \
        plan.stages, plan.row_pitch, plan.stage_bytes, plan.w_bytes, epi,    \
        stream);
  switch (nt) {
    ZWIN_LAUNCH(1)
    ZWIN_LAUNCH(2)
    ZWIN_LAUNCH(3)
    ZWIN_LAUNCH(4)
    ZWIN_LAUNCH(5)
    ZWIN_LAUNCH(6)
    ZWIN_LAUNCH(7)
    ZWIN_LAUNCH(8)
  }
#undef ZWIN_LAUNCH
  return (int)cudaErrorInvalidValue;
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

// weight: the cell kernel, (27, Cin, Cout) for dtype 0 (fp32), transposed
// to (27, Cout, Cin) for dtype 1 (bf16).
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

// The bf16 body's launch plan for Cin, Cout and the widest band (nzi_max
// in cells) as launch_bf16 picks it: plan = (zb, Cout parts, stages).  For
// checking ops/zwin_conv.bf16_plan, which the CPU tests read, against it.
extern "C" int zwin_conv_plan(int cin, int cout, int nzi_max, int* plan) {
  Plan p;
  if (!pick_plan(cin, cout, nzi_max, &p)) return (int)cudaErrorInvalidValue;
  plan[0] = p.zb;
  plan[1] = p.nsplit;
  plan[2] = p.stages;
  return (int)cudaSuccess;
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
