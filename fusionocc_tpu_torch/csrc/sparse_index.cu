// Index builds of one sparse encoder stage: the stride-2 output set, the
// cell -> row table and the neighbour maps with the strided lane mask.
//
// Replaces no TPU kernel: the JAX package builds these indexes with XLA ops
// (fusionocc_tpu/ops/sparse_conv.py stage_indices_table and
// _downsample_out_set_table_one, fusionocc_tpu/ops/zfold.py
// strided_lane_mask), and the port first wrote them as batched aten ops
// (ops/sparse_conv.py, the ``*_plain`` functions).  Those were about 90 small
// launches a stage, each a few microseconds of device work behind 15-30 us
// of host time, so the host set the encoder's pace.  Here a stage is six
// launches (ops/sparse_conv.py drives them):
//
//   index_mark    each valid input super row marks its up to 8 stride-2
//                 output cells in a zeroed per-sample occupancy grid (bytes,
//                 rows padded to whole tiles)
//   index_count   per tile of kTile cells the count of set cells; the last
//                 tile of a sample to finish (a fence and a counter) scans
//                 the sample's tile counts into exclusive offsets and writes
//                 n = min(total, capacity)
//   index_prefix  per tile, each cell's inclusive count (the plain build's
//                 cumsum), written once, coalesced through shared memory
//   -- the host reads max(n), the padded width S (the stage's one wait) --
//   index_set     each set cell of rank r < n writes output row r: key,
//                 coords and mask; rows n..S-1 get the sentinel key, zero
//                 coords and mask 0 (the plain build's searchsorted and
//                 key_set)
//   index_table   each valid input row v writes v at column key + 1 of its
//                 sample's row table, which a fill left at V (the miss)
//   index_maps    one thread per output row: the 27 taps of the SubM map
//                 (input rows, stride 1) or of the stride-2 map (output
//                 rows), misses pointing at row V; for a stride-2 row also
//                 the OR of the found input rows' lane bits per super
//                 z-shift, mapped onto the f_out output cells (the plain
//                 build's 0/1 gather-GEMM)
//
// Every output is an integer or a flag and equals the plain build's bit for
// bit: the occupancy and the counts are exact, each output row and each map
// entry is written by exactly one thread, and no atomics decide a value.
//
// What bounds it: bytes, and small ones.  At stage 0 of the full-size
// encoder the grid is 5.12 M cells (5 MB read twice, 20 MB of counts
// written and read once), the table 41 M int32 (164 MB filled, by the
// wrapper's fill) and the two maps 86,016 x 27 int32 each: together about
// 0.07 ms at 3.35 TB/s.  Table reads are gathers, three consecutive cells
// per (dx, dy) tap.  Map rows are staged in shared memory and stored
// coalesced.
#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = kThreads * 16;   // occupancy cells per tile: 16 a thread
constexpr int kRows = 128;             // map rows per block of index_maps

__device__ __forceinline__ int warp_incl_scan(int v) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int u = __shfl_up_sync(0xffffffffu, v, d);
    if (lane >= d) v += u;
  }
  return v;
}

// Exclusive prefix of one value per thread over a block of kThreads; the
// block's sum in *total.  Every thread of the block must call it.
__device__ int block_excl_scan(int v, int* total) {
  __shared__ int warp_sum[kThreads / 32];
  __shared__ int block_sum;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int incl = warp_incl_scan(v);
  if (lane == 31) warp_sum[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    const int w = lane < kThreads / 32 ? warp_sum[lane] : 0;
    const int wi = warp_incl_scan(w);
    if (lane < kThreads / 32) warp_sum[lane] = wi - w;
    if (lane == 31) block_sum = wi;
  }
  __syncthreads();
  const int out = warp_sum[warp] + incl - v;
  *total = block_sum;
  __syncthreads();     // warp_sum and block_sum may be written again
  return out;
}

__device__ __forceinline__ int popc16(const uint4 v) {
  // bytes are 0 or 1, so the set bits count the set cells
  return __popc(v.x) + __popc(v.y) + __popc(v.z) + __popc(v.w);
}

__global__ void mark_kernel(const int* __restrict__ coords,
                            const uint8_t* __restrict__ mask,
                            uint8_t* __restrict__ occ, long long n_rows,
                            int V, int sx, int sy, int sz, long long n_pad) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       i < n_rows; i += (long long)gridDim.x * blockDim.x) {
    if (!mask[i]) continue;
    // input coordinate d reaches outputs floor(d / 2) and floor((d + 1) / 2)
    int lo[3], hi[3];
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      const int d = coords[3 * i + a];
      lo[a] = d >> 1;
      hi[a] = (d + 1) >> 1;
    }
    uint8_t* row = occ + (i / V) * n_pad;
    for (int cx = 0; cx < 2; ++cx) {
      const int x = cx ? hi[0] : lo[0];
      if (x < 0 || x >= sx) continue;
      for (int cy = 0; cy < 2; ++cy) {
        const int y = cy ? hi[1] : lo[1];
        if (y < 0 || y >= sy) continue;
        for (int cz = 0; cz < 2; ++cz) {
          const int z = cz ? hi[2] : lo[2];
          if (z < 0 || z >= sz) continue;
          row[((long long)x * sy + y) * sz + z] = 1;
        }
      }
    }
  }
}

__global__ void count_kernel(const uint8_t* __restrict__ occ,
                             int* __restrict__ tile_off, int* __restrict__ n,
                             unsigned* __restrict__ done, int T,
                             long long n_pad, int capacity) {
  const int b = blockIdx.y, t = blockIdx.x;
  const uint4 v = reinterpret_cast<const uint4*>(
      occ + b * n_pad + (long long)t * kTile)[threadIdx.x];
  int total;
  block_excl_scan(popc16(v), &total);
  __shared__ bool last;
  int* offs = tile_off + (long long)b * T;
  if (threadIdx.x == 0) {
    offs[t] = total;
    __threadfence();
    last = atomicAdd(done + b, 1u) == (unsigned)(T - 1);
  }
  __syncthreads();
  if (!last) return;
  // the sample's last tile: every other tile's count is visible (each
  // fenced before its increment); read them from L2
  int carry = 0;
  for (int base = 0; base < T; base += kThreads) {
    const int i = base + threadIdx.x;
    const int c = i < T ? __ldcg(offs + i) : 0;
    int sum;
    const int ex = block_excl_scan(c, &sum);
    if (i < T) offs[i] = carry + ex;
    carry += sum;
  }
  if (threadIdx.x == 0) n[b] = min(carry, capacity);
}

__global__ void prefix_kernel(const uint8_t* __restrict__ occ,
                              const int* __restrict__ tile_off,
                              int* __restrict__ count, int T, int n_out,
                              long long n_pad) {
  // a thread's 16 counts at stride 17: no bank conflicts either way
  __shared__ int out[kThreads * 17];
  const int b = blockIdx.y, t = blockIdx.x;
  const uint4 v = reinterpret_cast<const uint4*>(
      occ + b * n_pad + (long long)t * kTile)[threadIdx.x];
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
  int total;
  int run = tile_off[(long long)b * T + t] + block_excl_scan(popc16(v),
                                                             &total);
#pragma unroll
  for (int k = 0; k < 16; ++k) {
    run += (w[k >> 2] >> (8 * (k & 3))) & 1;   // little-endian byte k
    out[threadIdx.x * 17 + k] = run;
  }
  __syncthreads();
  const long long base = (long long)t * kTile;
  int* row = count + (long long)b * n_out;
  for (int j = threadIdx.x; j < kTile && base + j < n_out; j += kThreads)
    row[base + j] = out[(j >> 4) * 17 + (j & 15)];
}

__device__ __forceinline__ void write_row(int* keys, int* coords,
                                          uint8_t* mask, long long o, int key,
                                          int sy, int sz, bool valid) {
  keys[o] = key;
  int x = 0, y = 0, z = 0;
  if (valid) {
    x = key / (sy * sz);
    const int rem = key - x * (sy * sz);
    y = rem / sz;
    z = rem - y * sz;
  }
  coords[3 * o] = x;
  coords[3 * o + 1] = y;
  coords[3 * o + 2] = z;
  mask[o] = valid;
}

__global__ void set_kernel(const int* __restrict__ count,
                           const int* __restrict__ n, int* __restrict__ keys,
                           int* __restrict__ coords,
                           uint8_t* __restrict__ mask,
                           int n_out, int S, int sy, int sz) {
  const int b = blockIdx.y;
  const int nb = n[b];
  const int* row = count + (long long)b * n_out;
  const int m = max(n_out, S);
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < m;
       i += gridDim.x * blockDim.x) {
    if (i < n_out) {
      // the count steps up by one at each set cell: rank c - 1
      const int c = row[i];
      const int prev = i ? row[i - 1] : 0;
      if (c > prev && c <= nb && c <= S)
        write_row(keys, coords, mask, (long long)b * S + c - 1, i, sy, sz,
                  true);
    }
    if (i < S && i >= nb)
      write_row(keys, coords, mask, (long long)b * S + i, n_out, sy, sz,
                false);
  }
}

__global__ void table_kernel(const int* __restrict__ keys,
                             const uint8_t* __restrict__ mask,
                             int* __restrict__ table, long long n_rows, int V,
                             long long row_len) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       i < n_rows; i += (long long)gridDim.x * blockDim.x) {
    if (!mask[i]) continue;
    const long long g = i / V;
    table[g * row_len + keys[i] + 1] = (int)(i - g * V);
  }
}

__global__ void __launch_bounds__(kRows) maps_kernel(
    const int* __restrict__ table, long long row_len,
    const int* __restrict__ in_coords, const uint8_t* __restrict__ in_mask,
    const int* __restrict__ out_coords, const uint8_t* __restrict__ out_mask,
    const uint8_t* __restrict__ lane_in, int* __restrict__ subm,
    int* __restrict__ snbr, uint8_t* __restrict__ lane_out, int G, int V,
    int S, int sx, int sy, int sz, int f_in, int f_out, int subm_blocks) {
  __shared__ int stage[kRows * 27];
  const bool strided = blockIdx.x >= subm_blocks;
  const long long r0 =
      (long long)(strided ? blockIdx.x - subm_blocks : blockIdx.x) * kRows;
  const int per = strided ? S : V;
  const long long rows = (long long)G * per;
  const int st = strided ? 2 : 1;
  const int* coords = strided ? out_coords : in_coords;
  const uint8_t* mask = strided ? out_mask : in_mask;
  const long long r = r0 + threadIdx.x;
  if (r < rows) {
    const long long g = r / per;
    const int* tab = table + g * row_len;
    const bool m = mask[r];
    const int ox = coords[3 * r] * st, oy = coords[3 * r + 1] * st,
              oz = coords[3 * r + 2] * st;
    const bool lanes = strided && f_out > 0;
    unsigned bits[3] = {0u, 0u, 0u};   // input lane bits per super z-shift
    int* mine = stage + threadIdx.x * 27;
    for (int dx = 0; dx < 3; ++dx) {
      const int qx = ox + dx - 1;
      for (int dy = 0; dy < 3; ++dy) {
        const int qy = oy + dy - 1;
        const bool ok_xy = m && qx >= 0 && qx < sx && qy >= 0 && qy < sy;
        // column c holds cell c - 1
        const long long col = ((long long)qx * sy + qy) * sz + 1;
#pragma unroll
        for (int dz = 0; dz < 3; ++dz) {
          const int zt = oz + dz - 1;
          const int val = ok_xy && zt >= 0 && zt < sz ? tab[col + zt] : V;
          mine[dx * 9 + dy * 3 + dz] = val;
          if (lanes && val < V) {
            const uint8_t* p = lane_in + (g * V + val) * f_in;
            for (int zi = 0; zi < f_in; ++zi)
              bits[dz] |= (unsigned)(p[zi] != 0) << zi;
          }
        }
      }
    }
    if (lanes) {
      // out cell zo reads in cells r = 2 zo + dz - 1 of its 3x3x3 field, at
      // super shift floor(r / f_in) + 1, lane r mod f_in
      uint8_t* lo = lane_out + r * f_out;
      for (int zo = 0; zo < f_out; ++zo) {
        bool on = false;
        for (int dz = 0; dz < 3; ++dz) {
          const int rr = 2 * zo + dz - 1;
          const int ds = rr < 0 ? 0 : rr / f_in + 1;
          const int zi = rr < 0 ? f_in - 1 : rr % f_in;
          on |= (bits[ds] >> zi) & 1u;
        }
        lo[zo] = on;
      }
    }
  }
  __syncthreads();
  const long long n = (rows - r0 < kRows ? rows - r0 : kRows) * 27;
  int* dst = (strided ? snbr : subm) + r0 * 27;
  for (int j = threadIdx.x; j < n; j += kRows) dst[j] = stage[j];
}

int grid_for(long long items, int threads) {
  const long long blocks = (items + threads - 1) / threads;
  return (int)(blocks < (1 << 20) ? blocks : (1 << 20));
}

}  // namespace

extern "C" int index_mark(const void* coords, const void* mask, void* occ,
                          int B, int V, int sx, int sy, int sz,
                          long long n_pad, void* stream) {
  const long long n_rows = (long long)B * V;
  if (n_rows > 0)
    mark_kernel<<<grid_for(n_rows, kThreads), kThreads, 0,
                  (cudaStream_t)stream>>>(
        (const int*)coords, (const uint8_t*)mask, (uint8_t*)occ, n_rows, V,
        sx, sy, sz, n_pad);
  return (int)cudaGetLastError();
}

extern "C" int index_count(const void* occ, void* tile_off, void* n,
                           void* done, int B, int T, long long n_pad,
                           int capacity, void* stream) {
  if (B > 0 && T > 0)
    count_kernel<<<dim3(T, B), kThreads, 0, (cudaStream_t)stream>>>(
        (const uint8_t*)occ, (int*)tile_off, (int*)n, (unsigned*)done, T,
        n_pad, capacity);
  return (int)cudaGetLastError();
}

extern "C" int index_prefix(const void* occ, const void* tile_off,
                            void* count, int B, int T, int n_out,
                            long long n_pad, void* stream) {
  if (B > 0 && T > 0)
    prefix_kernel<<<dim3(T, B), kThreads, 0, (cudaStream_t)stream>>>(
        (const uint8_t*)occ, (const int*)tile_off, (int*)count, T, n_out,
        n_pad);
  return (int)cudaGetLastError();
}

extern "C" int index_set(const void* count, const void* n, void* keys,
                         void* coords, void* mask, int B, int n_out, int S,
                         int sy, int sz, void* stream) {
  const int m = n_out > S ? n_out : S;
  if (B > 0 && m > 0)
    set_kernel<<<dim3(grid_for(m, kThreads), B), kThreads, 0,
                 (cudaStream_t)stream>>>(
        (const int*)count, (const int*)n, (int*)keys, (int*)coords,
        (uint8_t*)mask, n_out, S, sy, sz);
  return (int)cudaGetLastError();
}

extern "C" int index_table(const void* keys, const void* mask, void* table,
                           int G, int V, long long row_len, void* stream) {
  const long long n_rows = (long long)G * V;
  if (n_rows > 0)
    table_kernel<<<grid_for(n_rows, kThreads), kThreads, 0,
                   (cudaStream_t)stream>>>(
        (const int*)keys, (const uint8_t*)mask, (int*)table, n_rows, V,
        row_len);
  return (int)cudaGetLastError();
}

extern "C" int index_maps(const void* table, const void* in_coords,
                          const void* in_mask, const void* out_coords,
                          const void* out_mask, const void* lane_in,
                          void* subm, void* snbr, void* lane_out, int G,
                          int V, int S, int sx, int sy, int sz,
                          long long row_len, int f_in, int f_out,
                          void* stream) {
  const long long subm_blocks = ((long long)G * V + kRows - 1) / kRows;
  const long long blocks =
      subm_blocks + ((long long)G * S + kRows - 1) / kRows;
  if (blocks > 0)
    maps_kernel<<<(unsigned)blocks, kRows, 0, (cudaStream_t)stream>>>(
        (const int*)table, row_len, (const int*)in_coords,
        (const uint8_t*)in_mask, (const int*)out_coords,
        (const uint8_t*)out_mask, (const uint8_t*)lane_in, (int*)subm,
        (int*)snbr, (uint8_t*)lane_out, G, V, S, sx, sy, sz, f_in, f_out,
        (int)subm_blocks);
  return (int)cudaGetLastError();
}
