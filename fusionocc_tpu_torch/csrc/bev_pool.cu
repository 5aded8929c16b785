// Frustum-to-voxel pooling forward (bev_pool_v2's design).
//
// Replaces the TPU kernel fusionocc_tpu/ops/pallas/segsum.py::_kernel (a
// blocked inclusive scan of depth*feat whose differences at `bounds` give the
// segment sums).  On Hopper no scan is needed: points are sorted by voxel
// rank and `bounds[v]..bounds[v+1]` is voxel v's run, so one thread per
// (voxel, channel) gathers its run and sums it directly in fp32.
//
//   out[v, c] = sum_{p in [bounds[v], bounds[v+1])}
//                   depth[ranks_depth[p]] * feat[ranks_feat[p], c]
//
// What bounds it: memory.  Each point is read once per channel; a warp holds
// the 32 channels of one voxel (for C == 32), so its rank reads are one
// broadcast and its feat reads one coalesced 128-byte row.  Every voxel is
// written, zero where empty; no atomics, so the result is deterministic.
// Points past bounds[num_voxels] (outside the grid) are never read.
#include <cuda_runtime.h>
#include <cstdint>

__global__ void bev_pool_fwd_kernel(const float* __restrict__ depth,
                                    const float* __restrict__ feat,
                                    const int32_t* __restrict__ ranks_depth,
                                    const int32_t* __restrict__ ranks_feat,
                                    const int32_t* __restrict__ bounds,
                                    float* __restrict__ out,
                                    int num_voxels, int C) {
  const int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= (int64_t)num_voxels * C) return;
  const int v = (int)(t / C);
  const int c = (int)(t % C);
  const int begin = bounds[v];
  const int end = bounds[v + 1];
  float acc = 0.f;
  for (int p = begin; p < end; ++p) {
    acc = fmaf(depth[ranks_depth[p]], feat[(int64_t)ranks_feat[p] * C + c],
               acc);
  }
  out[t] = acc;
}

extern "C" int bev_pool_fwd(const void* depth, const void* feat,
                            const void* ranks_depth, const void* ranks_feat,
                            const void* bounds, void* out, int num_voxels,
                            int C, void* stream) {
  const int64_t total = (int64_t)num_voxels * C;
  if (total == 0) return (int)cudaSuccess;
  const int threads = 256;
  const int64_t blocks = (total + threads - 1) / threads;
  bev_pool_fwd_kernel<<<(unsigned)blocks, threads, 0,
                        (cudaStream_t)stream>>>(
      (const float*)depth, (const float*)feat, (const int32_t*)ranks_depth,
      (const int32_t*)ranks_feat, (const int32_t*)bounds, (float*)out,
      num_voxels, C);
  return (int)cudaGetLastError();
}

extern "C" const char* fo_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
