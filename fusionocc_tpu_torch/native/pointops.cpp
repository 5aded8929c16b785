// Native host-side point-cloud preprocessing (C++, ctypes-bound).
//
// The reference runs its host pipeline in torch dataloader workers with
// numpy/torch ops (z-buffer via argsort, depth_transforms.py:26-60; sweep
// transforms, loading.py:810-837).  These are the per-sample host hot spots
// (~1.5M-point clouds x 6 cameras); the C++ versions are single-pass O(n)
// and OpenMP-parallel where it pays.
//
// Build: fusionocc_tpu_torch/native/__init__.py compiles it at first use
// (g++ -O3 -shared -fPIC -fopenmp) into fusionocc_tpu_torch/_build/.

#include <cstdint>
#include <cmath>
#include <cstring>
#include <limits>

extern "C" {

// Z-buffered sparse depth map: out[v, u] = min depth of points rounding to
// that pixel within [dmin, dmax).  Matches depth_transforms.py:26-60 (numpy
// round = round-half-even; min depth wins).
void zbuffer_depth(const float* uvd, int64_t n, int64_t height, int64_t width,
                   float dmin, float dmax, float* out) {
  const float inf = std::numeric_limits<float>::infinity();
  for (int64_t i = 0; i < height * width; ++i) out[i] = inf;
  for (int64_t i = 0; i < n; ++i) {
    const float u = uvd[3 * i], v = uvd[3 * i + 1], d = uvd[3 * i + 2];
    if (!(d >= dmin && d < dmax)) continue;
    const long ui = std::lrintf(u);  // current rounding mode: half-even
    const long vi = std::lrintf(v);
    if (ui < 0 || ui >= width || vi < 0 || vi >= height) continue;
    float* cell = &out[vi * width + ui];
    if (d < *cell) *cell = d;
  }
  for (int64_t i = 0; i < height * width; ++i)
    if (out[i] == inf) out[i] = 0.0f;
}

// Rigid-transform the xyz prefix of an (n, stride) point array in place of
// `out` (may alias in != out only if caller copies non-xyz columns first).
void transform_points(const float* pts, int64_t n, int64_t stride,
                      const double* T /* 4x4 row-major */, float* out) {
#pragma omp parallel for
  for (int64_t i = 0; i < n; ++i) {
    const float x = pts[i * stride], y = pts[i * stride + 1],
                z = pts[i * stride + 2];
    const double ox = T[0] * x + T[1] * y + T[2] * z + T[3];
    const double oy = T[4] * x + T[5] * y + T[6] * z + T[7];
    const double oz = T[8] * x + T[9] * y + T[10] * z + T[11];
    std::memcpy(&out[i * stride], &pts[i * stride],
                sizeof(float) * stride);
    out[i * stride] = static_cast<float>(ox);
    out[i * stride + 1] = static_cast<float>(oy);
    out[i * stride + 2] = static_cast<float>(oz);
  }
}

// mask[i] = all(lo + eps <= xyz_i <= hi - eps) (loading.py:1087-1139).
void range_filter_mask(const float* pts, int64_t n, int64_t stride,
                       const float* lo, const float* hi, float eps,
                       uint8_t* mask) {
#pragma omp parallel for
  for (int64_t i = 0; i < n; ++i) {
    const float x = pts[i * stride], y = pts[i * stride + 1],
                z = pts[i * stride + 2];
    mask[i] = (x >= lo[0] + eps && x <= hi[0] - eps &&
               y >= lo[1] + eps && y <= hi[1] - eps &&
               z >= lo[2] + eps && z <= hi[2] - eps) ? 1 : 0;
  }
}

// Project points through a 3x4 lidar->cam matrix + 3x3 intrinsic-with-aug
// homography to (u, v, depth) triplets.  Fuses the per-camera projection
// chain of depth_transforms.py:180-196 into one pass.
void project_points(const float* pts, int64_t n, int64_t stride,
                    const double* l2c /* 3x4 */,
                    const double* post /* 3x3 post_rot row-major */,
                    const double* post_t /* 3 */,
                    float* uvd_out) {
#pragma omp parallel for
  for (int64_t i = 0; i < n; ++i) {
    const float x = pts[i * stride], y = pts[i * stride + 1],
                z = pts[i * stride + 2];
    const double cx = l2c[0] * x + l2c[1] * y + l2c[2] * z + l2c[3];
    const double cy = l2c[4] * x + l2c[5] * y + l2c[6] * z + l2c[7];
    const double cz = l2c[8] * x + l2c[9] * y + l2c[10] * z + l2c[11];
    const double zz = cz > 1e-6 ? cz : 1e-6;
    const double u0 = cx / zz, v0 = cy / zz;
    const double u = post[0] * u0 + post[1] * v0 + post[2] * cz + post_t[0];
    const double v = post[3] * u0 + post[4] * v0 + post[5] * cz + post_t[1];
    uvd_out[3 * i] = static_cast<float>(u);
    uvd_out[3 * i + 1] = static_cast<float>(v);
    uvd_out[3 * i + 2] = static_cast<float>(cz);
  }
}

}  // extern "C"
