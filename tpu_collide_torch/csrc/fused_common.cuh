// Pieces shared by the fused kernels (fused_detect.cu, fused_predict.cu):
// the pair-math constants, the sorted record layout, the walk over an
// object's stencil runs and the top-k slot insertion.
#pragma once

#include <cuda_runtime.h>

namespace tc {

constexpr int K_MAX = 32;  // slots of an object, in shared memory
constexpr float KEY_NONE = -3.0f;
constexpr float KEY_SUB = -2.0f;

// f32 constants, in the order of PARAM_NAMES in kernels/fused_detect.py
struct Params {
  float r2, min_rs2, time_window, dt, t_max, conv, safe_base,
      max_warning_time, max_relative_speed, w_dist, w_time, w_speed, w_angle,
      w_type, same_type, diff_type, risk_low, risk_medium, risk_high,
      ttc_critical, ttc_high;
};
constexpr int N_PARAMS = sizeof(Params) / sizeof(float);

struct Shape {
  int n, nx, ny, nz, is3d, k, count_checked, angle_product;
};

// record layout of one sorted object (cell_list.FIELD_NAMES), 4 x float4:
// r0 = (x, y, z, vx)  r1 = (vy, vz, ax, ay)
// r2 = (az, size, heading, otype)  r3 = (sin_h, cos_h, cls, -)

// Calls f(j0, j1) for each candidate run [j0, j1) of the 1-cell stencil
// around cell (cx, cy, cz): with cells sorted by (z, y, x), the cells
// cx-1 .. cx+1 of one (dz, dy) row are one contiguous run of the sorted
// order, so the stencil is 3 runs in 2D and 9 in 3D.
template <typename F>
__device__ __forceinline__ void for_each_run(const int* __restrict__ cell_start,
                                             const Shape& sh, int cx, int cy,
                                             int cz, F&& f) {
  const int x0 = cx > 0 ? cx - 1 : 0;
  const int x1 = cx < sh.nx - 1 ? cx + 1 : sh.nx - 1;
  const int dz0 = sh.is3d ? -1 : 0, dz1 = sh.is3d ? 1 : 0;
  for (int dz = dz0; dz <= dz1; ++dz) {
    const int z = cz + dz;
    if (z < 0 || z >= sh.nz) continue;
    for (int dy = -1; dy <= 1; ++dy) {
      const int y = cy + dy;
      if (y < 0 || y >= sh.ny) continue;
      const int base = (z * sh.ny + y) * sh.nx;
      f(cell_start[base + x0], cell_start[base + x1 + 1]);
    }
  }
}

// Inserts (key, j) into k slots kept ordered by key descending, then
// candidate index ascending; a pair that ranks below the last slot is
// dropped.
__device__ __forceinline__ void insert_slot(float* skey, int* sidx, int k,
                                            float key, int j) {
  const int last = k - 1;
  if (key > skey[last] || (key == skey[last] && j < sidx[last])) {
    int s = last;
    while (s > 0 &&
           (key > skey[s - 1] || (key == skey[s - 1] && j < sidx[s - 1]))) {
      skey[s] = skey[s - 1];
      sidx[s] = sidx[s - 1];
      --s;
    }
    skey[s] = key;
    sidx[s] = j;
  }
}

}  // namespace tc
