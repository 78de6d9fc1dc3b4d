// Pieces shared by the fused kernels (fused_detect.cu, fused_predict.cu,
// precise_sweep.cu): the pair-math constants, the sorted record layout, the
// top-k slot insertion and the squared bound of a distance test.
#pragma once

#include <cfloat>
#include <cmath>

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

// The largest float T with sqrtf(T) <= s, so that (x <= T) == (sqrtf(x) <= s)
// for every x a sum of squares can be (0 .. inf, NaN). sqrtf rounds to
// nearest, so sqrtf(x) <= s exactly when sqrt(x) lies below the midpoint m
// of s and the next float above it (sqrt(x) == m cannot be: m*m has an odd
// significand of 49 bits or more, x has 24). m and m*m are exact in double,
// and T is m*m rounded down. No x passes a negative or NaN s; every x but
// NaN passes s = inf.
__device__ __forceinline__ float sqrt_le_bound(float s) {
  if (!(s >= 0.0f)) return s == s ? -1.0f : s;
  if (s == INFINITY) return s;
  const float a = fabsf(s);
  const float up = __int_as_float(__float_as_int(a) + 1);
  const double m = 0.5 * (static_cast<double>(a) + static_cast<double>(up));
  return fminf(__double2float_rd(m * m), FLT_MAX);
}

}  // namespace tc
