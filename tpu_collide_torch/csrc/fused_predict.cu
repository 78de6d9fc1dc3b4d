// Trajectory prediction for Hopper (sm_90a): each object's top-k predicted
// pair slots at every prediction offset, in one launch.
//
// Replaces the predict mode of the TPU kernel
// tpu_collide/kernels/fused_detect.py::_kernel (the emit == "predict" branch,
// fused_detect.py:553-646), which refine.fused_predict_rows launched once per
// offset under a lax.scan. What it computes, per offset t and own object:
//   * the own object moves to its class-predicted position (stationary:
//     p; constant velocity: p + v t; accelerating: p + v t + 0.5 a t t);
//   * its candidates are the objects of the 1-cell stencil around the
//     PREDICTED position's cell, tested at their CURRENT positions
//     (|p_c - pred| <= search_radius, the reference's quirk of querying
//     today's index with tomorrow's position);
//   * each candidate advances to t under constant acceleration, and a
//     sub_steps sampled sweep finds the first sample within the safe
//     distance; a hit scores the stage-4 risk, which is the slot key.
// Slots are ordered by (key descending, candidate sorted index ascending),
// an empty slot is (KEY_NONE, -1); emitted counts every hit exactly.
//
// Design: a 2D grid, blockIdx.y = offset, one thread per (offset, own row),
// so a whole predict call is one launch. Each thread walks the exact 3 (2D)
// or 9 (3D) runs around its predicted cell; unlike the TPU kernel it needs
// no window widened by the fleet's displacement, so nothing overflows.
// What bounds it on the card: the sweep (sub_steps square roots per pair
// within the radius) and thread imbalance in dense cells; candidate loads
// come mostly from L2 (threads of a warp are neighbours in one cell and
// their predicted cells mostly coincide).
//
// Arithmetic follows the reference's expressions (detect/predict.py,
// detect/pipeline.py _dist_at_time / _risk_score) in their order, and the
// plain PyTorch version predict_topk_plain in kernels/fused_detect.py; built
// with -fmad=false and without fast math, the two agree bit for bit.

#include "fused_common.cuh"

namespace {

using tc::K_MAX;
using tc::KEY_NONE;
using tc::Params;
using tc::Shape;

// f32 constants of the predict mode, in the order of PRED_PARAM_NAMES in
// kernels/fused_detect.py
struct PredParams {
  float lo_x, lo_y, lo_z, cell_size, radius;
};
constexpr int N_PRED_PARAMS = sizeof(PredParams) / sizeof(float);

__device__ __forceinline__ int clip_cell(float f, int n) {
  return static_cast<int>(fminf(fmaxf(f, 0.0f), static_cast<float>(n - 1)));
}

__global__ void __launch_bounds__(128)
fused_predict_kernel(const float4* __restrict__ rec,
                     const int* __restrict__ cell_start,
                     const float* __restrict__ offsets, Shape sh, Params p,
                     PredParams q, int sub_steps, float* __restrict__ keys,
                     int* __restrict__ idx, int* __restrict__ emitted_out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= sh.n) return;
  const long long row = static_cast<long long>(blockIdx.y) * sh.n + i;
  const float t = offsets[blockIdx.y];

  float skey[K_MAX];
  int sidx[K_MAX];
  for (int s = 0; s < sh.k; ++s) {
    skey[s] = KEY_NONE;
    sidx[s] = -1;
  }
  int n_emit = 0;
  // dead objects sort last: rows from cell_start[num_cells] on are dead
  if (i < cell_start[sh.nx * sh.ny * sh.nz]) {
    const float4 o0 = rec[4 * i], o1 = rec[4 * i + 1], o2 = rec[4 * i + 2],
                 o3 = rec[4 * i + 3];
    const float ox = o0.x, oy = o0.y, oz = o0.z;
    const float ovx = o0.w, ovy = o1.x, ovz = o1.y;
    const float oax = o1.z, oay = o1.w, oaz = o2.x;
    const float osize = o2.y, ohead = o2.z, otype = o2.w;
    const float osin = o3.x, ocos = o3.y, ocls = o3.z;

    // class-predicted own position (detect/predict.class_advance)
    float px = ox, py = oy, pz = oz;
    if (ocls != 0.0f) {
      px = ox + ovx * t;
      py = oy + ovy * t;
      pz = oz + ovz * t;
      if (ocls != 1.0f) {
        px = px + 0.5f * oax * t * t;
        py = py + 0.5f * oay * t * t;
        pz = pz + 0.5f * oaz * t * t;
      }
    }
    // its cell, floor((pred - lo) / cell_size) clipped into the grid, with
    // an IEEE division as in the cell list's build
    const int cx = clip_cell(floorf((px - q.lo_x) / q.cell_size), sh.nx);
    const int cy = clip_cell(floorf((py - q.lo_y) / q.cell_size), sh.ny);
    const int cz = clip_cell(floorf((pz - q.lo_z) / q.cell_size), sh.nz);

    tc::for_each_run(cell_start, sh, cx, cy, cz, [&](int j0, int j1) {
      for (int j = j0; j < j1; ++j) {
        if (j == i) continue;  // pair identity = sorted index
        const float4 c0 = rec[4 * j];

        // stage 1: candidate's CURRENT position within the search radius
        // of the predicted one (the reference's |p_c - pred| <= r)
        const float qx = c0.x - px, qy = c0.y - py;
        float q2 = qx * qx + qy * qy;
        if (sh.is3d) {
          const float qz = c0.z - pz;
          q2 = q2 + qz * qz;
        }
        if (!(sqrtf(q2) <= q.radius)) continue;

        // candidate advanced to t under constant acceleration
        const float4 c1 = rec[4 * j + 1], c2 = rec[4 * j + 2];
        const float sx = c0.x + c0.w * t + 0.5f * c1.z * t * t - px;
        const float sy = c0.y + c1.x * t + 0.5f * c1.w * t * t - py;
        const float dvx = c0.w - ovx, dvy = c1.x - ovy;
        const float dax = c1.z - oax, day = c1.w - oay;
        float sz = 0.0f, dvz = 0.0f, daz = 0.0f;
        if (sh.is3d) {
          sz = c0.z + c1.y * t + 0.5f * c2.x * t * t - pz;
          dvz = c1.y - ovz;
          daz = c2.x - oaz;
        }
        const float safe = (osize + c2.y) * 0.5f + p.safe_base;

        // first sample of the sub-window sweep within the safe distance
        float t_hit = 0.0f, d_hit = 0.0f;
        bool hit = false;
        for (int s = 0; s < sub_steps; ++s) {
          const float ts = static_cast<float>(s) * p.dt;
          const float tt = ts * ts;
          const float ddx = sx + dvx * ts + 0.5f * dax * tt;
          const float ddy = sy + dvy * ts + 0.5f * day * tt;
          float dd2 = ddx * ddx + ddy * ddy;
          if (sh.is3d) {
            const float ddz = sz + dvz * ts + 0.5f * daz * tt;
            dd2 = dd2 + ddz * ddz;
          }
          const float d = sqrtf(dd2);
          if (d <= safe) {
            hit = true;
            t_hit = ts;
            d_hit = d;
            break;
          }
        }
        if (!hit) continue;

        // stage 4: weighted risk, the slot key
        float rs2 = dvx * dvx + dvy * dvy;
        if (sh.is3d) rs2 = rs2 + dvz * dvz;
        const float chead = c2.z;
        float angle;
        if (sh.angle_product) {
          const float4 c3 = rec[4 * j + 3];
          const float sd = osin * c3.y - ocos * c3.x;
          angle = ohead >= chead ? sd : -sd;
        } else {
          angle = sinf(fabsf(ohead - chead));
        }
        float risk =
            p.w_dist * (1.0f - d_hit / safe) +
            p.w_time * (1.0f - fminf(t_hit / p.max_warning_time, 1.0f)) +
            p.w_speed * fminf(sqrtf(rs2) / p.max_relative_speed, 1.0f) +
            p.w_angle * angle +
            p.w_type * (c2.w == otype ? p.same_type : p.diff_type);
        risk = fminf(fmaxf(risk, 0.0f), 1.0f);
        ++n_emit;
        tc::insert_slot(skey, sidx, sh.k, risk, j);
      }
    });
  }
  for (int s = 0; s < sh.k; ++s) {
    keys[row * sh.k + s] = skey[s];
    idx[row * sh.k + s] = sidx[s];
  }
  emitted_out[row] = n_emit;
}

}  // namespace

extern "C" {

// Launches on `stream` and returns cudaGetLastError() (0 on success).
// fields [n, 16] f32 (cls in the record's field 14), cell_start
// [nx*ny*nz + 1] i32, offsets [n_off] f32 on the device; params: N_PARAMS
// f32 and pred_params: N_PRED_PARAMS f32 on the host; outputs keys
// [n_off, n, k] f32, idx [n_off, n, k] i32, emitted [n_off, n] i32.
int tc_fused_predict(const void* fields, const void* cell_start,
                     const void* offsets, int n_off, int n, int nx, int ny,
                     int nz, int is3d, int k, int sub_steps,
                     int angle_product, const void* params,
                     const void* pred_params, void* keys, void* idx,
                     void* emitted, void* stream) {
  if (k < 1 || k > K_MAX || n_off > 65535 || sub_steps < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n <= 0 || n_off <= 0) return 0;
  Params p;
  const float* pf = static_cast<const float*>(params);
  float* dst = reinterpret_cast<float*>(&p);
  for (int t = 0; t < tc::N_PARAMS; ++t) dst[t] = pf[t];
  PredParams q;
  pf = static_cast<const float*>(pred_params);
  dst = reinterpret_cast<float*>(&q);
  for (int t = 0; t < N_PRED_PARAMS; ++t) dst[t] = pf[t];
  const Shape sh{n, nx, ny, nz, is3d, k, 0, angle_product};
  const int block = 128;
  const dim3 grid((n + block - 1) / block, n_off);
  fused_predict_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(fields), static_cast<const int*>(cell_start),
      static_cast<const float*>(offsets), sh, p, q, sub_steps,
      static_cast<float*>(keys), static_cast<int*>(idx),
      static_cast<int*>(emitted));
  return static_cast<int>(cudaGetLastError());
}

int tc_pred_param_count() { return N_PRED_PARAMS; }

}  // extern "C"
