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
// Design: a 2D grid, blockIdx.y = offset, one WARP per (offset, own row), so
// a whole predict call is one launch and the crowd of a dense cell is
// spread over 32 lanes. The warp walks the exact 3 (2D) or 9 (3D) runs
// around its predicted cell (no window, so nothing overflows) in three
// stages that keep the lanes busy:
//   1. stage 1, 32 consecutive candidates of a run at a time, one per lane
//      (the float4 loads of a warp are consecutive records);
//   2. the lanes that pass append their candidate's index to the warp's ring
//      in shared memory (__ballot_sync and a prefix count of the mask);
//      whenever 32 wait, and once at the end for the rest, the warp runs
//      the set-up and the sweep on one waiting candidate per lane, so the
//      sweep, which is nearly all of the arithmetic, runs on full warps;
//   3. hits are rare: after a sweep round each hit's (risk, index) goes by
//      __shfl_sync to lane 0, which inserts it into the warp's k slots in
//      shared memory. The slots are the k largest under a total order in
//      which every candidate occurs once, so the order of insertion does not
//      matter, and emitted is a count.
// A distance is only ever compared with a threshold until a sample hits, so
// the comparisons run on squared distances against sqrt_le_bound (below),
// which decides exactly as the square root would; only the hit sample takes
// its square root.
// What bounds it on the card: instruction issue and cache lines, not device
// memory. The sweep's loop is 19 instructions per 2D sample without fused
// multiply-adds and runs at about three quarters of the card's issue rate;
// a pair's set-up is about 60 more around three gathered 16-byte loads. A
// warp's 32 stage-1 loads are 16 bytes of every 64-byte record, so one load
// touches 16 cache lines (served by L1 / L2: neighbouring warps are
// neighbours in one cell and walk the same runs), and the ring costs about
// 45 instructions per 32 candidates. 63 registers hold 32 warps on an SM;
// more loads in flight per warp cost registers and lost more than they won.
// Every (offset, row) pays a prologue of three IEEE divisions and six run
// bounds. PERF.md section 6 has the measured split.
//
// Arithmetic follows the reference's expressions (detect/predict.py,
// detect/pipeline.py _dist_at_time / _risk_score) in their order, and the
// plain PyTorch version predict_topk_plain in kernels/fused_detect.py; built
// with -fmad=false and without fast math, the two agree bit for bit.

#include <cfloat>
#include <cmath>

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

constexpr int WARPS = 8;    // warps, one own row each, of a block
constexpr int QUEUE = 64;   // ring of stage-1 survivors: 32 waiting + 32 new
constexpr unsigned FULL = 0xffffffffu;

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

// PRODUCT: the angle term from the records' sines and cosines
// (DetectionConfig.angle_form == "product"), else sinf of the heading
// difference. A compile-time choice so that sinf's large-argument path and
// its stack frame stay out of the product form.
template <bool PRODUCT>
__global__ void __launch_bounds__(WARPS * 32)
fused_predict_kernel(const float4* __restrict__ rec,
                     const int* __restrict__ cell_start,
                     const float* __restrict__ offsets, Shape sh, Params p,
                     PredParams q, int sub_steps, float* __restrict__ keys,
                     int* __restrict__ idx, int* __restrict__ emitted_out) {
  __shared__ int s_queue[WARPS][QUEUE];
  __shared__ float s_key[WARPS][K_MAX];
  __shared__ int s_idx[WARPS][K_MAX];
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  // every branch below that holds a warp-wide primitive is taken by the
  // whole warp: i, the runs and the ring's counters are the same in all lanes
  const int i = blockIdx.x * WARPS + w;
  if (i >= sh.n) return;
  const long long row = static_cast<long long>(blockIdx.y) * sh.n + i;
  const float t = offsets[blockIdx.y];
  int* queue = s_queue[w];
  float* skey = s_key[w];
  int* sidx = s_idx[w];
  if (lane < sh.k) {
    skey[lane] = KEY_NONE;
    sidx[lane] = -1;
  }
  __syncwarp();
  int n_emit = 0;
  // dead objects sort last: rows from cell_start[num_cells] on are dead
  if (i < cell_start[sh.nx * sh.ny * sh.nz]) {
    // the own record, read by every lane (one broadcast load each)
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
    const float radius_sq = sqrt_le_bound(q.radius);

    int head = 0, waiting = 0;  // the ring holds queue[head .. head + waiting)

    // Set-up, sweep and stage 4 of the ring's first m (<= 32) candidates, one
    // per lane, then the hits into the slots.
    auto sweep = [&](int m) {
      const bool active = lane < m;
      const int j = active ? queue[(head + lane) & (QUEUE - 1)] : -1;
      __syncwarp();  // the ring's entries are read before any is overwritten
      head = (head + m) & (QUEUE - 1);
      waiting -= m;
      float risk = 0.0f;
      bool hit = false;
      if (active) {
        // candidate advanced to t under constant acceleration
        const float4 c0 = rec[4 * j], c1 = rec[4 * j + 1],
                     c2 = rec[4 * j + 2];
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
        const float safe_sq = sqrt_le_bound(safe);

        // first sample of the sub-window sweep within the safe distance
        float t_hit = 0.0f, d_hit = 0.0f;
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
          if (dd2 <= safe_sq) {  // sqrtf(dd2) <= safe
            hit = true;
            t_hit = ts;
            d_hit = sqrtf(dd2);
            break;
          }
        }
        if (hit) {
          // stage 4: weighted risk, the slot key
          float rs2 = dvx * dvx + dvy * dvy;
          if (sh.is3d) rs2 = rs2 + dvz * dvz;
          const float chead = c2.z;
          float angle;
          if (PRODUCT) {
            const float4 c3 = rec[4 * j + 3];
            const float sd = osin * c3.y - ocos * c3.x;
            angle = ohead >= chead ? sd : -sd;
          } else {
            angle = sinf(fabsf(ohead - chead));
          }
          risk =
              p.w_dist * (1.0f - d_hit / safe) +
              p.w_time * (1.0f - fminf(t_hit / p.max_warning_time, 1.0f)) +
              p.w_speed * fminf(sqrtf(rs2) / p.max_relative_speed, 1.0f) +
              p.w_angle * angle +
              p.w_type * (c2.w == otype ? p.same_type : p.diff_type);
          risk = fminf(fmaxf(risk, 0.0f), 1.0f);
        }
      }
      unsigned hits = __ballot_sync(FULL, hit);
      n_emit += __popc(hits);
      while (hits) {
        const int src = __ffs(hits) - 1;
        hits &= hits - 1;
        const float r = __shfl_sync(FULL, risk, src);
        const int jr = __shfl_sync(FULL, j, src);
        if (lane == 0) tc::insert_slot(skey, sidx, sh.k, r, jr);
      }
    };

    tc::for_each_run(cell_start, sh, cx, cy, cz, [&](int j0, int j1) {
      for (int base = j0; base < j1; base += 32) {
        const int j = base + lane;
        // stage 1: candidate's CURRENT position within the search radius
        // of the predicted one (the reference's |p_c - pred| <= r)
        bool pass = false;
        if (j < j1 && j != i) {  // pair identity = sorted index
          const float4 c0 = rec[4 * j];
          const float qx = c0.x - px, qy = c0.y - py;
          float q2 = qx * qx + qy * qy;
          if (sh.is3d) {
            const float qz = c0.z - pz;
            q2 = q2 + qz * qz;
          }
          pass = q2 <= radius_sq;  // sqrtf(q2) <= radius
        }
        const unsigned passed = __ballot_sync(FULL, pass);
        if (pass) {
          const int at = waiting + __popc(passed & ((1u << lane) - 1u));
          queue[(head + at) & (QUEUE - 1)] = j;
        }
        waiting += __popc(passed);
        __syncwarp();
        if (waiting >= 32) sweep(32);
      }
    });
    if (waiting > 0) sweep(waiting);
  }
  __syncwarp();  // lane 0's slots, read by the lanes that write them out
  if (lane < sh.k) {
    keys[row * sh.k + lane] = skey[lane];
    idx[row * sh.k + lane] = sidx[lane];
  }
  if (lane == 0) emitted_out[row] = n_emit;
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
  const dim3 grid((n + WARPS - 1) / WARPS, n_off);
  auto kernel = angle_product ? fused_predict_kernel<true>
                              : fused_predict_kernel<false>;
  kernel<<<grid, WARPS * 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(fields), static_cast<const int*>(cell_start),
      static_cast<const float*>(offsets), sh, p, q, sub_steps,
      static_cast<float*>(keys), static_cast<int*>(idx),
      static_cast<int*>(emitted));
  return static_cast<int>(cudaGetLastError());
}

int tc_pred_param_count() { return N_PRED_PARAMS; }

}  // extern "C"
