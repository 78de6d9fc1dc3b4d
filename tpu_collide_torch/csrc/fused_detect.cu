// Fused broad + narrow phase for Hopper (sm_90a): each object's top-k pair
// slots, in the two detection modes of the fused step.
//
// Replaces the TPU kernel tpu_collide/kernels/fused_detect.py::_kernel,
// launched there by fused_topk in modes "hits" (fast) and "survivors"
// (precise). It computes what that kernel computes; the TPU layout (128-lane
// storage rows, tiles, candidate windows, packed slot keys) is not carried
// over.
//
// Design: one thread per own object of the cell-sorted fleet. The thread
// keeps its own record in registers, walks its 3 (2D) or 9 (3D) candidate
// runs from cell_start, skips itself by sorted index, and keeps k <= 16 slots
// as an insertion-sorted list (key descending, candidate index ascending).
// A candidate costs one 16-byte load until it passes stage 1; the other
// three loads of its 64-byte record follow only then. checked is summed per
// warp and added once per warp into a 64-bit total.
//
// What bounds it on the card: candidate loads, served mostly from L2 (the
// threads of a warp are neighbours in one cell and walk nearly the same
// runs), and thread imbalance in dense cells, where one warp waits for its
// most crowded object. Making it fast is later work: cooperative tiling of a
// cell's candidates in shared memory, or a warp per object for dense cells.
//
// Arithmetic follows the kernel's order (fused_detect.py:651-784) and the
// plain PyTorch version in tpu_collide_torch/kernels/fused_detect.py; built
// with -fmad=false and without fast math, the two agree bit for bit.

#include "fused_common.cuh"

namespace {

using tc::K_MAX;
using tc::KEY_NONE;
using tc::KEY_SUB;
using tc::N_PARAMS;
using tc::Params;
using tc::Shape;

template <bool HITS>
__global__ void __launch_bounds__(128)
fused_topk_kernel(const float4* __restrict__ rec,
                  const int* __restrict__ cell,
                  const int* __restrict__ cell_start, Shape sh, Params p,
                  float* __restrict__ keys, int* __restrict__ idx,
                  int* __restrict__ emitted_out, int* __restrict__ qual_out,
                  unsigned long long* __restrict__ checked) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const int num_cells = sh.nx * sh.ny * sh.nz;
  unsigned int n_checked = 0;

  if (i < sh.n) {
    float skey[K_MAX];
    int sidx[K_MAX];
    for (int s = 0; s < sh.k; ++s) {
      skey[s] = KEY_NONE;
      sidx[s] = -1;
    }
    int n_emit = 0, n_qual = 0;
    const int c = cell[i];
    if (c < num_cells) {
      const float4 o0 = rec[4 * i], o1 = rec[4 * i + 1], o2 = rec[4 * i + 2],
                   o3 = rec[4 * i + 3];
      const float ox = o0.x, oy = o0.y, oz = o0.z;
      const float ovx = o0.w, ovy = o1.x, ovz = o1.y;
      const float oax = o1.z, oay = o1.w, oaz = o2.x;
      const float osize = o2.y, ohead = o2.z, otype = o2.w;
      const float osin = o3.x, ocos = o3.y;
      const int cx = c % sh.nx;
      const int cy = (c / sh.nx) % sh.ny;
      const int cz = c / (sh.nx * sh.ny);

      tc::for_each_run(cell_start, sh, cx, cy, cz, [&](int j0, int j1) {
        for (int j = j0; j < j1; ++j) {
          if (j == i) continue;  // pair identity = sorted index
          const float4 c0 = rec[4 * j];

          // stage 1: within search radius
          const float dxp = c0.x - ox, dyp = c0.y - oy;
          float d2 = dxp * dxp + dyp * dyp;
          float dzp = 0.0f;
          if (sh.is3d) {
            dzp = c0.z - oz;
            d2 = d2 + dzp * dzp;
          }
          if (!(d2 <= p.r2)) continue;
          ++n_checked;

          // stage 2: closest approach under constant acceleration
          const float4 c1 = rec[4 * j + 1], c2 = rec[4 * j + 2];
          const float dvx = c0.w - ovx, dvy = c1.x - ovy;
          float rs2 = dvx * dvx + dvy * dvy;
          float dot = dxp * dvx + dyp * dvy;
          float dvz = 0.0f;
          if (sh.is3d) {
            dvz = c1.y - ovz;
            rs2 = rs2 + dvz * dvz;
            dot = dot + dzp * dvz;
          }
          const float rs2s = rs2 > 1e-12f ? rs2 : 1.0f;
          const float ts = -(p.conv * dot) / rs2s;
          const float dax = c1.z - oax, day = c1.w - oay;
          const float cdx = dxp + dvx * ts + 0.5f * dax * ts * ts;
          const float cdy = dyp + dvy * ts + 0.5f * day * ts * ts;
          float cd2 = cdx * cdx + cdy * cdy;
          if (sh.is3d) {
            const float daz = c2.x - oaz;
            const float cdz = dzp + dvz * ts + 0.5f * daz * ts * ts;
            cd2 = cd2 + cdz * cdz;
          }
          const float safe = (osize + c2.y) * 0.5f + p.safe_base;
          const float safe2 = safe * safe;
          if (!((rs2 >= p.min_rs2) && (ts >= 0.0f) &&
                (ts <= p.time_window) && (cd2 <= safe2)))
            continue;

          float key;
          bool qual;
          if (HITS) {
            // stage 3 (fast): first crossing of |p + v t| = safe, snapped
            // up to the dt lattice
            const float bq = 2.0f * dot;
            const float cq = d2 - safe2;
            const float disc = bq * bq - 4.0f * rs2 * cq;
            const float sq = sqrtf(fmaxf(disc, 0.0f));
            const float t_en = (-bq - sq) / (2.0f * rs2s);
            const float t_ex = (-bq + sq) / (2.0f * rs2s);
            const bool inside = cq <= 0.0f;
            const float t_fi = inside ? 0.0f : fmaxf(t_en, 0.0f);
            const float t_sn = ceilf(t_fi / p.dt - 1e-6f) * p.dt;
            const bool sok =
                inside || ((t_sn >= t_en - 1e-6f) && (t_sn <= t_ex + 1e-6f));
            if (!((disc >= 0.0f) && (rs2 > 1e-12f) && sok &&
                  (t_sn <= p.t_max)))
              continue;
            const float t_hit = inside ? 0.0f : t_sn;
            const float hdx = dxp + dvx * t_hit;
            const float hdy = dyp + dvy * t_hit;
            float hd2 = hdx * hdx + hdy * hdy;
            if (sh.is3d) {
              const float hdz = dzp + dvz * t_hit;
              hd2 = hd2 + hdz * hdz;
            }
            const float d_hit = sqrtf(hd2);

            // stage 4: weighted risk
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

            // priority and the scene ranking key
            const bool crit = (risk >= p.risk_high) && (t_hit < p.ttc_critical);
            const bool high = (risk >= p.risk_high) || (t_hit < p.ttc_high);
            const bool med = risk >= p.risk_medium;
            const float prio = crit ? 3.0f : (high ? 2.0f : (med ? 1.0f : 0.0f));
            qual = risk >= p.risk_low;
            key = qual ? 2.0f * prio + risk : risk + KEY_SUB;
          } else {
            // stage-2 survivor, ranked by closest-approach proximity
            qual = true;
            key = 1.0f - cd2 / safe2;
          }
          ++n_emit;
          if (qual) ++n_qual;

          tc::insert_slot(skey, sidx, sh.k, key, j);
        }
      });
    }
    for (int s = 0; s < sh.k; ++s) {
      keys[(long long)i * sh.k + s] = skey[s];
      idx[(long long)i * sh.k + s] = sidx[s];
    }
    emitted_out[i] = n_emit;
    qual_out[i] = n_qual;
  }

  if (sh.count_checked) {
    // every thread of the block reaches here, so the full mask is exact
    const unsigned int w = __reduce_add_sync(0xffffffffu, n_checked);
    if ((threadIdx.x & 31) == 0 && w != 0)
      atomicAdd(checked, static_cast<unsigned long long>(w));
  }
}

}  // namespace

extern "C" {

// Launches on `stream` and returns cudaGetLastError() (0 on success).
// fields [n, 16] f32, cell [n] i32, cell_start [nx*ny*nz + 1] i32,
// params: N_PARAMS f32 on the host; outputs keys [n, k] f32, idx [n, k] i32,
// emitted [n] i32, qual [n] i32, checked [] i64 (zeroed by the caller; left
// alone when count_checked is 0).
int tc_fused_topk(const void* fields, const void* cell,
                  const void* cell_start, int n, int nx, int ny, int nz,
                  int is3d, int k, int hits, int count_checked,
                  int angle_product, const void* params, void* keys,
                  void* idx, void* emitted, void* qual, void* checked,
                  void* stream) {
  if (k < 1 || k > K_MAX) return static_cast<int>(cudaErrorInvalidValue);
  if (n <= 0) return 0;
  Params p;
  const float* pf = static_cast<const float*>(params);
  float* dst = reinterpret_cast<float*>(&p);
  for (int t = 0; t < N_PARAMS; ++t) dst[t] = pf[t];
  const Shape sh{n, nx, ny, nz, is3d, k, count_checked, angle_product};
  const int block = 128;
  const int grid = (n + block - 1) / block;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto* rec = static_cast<const float4*>(fields);
  auto* cl = static_cast<const int*>(cell);
  auto* cs = static_cast<const int*>(cell_start);
  auto* ko = static_cast<float*>(keys);
  auto* io = static_cast<int*>(idx);
  auto* eo = static_cast<int*>(emitted);
  auto* qo = static_cast<int*>(qual);
  auto* co = static_cast<unsigned long long*>(checked);
  if (hits)
    fused_topk_kernel<true><<<grid, block, 0, s>>>(rec, cl, cs, sh, p, ko, io,
                                                   eo, qo, co);
  else
    fused_topk_kernel<false><<<grid, block, 0, s>>>(rec, cl, cs, sh, p, ko,
                                                    io, eo, qo, co);
  return static_cast<int>(cudaGetLastError());
}

int tc_param_count() { return N_PARAMS; }

const char* tc_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
